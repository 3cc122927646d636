"""Formula front-end: R-style model strings + DataFrame -> ModelSpec.

A copy of `nextgp_tpu/api/formula.py` (`parse_formula`, `build_lv_design`
and their helpers) over the port's readers (data/ingest.py), pedigree
builders (data/pedigree.py) and GRM (data/grm.py), with one port-only
argument: `device`, where a GBLUP term's G^-1 is computed (torch float64
on the card unless device="cpu", as data/grm.py does). It replaces the
reference's StatsModels `@formula` surface
(NextGP.jl `src/prepMatVec.jl:39-176`). Supported grammar:

    "y ~ 1 + x + farm + (1|herd) + PED(ID) + SNP(geno) + a:b"

Coercion rules follow `prep` exactly:
  * Int columns are treated as categorical        (prepMatVec.jl:47-51)
  * String/categorical columns are dummy-coded (first level dropped)
    unless `hints[name] == "full_dummy"`          (prepMatVec.jl:54-60)
  * Float covariates are mean-centered, response excluded
                                                  (prepMatVec.jl:64-70)
  * PED(v): pedigree random effect with A^-1; phenotype rows are re-sorted
    to pedigree order first                       (prepMatVec.jl:81-100,136-142)
  * SNP(name): marker set; if the prior for `name` is a RandomEffect with
    str "G", the GBLUP path builds G^-1 and an identity incidence
                                                  (prepMatVec.jl:123-127)
  * (1|v): iid random intercept per level of v    (prepMatVec.jl:143-156)

`data` may be a pandas DataFrame or a dict of equal-length arrays.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import numpy as np

from ..data.grm import make_g_inverse
from ..data.ingest import MarkerData, from_array, read_genotype_file, read_map_file
from ..data.pedigree import Pedigree, a_inverse, incidence_matrix, read_pedigree
from .priors import RandomEffect, is_marker_prior
from .spec import FixedTerm, MarkerTerm, ModelSpec, RandomTerm


class _Frame:
    """Minimal column accessor over DataFrame/dict."""

    def __init__(self, data):
        if hasattr(data, "columns"):
            self.cols = {c: np.asarray(data[c]) for c in data.columns}
        else:
            self.cols = {k: np.asarray(v) for k, v in data.items()}
        ns = {len(v) for v in self.cols.values()}
        if len(ns) != 1:
            raise ValueError("all columns must have equal length")
        self.n = ns.pop()

    def __getitem__(self, k):
        if k not in self.cols:
            raise KeyError(f"column {k!r} not in data")
        return self.cols[k]

    def __contains__(self, k):
        return k in self.cols

    def reorder(self, idx):
        self.cols = {k: v[idx] for k, v in self.cols.items()}


def _split_terms(rhs: str):
    """Split on '+' at depth 0 (parentheses of (1|x), SNP(...), PED(...))."""
    terms, depth, cur = [], 0, ""
    for ch in rhs:
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        if ch == "+" and depth == 0:
            terms.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        terms.append(cur.strip())
    return terms


def _is_int_like(col: np.ndarray) -> bool:
    return col.dtype.kind in "iu"


def _is_float_like(col: np.ndarray) -> bool:
    return col.dtype.kind == "f"


def _code_categorical(col, name, hints):
    levels = sorted(set(col.tolist()))
    full = hints.get(name) == "full_dummy"
    use = levels if full else levels[1:]  # DummyCoding drops first level
    x = np.stack([(col == lv).astype(np.float64) for lv in use], axis=1)
    labels = [f"{name}: {lv}" for lv in use]
    return x, labels


def parse_formula(
    formula: str,
    data,
    priors: Optional[Dict[Any, Any]] = None,
    hints: Optional[Dict[str, str]] = None,
    path2ped: Optional[str] = None,
    blocks: Optional[Sequence[Tuple[str, ...]]] = None,
    summary_stats: Optional[Dict[Any, Any]] = None,
    block_size: int = 256,
    genotypes: Optional[Dict[str, Any]] = None,
    device=None,
) -> ModelSpec:
    """Compile a formula + data to a ModelSpec.

    priors: dict keyed by term name (marker set, random effect, or "e").
    genotypes: dict name -> (matrix | file path | MarkerData) for SNP(name)
               terms whose argument is a bare name.
    device: where a GBLUP term's G^-1 is built (the card unless "cpu").
    """
    priors = dict(priors or {})
    hints = dict(hints or {})
    genotypes = genotypes or {}
    fr = _Frame(data)

    m = re.match(r"\s*([\w.]+)\s*~\s*(.+)$", formula, re.S)
    if not m:
        raise ValueError(f"cannot parse formula {formula!r}")
    lhs, rhs = m.group(1), m.group(2)
    raw_terms = _split_terms(rhs)

    # pedigree: order phenotypes to pedigree order (prepMatVec.jl:88-99)
    ped: Optional[Pedigree] = None
    row_order: Optional[np.ndarray] = None
    if path2ped:
        ped = read_pedigree(path2ped) if isinstance(path2ped, str) else path2ped
        ids = [str(v) for v in fr["ID"]]
        ped_ids = [str(v) for v in ped.ids]
        if not set(ids) <= set(ped_ids):
            raise ValueError("phenotyped individuals are not a subset of pedigree")  # misc.jl:106
        pos = {v: i for i, v in enumerate(ped_ids)}
        row_order = np.argsort([pos[v] for v in ids], kind="stable")
        fr.reorder(row_order)

    _ainv_cache = []

    def _ainv():
        # dense A^-1, built lazily: cg-sampled PED terms never need it
        if not _ainv_cache:
            _ainv_cache.append(a_inverse(ped))
        return _ainv_cache[0]

    y = np.asarray(fr[lhs], dtype=np.float64)

    # float covariates centered except response (prepMatVec.jl:64-70)
    centered: Dict[str, np.ndarray] = {}
    for name, col in fr.cols.items():
        if name != lhs and _is_float_like(col):
            centered[name] = col - col.mean()

    fixed, random, markers = [], [], []

    for t in raw_terms:
        t = t.strip()
        if t == "1":
            fixed.append(FixedTerm("intercept", np.ones(fr.n), ["intercept"]))
            continue
        msnp = re.match(r"SNP\(\s*([\w.\"']+)\s*(?:,\s*([^,)]+)\s*)?(?:,\s*map\s*=\s*([^)]+)\s*)?\)$", t)
        if msnp:
            name = msnp.group(1).strip("\"'")
            src = msnp.group(2)
            mapf = msnp.group(3)
            if src is not None and mapf is None and "=" in src:
                # SNP(name, map=...) with genotypes supplied via the dict:
                # the optional src group would greedily swallow the map=
                # argument and the map would be silently dropped. Only a
                # bare-identifier prefix counts as a keyword — a positional
                # path like data/run=2/geno.txt must keep parsing as a path.
                key, _, val = src.partition("=")
                if key.strip() == "map":
                    src, mapf = None, val
                elif re.fullmatch(r"\w+", key.strip()):
                    raise ValueError(
                        f"unrecognized SNP(...) keyword argument {key.strip()!r}")
            md = _resolve_markers(name, src, mapf, genotypes)
            if row_order is not None:
                if getattr(md, "packed", False):
                    raise ValueError(
                        f"marker set {name}: genotypes arrived 2-bit packed, "
                        "which cannot be row-reordered to pedigree order — "
                        "supply phenotypes already in pedigree order, or "
                        "pass the unpacked panel"
                    )
                # deviation from the reference, which reads genotype rows
                # as-is after re-sorting phenotypes (prepMatVec.jl:88-99,116)
                # and thus silently misaligns unless the file is already in
                # pedigree order: genotype rows follow the data permutation.
                import dataclasses as _dc

                md = _dc.replace(md, genotypes=md.genotypes[row_order])
            prior = priors.get(name)
            if isinstance(prior, RandomEffect) and str(prior.str_) == "G":
                # GBLUP path (prepMatVec.jl:123-127)
                if getattr(md, "packed", False):
                    raise ValueError(
                        f"marker set {name}: the GBLUP branch needs the "
                        "unpacked dosage panel to build G (use from_array)")
                ginv = make_g_inverse(md.genotypes, method=prior.type, device=device)
                random.append(
                    RandomTerm(
                        name,
                        np.eye(fr.n),
                        prior=prior,
                        ivstr=ginv,
                        levels=[f"Ind{i + 1}" for i in range(fr.n)],
                        structure_label="G",
                    )
                )
            else:
                if prior is not None and not is_marker_prior(prior):
                    raise ValueError(f"prior for marker set {name} must be a Bayes* prior")
                markers.append(MarkerTerm(name, md, prior))
            continue
        mped = re.match(r"PED\(\s*([\w.\"']+)\s*\)$", t)
        if mped:
            var = mped.group(1).strip("\"'")
            if ped is None:
                raise ValueError("PED(...) requires path2ped")
            prior = priors.get(var, RandomEffect("A", 100.0))
            if getattr(prior, "sampler", "scan") == "cg":
                # scalable path: index incidence + sparse A^-1 + Henderson
                # factor; no dense arrays (engine samples u by perturbed CG)
                from ..data.pedigree import a_inverse_factor, a_inverse_padded

                iv_idx, iv_val = a_inverse_padded(ped)
                sire_f, dam_f, dsq = a_inverse_factor(ped)
                z_idx = ped.index_of([str(v) for v in fr[var]])
                random.append(
                    RandomTerm(
                        var, None, prior=prior,
                        levels=[str(v) for v in ped.ids],
                        structure_label="A",
                        z_idx=z_idx, n_levels=ped.n,
                        sparse_struct={
                            "iv_idx": iv_idx, "iv_val": iv_val,
                            "sire": sire_f, "dam": dam_f, "dinv_sqrt": dsq,
                        },
                    )
                )
                continue
            levels, z = incidence_matrix(
                np.asarray([str(v) for v in fr[var]]), np.asarray([str(v) for v in ped.ids])
            )
            random.append(
                RandomTerm(var, z, prior=prior, ivstr=_ainv(), levels=levels, structure_label="A")
            )
            continue
        mre = re.match(r"\(\s*1\s*\|\s*([\w.]+)\s*\)$", t)
        if mre:
            var = mre.group(1)
            levels, z = incidence_matrix(fr[var])
            # the reference keys iid terms as :(1|x); a bare `var` key is
            # honored only when no PED(var) term claims it
            prior = priors.get(f"1|{var}")
            if prior is None and not any(
                t.name == var and t.structure_label == "A" for t in random
            ):
                prior = priors.get(var)
            # setVarCovStr! semantics (mme.jl:26-46): "I" -> identity,
            # "A" -> pedigree A^-1, user matrix -> its inverse
            ivstr = None
            label = "I"
            if prior is not None and isinstance(prior, RandomEffect):
                s = prior.str_
                if isinstance(s, str) and s == "A":
                    if ped is None:
                        raise ValueError(f"prior for {var} uses 'A' but no path2ped given")
                    levels, z = incidence_matrix(
                        np.asarray([str(v) for v in fr[var]]),
                        np.asarray([str(v) for v in ped.ids]),
                    )
                    ivstr, label = _ainv(), "A"
                elif not isinstance(s, str) and np.ndim(s) == 2:
                    ivstr, label = np.linalg.inv(np.asarray(s, dtype=np.float64)), "user"
            random.append(
                RandomTerm(var, z, prior=prior, ivstr=ivstr, levels=levels, structure_label=label)
            )
            continue
        if ":" in t:  # simple interaction of two coded terms
            a, b = (s.strip() for s in t.split(":", 1))
            xa, la = _fixed_design(fr, a, centered, hints)
            xb, lb = _fixed_design(fr, b, centered, hints)
            cols, labels = [], []
            for i in range(xa.shape[1]):
                for j in range(xb.shape[1]):
                    cols.append(xa[:, i] * xb[:, j])
                    labels.append(f"{la[i]} & {lb[j]}")
            fixed.append(FixedTerm(t, np.stack(cols, 1), labels))
            continue
        x, labels = _fixed_design(fr, t, centered, hints)
        fixed.append(FixedTerm(t, x, labels))

    # correlated random-effect groups: tuple prior keys (mme.jl:207-239),
    # e.g. priors={("ID", "Dam"): Random("A", v_2x2)} merges the two random
    # terms into one group with a shared structure and matrix-valued prior
    for key, prior in list(priors.items()):
        if not (isinstance(key, tuple) and isinstance(prior, RandomEffect)):
            continue
        # members ordered by the priors tuple key (the prior covariance rows
        # are keyed to it), not by formula appearance
        by_name = {t.name: t for t in random}
        missing = [k for k in key if k not in by_name]
        if missing:
            raise ValueError(f"correlated prior {key}: unknown random terms {missing}")
        members = [by_name[k] for k in key]
        if any(m.z is None for m in members):
            raise ValueError(
                f"correlated prior {key}: sampler='cg' members cannot join a "
                "correlated group (dense per-level sampler required)"
            )
        if len({m.z.shape for m in members}) != 1:
            raise ValueError(f"correlated prior {key}: effects must share levels")
        ivstrs = [m.ivstr for m in members if m.ivstr is not None]
        merged = RandomTerm(
            name=tuple(m.name for m in members),
            z=tuple(m.z for m in members),
            prior=prior,
            ivstr=ivstrs[0] if ivstrs else None,
            levels=members[0].levels,
            structure_label=members[0].structure_label,
        )
        random = [t for t in random if t.name not in key] + [merged]

    return ModelSpec(
        y=y,
        fixed=fixed,
        blocks=[tuple(b) for b in (blocks or [])],
        random=random,
        markers=markers,
        residual=priors.get("e"),
        summary_stats=dict(summary_stats or {}),
        block_size=block_size,
    )


def build_lv_design(rhs: str, table, hints: Optional[Dict[str, str]] = None):
    """Variance-model design for BayesLV from an RHS formula string + table
    (parity with `modelmatrix(f, covariates)`, mme.jl:426; constructor
    runTime.jl:133). Columns enter raw (no centering); "1" adds an
    intercept; string/int columns are dummy-coded (first level dropped,
    `full_dummy` hint honored). Returns (C, labels) with C (nrow, k)."""
    fr = _Frame(table)
    hints = dict(hints or {})
    cols, labels = [], []
    for t in _split_terms(rhs.strip()):
        t = t.strip()
        if t == "1":
            cols.append(np.ones((fr.n, 1)))
            labels.append("intercept")
            continue
        col = fr[t]
        if _is_float_like(col):
            cols.append(np.asarray(col, np.float64)[:, None])
            labels.append(t)
        else:
            x, lab = _code_categorical(col, t, hints)
            cols.append(x)
            labels.extend(lab)
    if not cols:
        raise ValueError(f"empty variance-model formula {rhs!r}")
    return np.concatenate(cols, axis=1), labels


def _fixed_design(fr, name, centered, hints):
    col = fr[name]
    if _is_float_like(col):
        return centered.get(name, col)[:, None], [name]
    return _code_categorical(col, name, hints)  # Int -> categorical (prepMatVec.jl:47-51)


def _resolve_markers(name, src, mapf, genotypes) -> MarkerData:
    src_obj = genotypes.get(name, src)
    if isinstance(src_obj, MarkerData):
        md = src_obj
    elif isinstance(src_obj, str):
        md = read_genotype_file(src_obj.strip("\"'"))
    elif src_obj is None:
        raise ValueError(f"no genotype source for SNP({name}); pass genotypes={{'{name}': ...}}")
    else:
        md = from_array(np.asarray(src_obj))
    if mapf:
        snp_ids, chr_ids = read_map_file(mapf.strip("\"'"))
        if len(chr_ids) != md.n_snp:
            raise ValueError("map file length != nSNP")
        md.chr_ids = chr_ids
        md.snp_ids = snp_ids
    return md
