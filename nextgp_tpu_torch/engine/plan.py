"""Planner: ModelSpec -> (static SweepPlan, ModelState on the device).

Counterpart of `nextgp_tpu/engine/plan.py:assemble` for the terms the port
carries: the residual ("I", or weighted "D" from a weight vector),
fixed-effect blocks, random effects (a dense incidence and inverse
structure for the per-level scan; a level index, padded sparse A^-1 rows
and the Henderson factor for the CG sampler; stacked incidences and
per-level cross-products for a correlated group), marker sets of all
seven methods (BayesPR, BayesB,
BayesC, BayesR, BayesRCpi, BayesRCplus, BayesLV with a covariate matrix)
stored 2-bit planar-packed in the (T, V, B, q) layout of engine/state.py,
correlated marker sets (BayesPR, one packed row per locus and set),
and summary-statistic offsets on single fixed columns and marker sets.
Defaults follow the JAX package (and NextGP.jl's mme.jl): residual df 4 and
scale v*(df-2)/df with the 0.0005 zero-variance guard; marker df 3 + dim(v) and a matrix v's scale v * (df - nT - 1); a
marker set without a prior is BayesPR(9999, 0.05); multi-column fixed
blocks get the ridge jitter I * min|diag| / 10000. A weighted residual
(d_inv = 1/weights) weights X'X, the Gram blocks and their diagonal mpm,
and keeps the unweighted Gram beside the weighted one, and weights Z'
and diag(Z'Z) of an uncorrelated random term (correlated groups and
correlated marker sets ignore the weights, as the JAX package does). A
missing random prior is Random("I", 100) (mme.jl:40-44), with df 3 + 1.
Any other term raises NotImplementedError naming it.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..api import priors as P
from ..api.spec import CorrMarkerTerm, MarkerTerm, ModelSpec, RandomTerm
from ..data.regions import build_regions
from ..ops import cg, pack2
from ..utils import cdiv, default_device, default_dtype, full_f32
from .state import (
    CorrMarkerState, CorrRandomState, FixedState, MarkerState, ModelState, RandomState,
    ResidualState, SparseRandomState,
)

METHOD_PR = "BayesPR"
METHOD_B = "BayesB"
METHOD_C = "BayesC"
METHOD_R = "BayesR"
METHOD_RCPI = "BayesRCpi"
METHOD_RCPLUS = "BayesRCplus"
METHOD_LV = "BayesLV"


@dataclasses.dataclass(frozen=True)
class FixedPlan:
    name: Union[str, Tuple[str, ...]]
    k: int
    single: bool  # single-column path (functions.jl:41-47)


@dataclasses.dataclass(frozen=True)
class RandomPlan:
    name: Union[str, Tuple[str, ...]]
    q: int
    df: float
    correlated: bool
    n_t: int
    sampler: str = "scan"  # "scan" (the reference's per-level Gibbs) | "cg"
    cg_tol: float = 1e-8
    cg_iters: int = 1000
    # the CG sampler's segment sums without float atomics or a host sync
    # (static tables, padded with the index of a zero appended to the summed
    # vector): the records of each level (q, most records of a level), and
    # the children of each individual as sire and as dam (q, most children)
    z_rows: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    sire_kids: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    dam_kids: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    # the CG solve's matvec (ops/cg.cg_solve_sparse): the live length of
    # each padded inverse-structure row (q,) int32, and diag(Z'D^-1 Z) (q,)
    # in the plan's dtype, which the one-hot Z makes the whole of Z'D^-1 Z
    iv_len: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    z_diag: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    # CG1's blocks on a CUDA device (ops/cg.plan_layout): their row cuts, their
    # first chunk slots and the slots in all; None on the CPU
    cg_layout: Optional[tuple] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class MarkerPlan:
    name: str
    method: str
    p: int
    p_pad: int
    block: int
    n_blocks: int
    n_var: int  # len(var_beta)
    n_regions: int  # BayesPR region count (== n_var)
    n_classes: int  # 0 for BayesPR/LV, 2 for B/C, K for R/RCpi/RCplus
    est_pi: bool
    df: float
    weighted: bool
    # V block chains advance per block-step; chain v owns the contiguous
    # blocks [v*T, (v+1)*T). V=1 is the reference-sequential order.
    vshards: int = 1
    n_annot: int = 0  # annotations A (BayesRCpi/RCplus)
    n_lv_cov: int = 0  # columns of BayesLV's variance-model design
    est_var_zeta: Union[bool, float] = False  # BayesLV: False | True | float
    packed: bool = True  # mt is 2-bit planar-packed uint8 (T, V, B, q): the port's only storage
    # BayesPR's region sums without float atomics or a host sync: (n_regions,
    # longest region) indices of each region's loci, padded with p, and each
    # region's size (constant)
    region_rows: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    region_len: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class CorrMarkerPlan:
    names: Tuple[str, ...]
    n_t: int
    p: int
    p_pad: int
    block: int
    n_blocks: int
    n_regions: int
    df: float
    # V block chains advance per block-step, as for MarkerPlan.vshards
    vshards: int = 1
    # the region sums without float atomics or a host sync, as for
    # MarkerPlan: (n_regions, longest region) locus indices padded with p,
    # and each region's size
    region_rows: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    region_len: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    n: int
    e_df: float
    weighted: bool
    fixed: Tuple[FixedPlan, ...]
    random: Tuple[RandomPlan, ...]
    markers: Tuple[MarkerPlan, ...]
    dtype: torch.dtype
    device: torch.device
    corr_markers: Tuple[CorrMarkerPlan, ...] = ()


def _ss_offsets(k, ss):
    """Summary-statistic lhs/rhs offsets 1/v and m/v (mme.jl:144-147)."""
    lhs = np.zeros(k)
    rhs = np.zeros(k)
    if ss is not None:
        v = np.asarray(ss.v, dtype=np.float64)
        m = np.asarray(ss.m, dtype=np.float64)
        v = np.diag(v) if v.ndim == 2 else np.broadcast_to(v, (k,))
        m = np.broadcast_to(m, (k,))
        with np.errstate(divide="ignore", invalid="ignore"):
            lhs = 1.0 / v
            rhs = lhs * m
    return lhs, rhs


def _marker_ss_offsets(k, ss):
    """Marker variant with the Inf/NaN guards for v == 0 (mme.jl:319-321)."""
    lhs, rhs = _ss_offsets(k, ss)
    lhs[np.isinf(lhs)] = 0.0
    rhs[np.isnan(rhs)] = 0.0
    return lhs, rhs


def _build_fixed(term_mats, name, d_inv, ss, dtype, device):
    """Cross-products + jitter for one fixed block (mme.jl:132-153)."""
    x = np.concatenate(list(term_mats), axis=1)
    k = x.shape[1]
    xp = (x * d_inv[:, None]).T if d_inv is not None else x.T
    xpx = xp @ x
    lhs, rhs = _ss_offsets(k, ss)
    if k > 1:  # the reference jitters only a Matrix xpx (mme.jl:149-152)
        xpx = xpx + np.eye(k) * np.min(np.abs(np.diag(xpx))) / 10000.0

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    st = FixedState(x=dev(x), xp=dev(np.ascontiguousarray(xp)), xpx=dev(xpx),
                    lhs_ss=dev(lhs), rhs_ss=dev(rhs), b=dev(np.zeros(k)))
    return st, FixedPlan(name=name, k=k, single=(k == 1))


def _df_for(v):
    """3 + dim(v) (mme.jl:264-272)."""
    v = np.asarray(v, dtype=np.float64)
    return 3.0 + (v.shape[0] if v.ndim == 2 else 1.0)


def _segments(idx, n_seg, pad, device):
    """(n_seg, longest segment) int64: row s holds the positions k with
    idx[k] == s in ascending order, padded with `pad` (the index of a zero
    appended to the summed vector); negative idx belong to no segment."""
    idx = np.asarray(idx, np.int64)
    pos = np.flatnonzero(idx >= 0)
    seg = idx[pos]
    sizes = np.bincount(seg, minlength=n_seg)
    rows = np.full((n_seg, max(int(sizes.max()) if sizes.size else 0, 1)), pad, np.int64)
    order = np.argsort(seg, kind="stable")
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    col = np.arange(order.size) - np.repeat(starts, sizes)
    rows[seg[order], col] = pos[order]
    return torch.as_tensor(rows, device=device)


def _as_device(a, dtype, device):
    """An array or a tensor (e.g. make_g_inverse's, already on the card) as
    a `dtype` tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)


def _live_lengths(iv_idx, iv_val):
    """(q,) int32: one past the last entry of each padded row that is not
    the padding (idx 0, val 0); 0 for a row of padding alone."""
    live = (np.asarray(iv_idx) != 0) | (np.asarray(iv_val) != 0.0)
    k = live.shape[1]
    return np.where(live.any(axis=1), k - np.argmax(live[:, ::-1], axis=1), 0).astype(np.int32)


def _level_weights(z_idx, q, d_inv):
    """(q,) float64 diag(Z'D^-1 Z) of a one-hot Z: each level's records
    counted, or their d_inv summed in record order."""
    w = np.ones(z_idx.size) if d_inv is None else np.asarray(d_inv, np.float64)
    out = np.zeros(q)
    hit = z_idx >= 0
    np.add.at(out, z_idx[hit], w[hit])  # unbuffered: in record order
    return out


def _build_random_sparse(term: RandomTerm, prior, d_inv, dtype, device):
    """A random effect for the CG sampler (prior.sampler == 'cg'): a level
    index per record, the padded-sparse inverse structure and the Henderson
    factor; no dense (n, q) or (q, q) array. Identity structure unless
    term.sparse_struct gives one (data/pedigree.py: a_inverse_padded,
    a_inverse_factor). The plan adds each row's live length and
    diag(Z'D^-1 Z) for the CG solve, and on a CUDA device CG1's layout of
    its blocks for the card's grid."""
    if term.z_idx is not None:
        z_idx = np.asarray(term.z_idx, np.int64)
        q = int(term.n_levels if term.n_levels is not None else z_idx.max() + 1)
    else:  # the level index of a one-hot incidence
        z = np.asarray(term.z, np.float64)
        q = z.shape[1]
        hot = z != 0.0
        if not (hot.sum(axis=1) <= 1).all() or not ((z == 0) | (z == 1)).all():
            raise ValueError(
                f"random term {term.name}: sampler='cg' needs a 0/1 incidence "
                "(at most one level per row) or an explicit z_idx"
            )
        z_idx = np.where(hot.any(axis=1), hot.argmax(axis=1), -1)

    ss = term.sparse_struct
    if ss is None:  # identity structure
        ss = {
            "iv_idx": np.arange(q, dtype=np.int32)[:, None],
            "iv_val": np.ones((q, 1)),
            "sire": np.full(q, -1, np.int32),
            "dam": np.full(q, -1, np.int32),
            "dinv_sqrt": np.ones(q),
        }
    df = _df_for(prior.v)

    def dev(a, int_=False):
        if int_:
            return torch.as_tensor(np.asarray(a), dtype=torch.int32, device=device)
        return torch.as_tensor(np.asarray(a, dtype=np.float64), dtype=dtype, device=device)

    st = SparseRandomState(
        z_idx=dev(z_idx, True),
        iv_idx=dev(ss["iv_idx"], True),
        iv_val=dev(ss["iv_val"]),
        fac_sire=dev(ss["sire"], True),
        fac_dam=dev(ss["dam"], True),
        fac_dsqrt=dev(ss["dinv_sqrt"]),
        u=torch.zeros(q, dtype=dtype, device=device),
        var_u=torch.tensor(float(prior.v), dtype=dtype, device=device),
        scale=torch.tensor(_scale_for(prior.v, df), dtype=dtype, device=device),
    )
    iv_len = torch.as_tensor(_live_lengths(ss["iv_idx"], ss["iv_val"]), dtype=torch.int32)
    on_card = torch.device(device).type == "cuda"
    plan = RandomPlan(term.name, q, float(df), False, 1, sampler="cg",
                      z_rows=_segments(z_idx, q, z_idx.size, device),
                      sire_kids=_segments(ss["sire"], q, q, device),
                      dam_kids=_segments(ss["dam"], q, q, device),
                      iv_len=iv_len.to(device),
                      z_diag=dev(_level_weights(z_idx, q, d_inv)),
                      cg_layout=cg.plan_layout(iv_len, dtype, device) if on_card else None)
    return st, plan


def _random_prior(term: RandomTerm):
    """A random term's prior (the default where it names none) and whether
    it is drawn by CG (else by the per-level scan)."""
    prior = term.prior or P.RandomEffect("I", 100.0)
    return prior, getattr(prior, "sampler", "scan") == "cg"


def _build_corr_random(term: RandomTerm, prior, dtype, device):
    """A correlated group (tuple name, mme.jl:207-239): the nT incidences
    stacked (nT, n, q), per-level cross-products zpz (q, nT, nT), the dense
    inverse structure, df 3 + nT and scale v * (df - nT - 1). Built on the
    device in float64, stored in dtype."""
    zs = torch.stack([_as_device(z, torch.float64, device) for z in term.z])  # (nT, n, q)
    n_t, q = zs.shape[0], zs.shape[2]
    # Parity footnote (the JAX planner's): NextGP.jl's tuple sampleU
    # (functions.jl:75-88) computes Yi from the fully restored residual and
    # never removes cross-level likelihood couplings, so its update is an
    # exact Gibbs conditional only when every record hits the same level in
    # all components. The port mirrors the reference and the warning.
    if not all(torch.equal(zs[0] != 0.0, zt != 0.0) for zt in zs[1:]):
        warnings.warn(
            f"correlated random effect {term.name}: components have "
            "different incidence patterns. The reference's tuple sampler "
            "(functions.jl:75-88) omits cross-level likelihood couplings "
            "and is NOT a valid Gibbs sampler in this case — variance "
            "chains typically diverge. Use a shared incidence (same "
            "factor) per component, or separate uncorrelated terms.",
            stacklevel=3,
        )
    df = _df_for(prior.v)
    vmat = np.asarray(prior.v, dtype=np.float64)
    if vmat.ndim != 2 or vmat.shape != (n_t, n_t):
        raise ValueError("correlated random effect needs an nT x nT prior v")
    zpz = torch.einsum("tnl,unl->ltu", zs, zs)
    ivstr = (torch.eye(q, dtype=dtype, device=device) if term.ivstr is None
             else _as_device(term.ivstr, dtype, device))

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    st = CorrRandomState(zs=zs.to(dtype), zpz=zpz.to(dtype), ivstr=ivstr.contiguous(),
                         u=torch.zeros((n_t, q), dtype=dtype, device=device), var_u=dev(vmat),
                         scale=dev(_scale_for(vmat, df)))
    return st, RandomPlan(term.name, q, float(df), True, n_t)


def _build_random(term: RandomTerm, d_inv, dtype, device):
    """One random term (mme.jl:170-239): a correlated group (tuple name)
    takes _build_corr_random; sampler 'cg' the sparse form; else Z, Z'
    (weighted by d_inv), diag(Z'Z) and the dense inverse structure for the
    scan."""
    prior, cg = _random_prior(term)
    if cg and term.correlated:
        raise ValueError("sampler='cg' is not available for correlated groups")
    if term.correlated:
        return _build_corr_random(term, prior, dtype, device)
    if cg:
        return _build_random_sparse(term, prior, d_inv, dtype, device)
    z = _as_device(term.z, torch.float64, device)
    q = z.shape[1]
    df = _df_for(prior.v)
    if d_inv is not None:
        zw = z * torch.as_tensor(d_inv, dtype=torch.float64, device=device)[:, None]
    else:
        zw = z
    ivstr = (torch.eye(q, dtype=dtype, device=device) if term.ivstr is None
             else _as_device(term.ivstr, dtype, device))
    st = RandomState(
        z=z.to(dtype),
        zp=zw.T.contiguous().to(dtype),
        zpz=(zw * z).sum(dim=0).to(dtype),
        ivstr=ivstr.contiguous(),
        u=torch.zeros(q, dtype=dtype, device=device),
        var_u=torch.tensor(float(prior.v), dtype=dtype, device=device),
        scale=torch.tensor(_scale_for(prior.v, df), dtype=dtype, device=device),
    )
    return st, RandomPlan(term.name, q, float(df), False, 1)


def _scale_for(v, df):
    """Prior scale from a variance and df (mme.jl:269-271, 498-505): a
    matrix v gives v * (df - nT - 1)."""
    v = np.asarray(v, dtype=np.float64)
    if v.ndim == 2:
        return v * (df - v.shape[0] - 1.0)
    return float(v) * (df - 2.0) / df


def _method_of(prior, name):
    if prior is None or isinstance(prior, P.BayesPR):
        return METHOD_PR
    for cls, method in ((P.BayesB, METHOD_B), (P.BayesC, METHOD_C), (P.BayesR, METHOD_R),
                        (P.BayesRCpi, METHOD_RCPI), (P.BayesRCplus, METHOD_RCPLUS),
                        (P.BayesLV, METHOD_LV)):
        if isinstance(prior, cls):
            return method
    raise NotImplementedError(
        f"marker set {name}: prior {type(prior).__name__} is not a marker prior")


def _resolve_vshards(vshards, nb, name):
    """The V a marker set runs at: "auto" is 1, the reference-sequential
    order, which is the JAX package's "auto" off its TPU kernel path (no
    rule has been measured on the H100); an integer that does not divide
    the block count falls back to its largest divisor."""
    if vshards == "auto":
        return 1
    vreq = int(vshards)
    vsh = max(v for v in range(1, vreq + 1) if nb % v == 0) if vreq > 1 else 1
    if vreq > 1 and vsh != vreq:
        warnings.warn(
            f"marker set {name}: vshards={vreq} does not divide the block count "
            f"nb={nb}; using the largest divisor V={vsh}.", stacklevel=3)
    return vsh


def _packed_rows(md, name, device):
    """The marker set's (p, q) uint8 packed rows on `device`. Unpacked
    dosages may be an (n, p) int8 array or tensor (packed on `device`)."""
    if md.packed:
        return torch.as_tensor(md.genotypes, device=device)
    if isinstance(md.genotypes, torch.Tensor):
        g = md.genotypes.to(device)
        if not (g.dtype == torch.int8 and g.min().item() >= 0 and g.max().item() <= 3):
            raise NotImplementedError(
                f"marker set {name}: the port stores genotypes 2-bit packed only, which "
                "needs int8 dosages in 0..3")
        return pack2.pack2(g)
    g = np.asarray(md.genotypes)
    if not (g.dtype == np.int8 and g.min() >= 0 and g.max() <= 3):
        raise NotImplementedError(
            f"marker set {name}: the port stores genotypes 2-bit packed only, which "
            "needs int8 dosages in 0..3")
    return torch.as_tensor(pack2.pack2_np(g), device=device)


_GRAM_CHUNK = 16  # blocks unpacked at a time while building the Grams


def _centered_grams(mt_blocks, center_blocks, n, dtype, d_inv=None):
    """Centered Gram blocks (nb, B, B) from packed (nb, B, q) rows: returns
    (weighted (Mc*d_inv) Mc', raw Mc Mc') when d_inv (n,) is given, else
    (Mc Mc', None). TF32 is turned off for the products: it would put ~1e-3
    relative error into every Gram entry and so into every conditional."""
    out = torch.empty(mt_blocks.shape[:2] + (mt_blocks.shape[1],), dtype=dtype,
                      device=mt_blocks.device)
    raw = None if d_inv is None else torch.empty_like(out)
    with full_f32():
        for i in range(0, mt_blocks.shape[0], _GRAM_CHUNK):
            sl = slice(i, i + _GRAM_CHUNK)
            mcb = pack2.unpack2(mt_blocks[sl], dtype)[..., :n] - center_blocks[sl, :, None]
            mct = mcb.transpose(1, 2)
            if d_inv is None:
                out[sl] = torch.bmm(mcb, mct)
            else:
                out[sl] = torch.bmm(mcb * d_inv, mct)
                raw[sl] = torch.bmm(mcb, mct)
    return out, raw


def _region_segments(info, device):
    """(rows, lengths) for the deterministic region sums of BayesPR: row r
    holds region r's loci in locus order, padded with p (the index of a zero
    appended to the summed vector), and each region's size."""
    return (_segments(info.region_id, info.n_regions, info.region_id.size, device),
            torch.as_tensor(info.sizes, dtype=torch.int64, device=device))


def _pad_rows(a, p_pad):
    """(p, ...) -> (p_pad, ...), zero rows on the padded loci."""
    pad = p_pad - a.shape[0]
    return np.concatenate([a, np.zeros((pad,) + a.shape[1:], a.dtype)]) if pad else a


def _lv_design(prior, p, name):
    """BayesLV's (p, kC) variance-model design from a covariate matrix."""
    if isinstance(prior.covariates, str):
        raise NotImplementedError(
            f"marker set {name}: BayesLV covariates given as a formula string need the "
            "formula front end (ROADMAP M12), which is not ported yet; pass the (nSNP, k) "
            "design matrix")
    C = np.asarray(prior.covariates, dtype=np.float64)
    if C.ndim == 1:
        C = C[:, None]
    if C.shape[0] != p:
        raise ValueError("BayesLV covariates must have nSNP rows")
    return C


def _build_marker(term: MarkerTerm, d_inv, ss, block, dtype, device, vshards, rng):
    """rng: the host generator BayesLV's starting c and residuals come from
    (the reference draws them from its global RNG, mme.jl:429-430)."""
    md, prior = term.data, term.prior
    method = _method_of(prior, term.name)
    if prior is not None and np.ndim(prior.v) > 0:
        # the JAX planner takes it, and its sweep then fails with a TypeError
        # (a (1,) variance carried in, an (nT, nT) one drawn); say so up front
        raise TypeError(
            f"marker set {term.name}: a matrix v is the prior of correlated marker sets "
            "(CorrMarkerTerm); a single set's v is a scalar")
    n, p = md.n_ind, md.n_snp
    block = min(block, max(8, 1 << (p - 1).bit_length()))  # don't over-pad tiny sets
    p_pad = cdiv(p, block) * block
    nb = p_pad // block
    V = _resolve_vshards(vshards, nb, term.name)
    T = nb // V
    pad = p_pad - p

    rows = _packed_rows(md, term.name, device)
    q = rows.shape[1]
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, q))])
    # global block g = v*T + t  ->  storage (t, v)
    mt = rows.reshape(V, T, block, q).transpose(0, 1).contiguous()
    center = torch.as_tensor(md.center, device=device).to(dtype)
    if pad:
        center = torch.cat([center, center.new_zeros(pad)])
    center_tv = center.reshape(V, T, block).transpose(0, 1).contiguous()

    di = None if d_inv is None else torch.as_tensor(d_inv, dtype=dtype, device=device)
    gram_flat, raw_flat = _centered_grams(mt.view(T * V, block, q), center_tv.view(T * V, block),
                                          n, dtype, di)

    def locus_major(g):  # layout (t, v) -> (T, B, V, B)
        return g.view(T, V, block, block).permute(0, 2, 1, 3).contiguous()

    mpm = torch.diagonal(gram_flat, dim1=1, dim2=2).reshape(T, V, block).transpose(0, 1)

    # per-method region and variance bookkeeping (mme.jl:331-441)
    if prior is None:
        df, v0 = 4.0, 0.05
    else:
        df, v0 = _df_for(prior.v), float(prior.v)
    scale = _scale_for(v0, df)
    region_id = np.zeros(p_pad, np.int32)
    rows = lengths = None
    log_pi = pi_hat = v_class = None
    n_classes = n_annot = n_lv_cov = 0
    est_var_zeta = False
    extra = {}  # the annotation or log-variance fields of the state
    if method == METHOD_PR:
        info = build_regions(p, prior.r if prior is not None else 9999, md.chr_ids)
        region_id = np.concatenate([info.region_id, np.full(pad, info.n_regions, np.int32)])
        n_var = info.n_regions
        var_beta = np.full(n_var, v0)
        rows, lengths = _region_segments(info, device)
    elif method in (METHOD_B, METHOD_LV):
        region_id = np.arange(p_pad, dtype=np.int32)
        n_var = p_pad
        var_beta = np.zeros(p_pad)
        var_beta[:p] = v0
    elif method in (METHOD_RCPI, METHOD_RCPLUS):
        annot = P.normalize_annot(prior.annot).astype(np.float64)
        n_var = n_annot = annot.shape[1]
        var_beta = np.full(n_annot, v0)
    else:
        n_var = 1
        var_beta = np.full(1, v0)
    if method in (METHOD_B, METHOD_C):
        log_pi = np.log(np.array([1.0 - prior.pi, prior.pi]))
        pi_hat = np.array([1.0 - prior.pi, prior.pi])
        v_class = np.array([0.0, 1.0])
        n_classes = 2
    elif method == METHOD_R:
        pi = np.asarray(prior.pi, dtype=np.float64)
        log_pi, pi_hat = np.log(pi), pi
        v_class = np.asarray(prior.class_, dtype=np.float64)
        n_classes = len(v_class)
    elif method in (METHOD_RCPI, METHOD_RCPLUS):
        pi = np.asarray(prior.pi, dtype=np.float64)
        v_class = np.asarray(prior.class_, dtype=np.float64)
        n_classes = len(v_class)
        log_pi = np.tile(np.log(pi), (n_annot, 1))
        pi_hat = np.tile(pi, (n_annot, 1))
        with np.errstate(invalid="ignore"):
            ap = annot / annot.sum(axis=1, keepdims=True)
        annot_input = _pad_rows(annot, p_pad)
        extra = dict(annot_input=annot_input, annot_prob=_pad_rows(ap, p_pad),
                     annot_nz=torch.as_tensor(annot_input != 0, device=device),
                     annot_cat=torch.zeros(p_pad, dtype=torch.int32, device=device))
    elif method == METHOD_LV:
        C = _lv_design(prior, p, term.name)
        n_lv_cov = C.shape[1]
        icpc = C.T @ C
        if n_lv_cov > 1:
            icpc += np.eye(n_lv_cov) * np.min(np.abs(np.diag(icpc))) / 10000.0
        icpc = np.linalg.inv(icpc)
        log_var = np.full(p_pad, np.log(v0))
        log_var[p:] = 0.0
        lv_c = rng.uniform(size=n_lv_cov)
        lv_resid = np.zeros(p_pad)
        lv_resid[:p] = rng.uniform(size=p)
        extra = dict(log_var=log_var, lv_design=_pad_rows(C, p_pad), lv_icpc=icpc,
                     lv_icpc_chol=np.linalg.cholesky((icpc + icpc.T) / 2.0), lv_c=lv_c,
                     lv_resid=lv_resid, var_zeta=float(prior.varZeta))
        est_var_zeta = prior.estimateVarZeta
        if isinstance(est_var_zeta, np.floating):
            est_var_zeta = float(est_var_zeta)

    lhs_ss, rhs_ss = _marker_ss_offsets(p, ss)
    mask = torch.zeros(p_pad, dtype=torch.bool, device=device)
    mask[:p] = True

    def dev(a):
        if a is None or (isinstance(a, torch.Tensor) and not a.is_floating_point()):
            return a  # absent, or already placed (bool and int fields)
        return torch.as_tensor(a, dtype=dtype, device=device)

    ms = MarkerState(
        mt=mt,
        center=center_tv,
        gram=locus_major(gram_flat),
        gram_raw=None if raw_flat is None else locus_major(raw_flat),
        mpm=mpm.reshape(nb, block).contiguous(),
        lhs_ss=dev(_pad_rows(lhs_ss, p_pad)).reshape(nb, block),
        rhs_ss=dev(_pad_rows(rhs_ss, p_pad)).reshape(nb, block),
        mask=mask.reshape(nb, block),
        region_id=torch.as_tensor(region_id, device=device),
        beta=torch.zeros(p_pad, dtype=dtype, device=device),
        delta=torch.ones(p_pad, dtype=torch.int32, device=device),
        var_beta=dev(var_beta),
        scale=dev(scale),
        log_pi=dev(log_pi),
        pi_hat=dev(pi_hat),
        v_class=dev(v_class),
        **{k: dev(v) for k, v in extra.items()},
    )
    mp = MarkerPlan(
        name=term.name, method=method, p=p, p_pad=p_pad, block=block, n_blocks=nb,
        n_var=n_var, n_regions=n_var, n_classes=n_classes,
        est_pi=bool(getattr(prior, "estimatePi", False)), df=df, weighted=d_inv is not None,
        vshards=V, n_annot=n_annot, n_lv_cov=n_lv_cov, est_var_zeta=est_var_zeta,
        region_rows=rows, region_len=lengths,
    )
    return ms, mp


def _build_corr_marker(term: CorrMarkerTerm, block, dtype, device, vshards):
    """Correlated marker sets (mme.jl:448-489): nT panels of one set of
    loci under BayesPR with an (nT, nT) v; one packed row per (locus, set),
    the (nT, nT) cross-Gram blocks and each locus's diagonal block mpm, a
    region map shared by the sets. vshards through _resolve_vshards ("auto"
    is 1, the JAX package's rule for this term)."""
    names = "+".join(term.names)
    prior = term.prior
    if not isinstance(prior, P.BayesPR):
        raise ValueError("correlated marker sets support only the BayesPR prior")
    datas = term.datas
    if any(getattr(d, "packed", False) for d in datas):
        raise ValueError(
            f"correlated marker sets {names}: pre-packed "
            "genotype inputs (from_packed) are not supported here — pass "
            "unpacked dosage panels (from_array); eligible 0..3 dosages are "
            "re-packed 2-bit internally")
    n_t = len(datas)
    n, p = datas[0].n_ind, datas[0].n_snp
    chr_ids = datas[0].chr_ids
    for d in datas[1:]:  # mme.jl:453 requires one shared map
        m = d.chr_ids
        if (m is None) != (chr_ids is None) or (m is not None and not np.array_equal(m, chr_ids)):
            raise ValueError("correlated marker sets must have the same map file")
    vmat = np.asarray(prior.v, dtype=np.float64)
    if vmat.shape != (n_t, n_t):
        raise ValueError("correlated marker prior v must be nT x nT")
    df = 3.0 + n_t
    block = min(block, max(8, 1 << (p - 1).bit_length()))
    p_pad = cdiv(p, block) * block
    nb = p_pad // block
    V = _resolve_vshards(vshards, nb, names)
    T = nb // V
    pad = p_pad - p
    info = build_regions(p, prior.r, chr_ids)
    region_id = np.concatenate([info.region_id, np.full(pad, info.n_regions, np.int32)])

    rows = torch.stack([_packed_rows(d, names, device) for d in datas], dim=1)  # (p, nT, q)
    q = rows.shape[2]
    center = torch.stack([_as_device(d.center, dtype, device) for d in datas], dim=1)  # (p, nT)
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, n_t, q))])
        center = torch.cat([center, center.new_zeros((pad, n_t))])

    def tv(a):  # (p_pad, ...) in global locus order -> (T, V, B, ...)
        return a.reshape((V, T, block) + a.shape[1:]).transpose(0, 1).contiguous()

    mt, center_tv = tv(rows), tv(center)
    R = block * n_t
    gram, _ = _centered_grams(mt.view(T * V, R, q), center_tv.view(T * V, R), n, dtype)
    g6 = gram.view(T, V, block, n_t, block, n_t)
    mpm = torch.diagonal(g6, dim1=2, dim2=4).permute(1, 0, 4, 2, 3)  # (V, T, B, nT, nT)
    mask = torch.zeros(p_pad, dtype=torch.bool, device=device)
    mask[:p] = True
    region_rows, region_len = _region_segments(info, device)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    st = CorrMarkerState(
        mt=mt,
        center=center_tv,
        gram=g6.permute(0, 2, 3, 1, 4, 5).contiguous(),
        mpm=mpm.reshape(nb, block, n_t, n_t).contiguous(),
        mask=mask.reshape(nb, block),
        region_id=torch.as_tensor(region_id, device=device),
        beta=torch.zeros((p_pad, n_t), dtype=dtype, device=device),
        var_beta=dev(np.broadcast_to(vmat, (info.n_regions, n_t, n_t)).copy()),
        scale=dev(vmat * (df - n_t - 1.0)),
    )
    plan = CorrMarkerPlan(names=tuple(term.names), n_t=n_t, p=p, p_pad=p_pad, block=block,
                          n_blocks=nb, n_regions=info.n_regions, df=df, vshards=V,
                          region_rows=region_rows, region_len=region_len)
    return st, plan


def check_card_dtype(spec: ModelSpec, dtype, device) -> None:
    """Refuse a float64 model on a CUDA device where a float32-only kernel
    would meet it mid-sweep: marker sets and correlated marker sets (the
    panel passes and the scans) and random terms drawn by a per-level scan
    (RE1, RE2). CG terms and fixed effects run in float64 on the card."""
    if torch.device(device).type != "cuda" or dtype != torch.float64:
        return
    scan = [t.name for t in spec.random if not _random_prior(t)[1]]
    needs = ([f"marker sets {[t.name for t in spec.markers]}"] if spec.markers else []) + (
        [f"correlated marker sets {[t.names for t in spec.corr_markers]}"]
        if spec.corr_markers else []) + ([f"scan random terms {scan}"] if scan else [])
    if needs:
        raise ValueError(
            f"float64 on a CUDA device: {' and '.join(needs)} run in float32 kernels on the card; "
            'pass dtype=torch.float32 for the card, or device="cpu" for float64')


def assemble(spec: ModelSpec, dtype=None, device=None, block_size=None, vshards=1):
    """Build (SweepPlan, ModelState) from a validated ModelSpec.

    device: where the state lives and the sweep runs (default CUDA; without
    a CUDA device that raises, and only device="cpu" runs on the CPU).
    dtype: default float32 on CUDA, float64 on the CPU.
    float64 on a CUDA device raises (check_card_dtype) where the model has
    marker sets or a scan random term, before anything is placed on the card.
    vshards: V > 1 advances V marker blocks per block-step (the schedule a
    V-device run would use); the chain then differs from the V=1 order by
    design. A V that does not divide the block count falls back to its
    largest divisor with a warning. "auto" is 1 for every marker set: the
    JAX package's "auto" off its TPU kernel path, kept on the card too
    until a rule for the H100 is measured (ROADMAP M6 part 3).
    """
    spec.validate()
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    check_card_dtype(spec, dtype, device)
    rng = np.random.default_rng(20240509)  # the JAX planner's host generator and seed
    y = np.asarray(spec.y, dtype=np.float64).ravel()
    res_prior = spec.residual or P.RandomEffect("I", 100.0)
    d_inv = None
    if isinstance(res_prior.str_, (list, np.ndarray)):
        d_inv = 1.0 / np.asarray(res_prior.str_, dtype=np.float64)
    elif res_prior.str_ != "I":
        raise NotImplementedError(
            f"residual: structure {res_prior.str_!r} is not ported; the port takes 'I' "
            "or a weight vector")
    e_df = 4.0
    ev = float(res_prior.v)
    e_scale = 0.0005 if ev == 0.0 else ev * (e_df - 2.0) / e_df

    fixed_states, fixed_plans = [], []
    blocked = set()
    by_name = {t.name: t for t in spec.fixed}
    for blk in spec.blocks:
        st, fp = _build_fixed([by_name[nm].matrix() for nm in blk], tuple(blk), d_inv,
                              spec.summary_stats.get(tuple(blk)), dtype, device)
        fixed_states.append(st)
        fixed_plans.append(fp)
        blocked.update(blk)
    for t in spec.fixed:
        if t.name not in blocked:
            st, fp = _build_fixed([t.matrix()], t.name, d_inv, spec.summary_stats.get(t.name),
                                  dtype, device)
            fixed_states.append(st)
            fixed_plans.append(fp)

    random_states, random_plans = [], []
    for t in spec.random:
        st, rp = _build_random(t, d_inv, dtype, device)
        random_states.append(st)
        random_plans.append(rp)

    marker_states, marker_plans = [], []
    for t in spec.markers:
        st, mp = _build_marker(t, d_inv, spec.summary_stats.get(t.name),
                               block_size or spec.block_size, dtype, device, vshards, rng)
        marker_states.append(st)
        marker_plans.append(mp)

    corr_states, corr_plans = [], []
    for t in spec.corr_markers:
        st, cp = _build_corr_marker(t, block_size or spec.block_size, dtype, device, vshards)
        corr_states.append(st)
        corr_plans.append(cp)

    # Keys that nothing consumed: single fixed columns and marker sets use
    # their offsets (mme.jl:144-147, 316-322); multi-column blocks ignore
    # them in the reference too (sampleb!, functions.jl:22-36). Warn, as the
    # JAX package does, so that such a prior is not silently a no-op.
    if spec.summary_stats:
        consumed = {t.name for t in spec.markers} | {fp.name for fp in fixed_plans if fp.k == 1}
        dead = [k for k in spec.summary_stats if k not in consumed]
        if dead:
            warnings.warn(
                f"SummaryStatistics attached to {dead} are not consumed: the reference applies "
                "them only to single-column fixed effects and marker sets (its multi-column "
                "sampleb! never reads the stored offsets); this engine mirrors that behavior.",
                stacklevel=2)

    y_dev = torch.as_tensor(y, dtype=dtype, device=device)
    state = ModelState(
        y=y_dev,
        ycorr=y_dev.clone(),
        e=ResidualState(
            scale=torch.tensor(e_scale, dtype=dtype, device=device),
            d_inv=None if d_inv is None else torch.as_tensor(d_inv, dtype=dtype, device=device),
            var_e=torch.tensor(ev if ev > 0 else 0.0005, dtype=dtype, device=device),
        ),
        fixed=tuple(fixed_states),
        random=tuple(random_states),
        markers=tuple(marker_states),
        sweep_index=0,
        corr_markers=tuple(corr_states),
        sweep_counter=torch.zeros((), dtype=torch.int64, device=device),
    )
    plan = SweepPlan(n=y.size, e_df=e_df, weighted=d_inv is not None, fixed=tuple(fixed_plans),
                     random=tuple(random_plans), markers=tuple(marker_plans), dtype=dtype,
                     device=device, corr_markers=tuple(corr_plans))
    return plan, state
