"""Pedigree handling: ordering, inbreeding, the numerator-relationship inverse.

A copy of `nextgp_tpu/data/pedigree.py` (NextGP.jl's makePed and makeA,
misc.jl:73-115): read a pedigree file, order it parents before offspring,
compute inbreeding coefficients (Meuwissen & Luo 1992), and build A^-1 by
Henderson's rules, dense for the per-level scan or sparse for the CG
sampler. The JAX package routes inbreeding and the A^-1 triplets through its
native C++ library where it loads; this copy keeps the pure-Python
inbreeding and builds the triplets in numpy, in the native library's order,
so that no dense (q, q) matrix is formed on the way to the sparse forms
(at q = 100,000 that would be 80 GB). Host-side numpy: the planner ships the
results to the device once.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class Pedigree:
    """Ordered pedigree. ids[i] is the original label of individual i+1;
    sire[i], dam[i] are 0-based indices into the ordered list (-1 = unknown)."""

    ids: list
    sire: np.ndarray
    dam: np.ndarray
    inbreeding: np.ndarray  # F_i per ordered individual

    @property
    def n(self) -> int:
        return len(self.ids)

    def index_of(self, labels: Sequence) -> np.ndarray:
        table = {v: i for i, v in enumerate(self.ids)}
        return np.array([table[x] for x in labels], dtype=np.int64)


def _toposort(ids, sire_lbl, dam_lbl):
    """Order individuals so that every parent precedes its offspring
    (PedigreeBase.find_ped_order / permute_ped!, misc.jl:101-102)."""
    known = set(ids)
    parents = {}
    for i, v in enumerate(ids):
        s, d = sire_lbl[i], dam_lbl[i]
        parents[v] = tuple(p for p in (s, d) if p is not None and p in known)
    order: list = []
    state: dict = {}

    def visit(v):
        stack = [(v, iter(parents[v]))]
        state[v] = 1
        while stack:
            node, it = stack[-1]
            advanced = False
            for p in it:
                st = state.get(p, 0)
                if st == 1:
                    raise ValueError(f"pedigree loop detected at {p!r}")
                if st == 0:
                    state[p] = 1
                    stack.append((p, iter(parents[p])))
                    advanced = True
                    break
            if not advanced:
                stack.pop()
                state[node] = 2
                order.append(node)

    for v in ids:
        if state.get(v, 0) == 0:
            visit(v)
    return order


def read_pedigree(path: str) -> Pedigree:
    """Read a whitespace- or comma-delimited `id sire dam` file ('0', 'NA'
    or '.' = unknown) and return the ordered pedigree (makePed,
    misc.jl:98-115)."""
    ids, sires, dams = [], [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.replace(",", " ").split()
            if parts[0].lower() in ("id", "ind", "animal"):
                continue  # header
            ids.append(parts[0])
            sires.append(None if parts[1] in ("0", "NA", ".") else parts[1])
            dams.append(None if parts[2] in ("0", "NA", ".") else parts[2])
    return build_pedigree(ids, sires, dams)


def build_pedigree(ids, sires, dams) -> Pedigree:
    ids = list(ids)
    if len(set(ids)) != len(ids):
        dupes = [v for v, c in Counter(ids).items() if c > 1]
        raise ValueError(
            f"pedigree has duplicate individual ids (first few: {dupes[:5]}); "
            "a silent last-row-wins merge would corrupt A-inverse/inbreeding"
        )
    order = _toposort(ids, sires, dams)
    pos = {v: i for i, v in enumerate(order)}
    lookup = dict(zip(ids, zip(sires, dams)))
    n = len(order)
    sire = np.full(n, -1, dtype=np.int64)
    dam = np.full(n, -1, dtype=np.int64)
    for v, i in pos.items():
        s, d = lookup.get(v, (None, None))
        if s is not None and s in pos:
            sire[i] = pos[s]
        if d is not None and d in pos:
            dam[i] = pos[d]
    f = inbreeding_meuwissen_luo(sire, dam)
    return Pedigree(ids=order, sire=sire, dam=dam, inbreeding=f)


def inbreeding_meuwissen_luo(sire: np.ndarray, dam: np.ndarray) -> np.ndarray:
    """Inbreeding coefficients by the Meuwissen & Luo (1992) L-matrix
    algorithm (PedigreeBase.get_inb, misc.jl:108), the JAX package's
    pure-Python branch. O(n * depth^2) worst case; linear for shallow
    pedigrees."""
    n = len(sire)
    f = np.zeros(n + 1)  # f[0] slot unused; work 1-based internally
    s = np.asarray(sire) + 1
    d = np.asarray(dam) + 1
    point = np.zeros(n + 1, dtype=np.int64)
    L = np.zeros(n + 1)
    D = np.zeros(n + 1)
    for i in range(1, n + 1):
        si, di = s[i - 1], d[i - 1]
        fs = f[si] if si > 0 else -1.0
        fd = f[di] if di > 0 else -1.0
        D[i] = 0.5 - 0.25 * (fs + fd)
        if si == 0 or di == 0:
            f[i] = 0.0
            continue
        fi = -1.0
        L[i] = 1.0
        j = i
        while j != 0:
            k = j
            r = 0.5 * L[k]
            # M&L92 requires the descending-order invariant ks >= kd
            ks, kd = max(s[k - 1], d[k - 1]), min(s[k - 1], d[k - 1])
            if ks > 0:
                while point[k] > ks:
                    k = point[k]
                L[ks] += r
                if ks != point[k]:
                    point[ks] = point[k]
                    point[k] = ks
                if kd > 0:
                    while point[k] > kd:
                        k = point[k]
                    L[kd] += r
                    if kd != point[k]:
                        point[kd] = point[k]
                        point[k] = kd
            fi += L[j] * L[j] * D[j]
            L[j] = 0.0
            k = j
            j = point[j]
            point[k] = 0
        f[i] = fi
    return f[1:]


def _mendelian_d(ped: Pedigree) -> np.ndarray:
    """d_i = 1 - 1/4 (1 + F_s) [sire known] - 1/4 (1 + F_d) [dam known]: the
    Mendelian-sampling variance of each individual, 1/alpha_i of Henderson's
    rules."""
    f = np.asarray(ped.inbreeding, dtype=np.float64)
    s, d = np.asarray(ped.sire), np.asarray(ped.dam)
    fs = np.where(s >= 0, f[np.maximum(s, 0)], 0.0)
    fd = np.where(d >= 0, f[np.maximum(d, 0)], 0.0)
    return 1.0 - np.where(s >= 0, 0.25 * (1.0 + fs), 0.0) - np.where(d >= 0, 0.25 * (1.0 + fd), 0.0)


def a_inverse(ped: Pedigree) -> np.ndarray:
    """Dense A-inverse by Henderson's rules with inbreeding
    (PedigreeBase.get_nrminv, misc.jl:110).

    For individual i with parents s, d:
      alpha_i = 1 / (0.5 - 0.25*(F_s + F_d))   (both parents known)
                1 / (0.75 - 0.25*F_p)          (one parent known)
                1                              (no parents known)
    Add alpha to (i,i); -alpha/2 to (i,p) & (p,i); alpha/4 to (p,q).
    """
    n = ped.n
    f = ped.inbreeding
    ainv = np.zeros((n, n))
    for i in range(n):
        si, di = ped.sire[i], ped.dam[i]
        fs = f[si] if si >= 0 else 0.0
        fd = f[di] if di >= 0 else 0.0
        ns = 1 if si >= 0 else 0
        nd = 1 if di >= 0 else 0
        dii = 1.0 - 0.25 * ns * (1.0 + fs) - 0.25 * nd * (1.0 + fd)
        alpha = 1.0 / dii
        ainv[i, i] += alpha
        for p in (si, di):
            if p >= 0:
                ainv[i, p] -= alpha / 2.0
                ainv[p, i] -= alpha / 2.0
                ainv[p, p] += alpha / 4.0
        if si >= 0 and di >= 0:
            ainv[si, di] += alpha / 4.0
            ainv[di, si] += alpha / 4.0
    return ainv


def a_inverse_triplets(ped: Pedigree):
    """A-inverse as COO triplets (rows, cols, vals), duplicates not summed,
    in the order of the JAX package's native `ng_ainverse_triplets`
    (nextgp_tpu/native/src/nextgp_native.cpp): per individual i, (i, i),
    then for the sire and then the dam (i, p), (p, i), (p, p), then
    (s, d), (d, s) where both are known."""
    n = ped.n
    s, d = np.asarray(ped.sire, np.int64), np.asarray(ped.dam, np.int64)
    a = 1.0 / _mendelian_d(ped)
    i = np.arange(n, dtype=np.int64)
    # one row of nine candidate triplets per individual, in the native order
    rows = np.stack([i, i, s, s, i, d, d, s, d], axis=1)
    cols = np.stack([i, s, i, s, d, i, d, d, s], axis=1)
    vals = np.stack([a, -a / 2.0, -a / 2.0, a / 4.0, -a / 2.0, -a / 2.0, a / 4.0, a / 4.0, a / 4.0],
                    axis=1)
    hs, hd = s >= 0, d >= 0
    keep = np.stack([np.ones(n, bool), hs, hs, hs, hd, hd, hd, hs & hd, hs & hd], axis=1)
    return rows[keep], cols[keep], vals[keep]


def a_inverse_coo(ped: Pedigree):
    """A-inverse as summed COO triplets (rows, cols, vals), sorted by row and
    then column: the sparse form for pedigrees where the dense (n, n) of
    `a_inverse` would not fit. Entries with duplicate (i, j) are summed."""
    ri, ci, v = a_inverse_triplets(ped)
    n = ped.n
    lin = ri * n + ci
    uniq, inv = np.unique(lin, return_inverse=True)
    vals = np.zeros(len(uniq))
    np.add.at(vals, inv, v)
    return uniq // n, uniq % n, vals


def a_inverse_padded(ped: Pedigree):
    """A-inverse as fixed-width padded rows for device matvecs:
    (idx (q, K) int32, val (q, K) f64) with zero-padding (idx 0, val 0).
    A^-1 v == sum_k val[:, k] * v[idx[:, k]]. K is the largest row support
    (parents, offspring, co-parents; typically << q)."""
    ri, ci, v = a_inverse_coo(ped)
    q = ped.n
    counts = np.bincount(ri, minlength=q)
    K = int(counts.max()) if len(counts) else 1
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(len(ri)) - starts[ri]  # ri is sorted: each entry's place in its row
    idx = np.zeros((q, K), np.int32)
    val = np.zeros((q, K), np.float64)
    idx[ri, slot] = ci
    val[ri, slot] = v
    return idx, val


def a_inverse_factor(ped: Pedigree):
    """The Henderson factorization A^-1 = (I - P)' D^-1 (I - P), where
    (P u)_i = (u_sire + u_dam) / 2 and D is the Mendelian-sampling variance
    diag. Returns (sire, dam, dinv_sqrt) so a draw s ~ N(0, A^-1) is
    s = (I - P)' (dinv_sqrt * xi), xi ~ N(0, I), with no Cholesky."""
    return (
        np.asarray(ped.sire).astype(np.int32),
        np.asarray(ped.dam).astype(np.int32),
        1.0 / np.sqrt(_mendelian_d(ped)),
    )


def make_a(sire, dam) -> np.ndarray:
    """Dense tabular numerator relationship matrix from 0-coded sire/dam
    vectors (makeA, misc.jl:73-90; individuals ordered, 1-based labels with
    0 = unknown as in NextGP.jl)."""
    s = np.asarray(sire, dtype=np.int64)
    d = np.asarray(dam, dtype=np.int64)
    n = len(s)
    A = np.zeros((n + 1, n + 1))  # slot n is the zero "unknown" slot
    s = np.where(s == 0, n + 1, s) - 1
    d = np.where(d == 0, n + 1, d) - 1
    for i in range(n):
        A[i, i] = 1.0 + A[s[i], d[i]] / 2.0
        for j in range(i + 1, n):
            A[i, j] = (A[i, s[j]] + A[i, d[j]]) / 2.0
            A[j, i] = A[i, j]
    return A[:n, :n]


def incidence_matrix(data_levels, effect_levels=None):
    """0/1 incidence matrix mapping data rows to sorted unique non-zero
    levels (make_ran_matrix / ranMat, misc.jl:24-40).

    Returns (levels, Z) with Z (nData, nLevels) float64.
    """
    x = np.asarray(data_levels)
    if effect_levels is None:
        effect_levels = x
    u = np.unique(np.asarray(effect_levels))
    u = u[u != 0] if u.dtype.kind in "iuf" else u[u != "0"]
    Z = (x[:, None] == u[None, :]).astype(np.float64)
    return list(u), Z
