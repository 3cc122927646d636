"""Conjugate gradient for mixed-model-equation solves.

Counterpart of `nextgp_tpu/ops/cg.py`: `cg_solve` (the point solutions of
`solve_mme`), `mme_matvec` and `solve_mme`, and the CG sampler's solve,
`cg_solve_sparse`. The JAX package runs the loop as a `lax.while_loop` on
the device. The rule is the JAX one, checked before every iteration: go on
while ||r|| > tol * max(||b||, 1e-30) and it < max_iter, so the iteration
count matches the JAX one on the same system.

`cg_solve` is matrix-free (the caller supplies the matvec) and reads its
stopping rule on the host once per iteration (a sync on the card), so a
solve cannot be captured in a CUDA graph: it serves `solve_mme` and, on the
CPU, the CG sampler. `cg_solve_sparse` solves the CG sampler's system
(diag + ivu K) x = b, K in padded sparse rows: on the card in one launch of
CG1 (csrc/cg_solve.cu), which decides the stopping rule on the card, so a
captured sweep holds the whole solve (its blocks own contiguous rows and
regions of scratch, laid out by `cg_layout` once a plan); on the CPU by its
plain version, cg_solve on the same matvec.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils import full_f32
from . import _cuda
from .pack2 import dosages


def cg_solve(
    matvec: Callable,
    b: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    tol: float = 1e-8,
    max_iter: int = 1000,
    precond: Optional[Callable] = None,
):
    """Solve A x = b for SPD A. Returns (x, n_iter, final residual norm), the
    norm as a 0-d tensor."""
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    z = precond(r) if precond else r
    p = z
    rz = torch.dot(r, z)
    limit = tol * torch.clamp(torch.linalg.norm(b), min=1e-30)
    it = 0
    while it < max_iter and bool(torch.linalg.norm(r) > limit):
        ap = matvec(p)
        alpha = rz / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r) if precond else r
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        it += 1
    return x, it, torch.linalg.norm(r)


def sparse_matvec_plain(diag, iv_idx, iv_val, iv_len, ivu, v):
    """(diag + ivu K) v with K in padded rows, each row's first iv_len
    entries read: diag_i v_i + ivu * sum_{k < len_i} val[i, k] v[idx[i, k]]."""
    live = torch.arange(iv_idx.shape[1], device=v.device) < iv_len[:, None]
    kv = torch.where(live, iv_val * v[iv_idx.long()], torch.zeros((), dtype=v.dtype,
                                                                   device=v.device)).sum(dim=1)
    return diag * v + ivu * kv


def cg_solve_sparse_plain(diag, iv_idx, iv_val, iv_len, ivu, b, x0, tol=1e-8, max_iter=1000):
    """Plain version of CG1: cg_solve (the JAX recurrence and stopping rule,
    read on the host each iteration) on sparse_matvec_plain. Returns (x,
    iterations as a 0-d int32 tensor, ||r||)."""
    x, it, res = cg_solve(lambda v: sparse_matvec_plain(diag, iv_idx, iv_val, iv_len, ivu, v), b,
                          x0=x0, tol=tol, max_iter=max_iter)
    return x, torch.tensor(it, dtype=torch.int32, device=b.device), res


ROW_WEIGHT = 2  # a row's work in CG1 beside its entries: its vector loads and stores
CHUNK = 12  # entries of one of CG1's chunks of K (kChunk of csrc/cg_solve.cu)


def row_cuts(iv_len, grid):
    """CG1's rows by block: block b owns rows cuts[b - 1] .. cuts[b] - 1
    (cuts[-1] = 0, cuts[grid - 1] = q), cut so that each holds an equal share
    of the rows' weights max(len, 1) + ROW_WEIGHT (its compacted entries, a
    row of none holding one, and its vector work). (grid - 1,) int32 on
    iv_len's device, computed there: nothing is read back."""
    cum = torch.cumsum(torch.clamp(iv_len, min=1) + ROW_WEIGHT, 0, dtype=torch.int64)
    targets = torch.arange(1, grid, device=iv_len.device, dtype=torch.int64) * cum[-1] // grid
    return torch.searchsorted(cum, targets, right=True, out_int32=True)


def cg_layout(iv_len, grid):
    """CG1's blocks on a grid: (cuts, first), on iv_len's device. cuts:
    row_cuts'; first (grid + 1,) int64: block b compacts its rows' max(len,
    1) entries into ceil(that / CHUNK) chunks, which take chunk slots
    first[b] .. first[b + 1] - 1 of the scratch, first[grid] of them in
    all. Computed where iv_len lies: nothing is read back."""
    cuts = row_cuts(iv_len, grid)
    ent = torch.cumsum(torch.clamp(iv_len, min=1), 0, dtype=torch.int64)
    before = torch.cat([ent.new_zeros(1), ent])  # entries of the rows before row i
    rows = torch.cat([cuts.long(), ent.new_full((1,), iv_len.numel())])
    per_block = torch.diff(before[rows], prepend=ent.new_zeros(1))
    return cuts, torch.cat([ent.new_zeros(1), torch.cumsum((per_block + CHUNK - 1) // CHUNK, 0)])


def plan_layout(iv_len, dtype, device):
    """CG1's layout for a plan's CG term on a CUDA device, made once on the
    host from its live lengths (a CPU tensor): (cuts, first, slots) for
    cg_solve_sparse's `layout`, on the device, for the grid of a solve in
    dtype there; slots = first[-1], the scratch's chunk slots."""
    lib = _cuda.lib()
    with torch.cuda.device(device):
        grid = lib.ngt_cg_solve_grid(int(dtype == torch.float64))
    _cuda.require(grid >= 1, "cg_solve: the card holds no block of CG1")
    cuts, first = cg_layout(iv_len.cpu(), grid)
    return cuts.to(device), first.to(device), int(first[-1])


def solve_with(lib, diag, iv_idx, iv_val, iv_len, ivu, b, x0, tol=1e-8, max_iter=1000, staged=None,
               layout=None):
    """One CG1 solve through `lib` (the port's library, or another build of
    csrc/cg_solve.cu with its C interface bound by _cuda.bind_cg); staged:
    the chunks of K a block keeps in shared memory (None: as many as it
    holds; fewer force the streamed path); layout: plan_layout's for these
    rows (None: cg_layout's made here, a few launches, with scratch for the
    most chunks q rows of width kw can need, as their count is not read
    back). Returns (x, iterations as a 0-d int32 device tensor, ||r||),
    written by the kernel."""
    q, k = iv_idx.shape
    dtype = b.dtype
    vecs = (diag, b, x0)
    _cuda.require(dtype in (torch.float32, torch.float64),
                  f"cg_solve: the kernel takes float32 or float64, not {dtype}")
    _cuda.require(all(t.is_cuda and t.dtype == dtype for t in (*vecs, iv_val, ivu))
                  and iv_idx.is_cuda and iv_len.is_cuda,
                  "cg_solve: every input must be on a CUDA device, the floats of one dtype")
    _cuda.require(len({t.device for t in (*vecs, iv_val, ivu, iv_idx, iv_len)}) == 1,
                  "cg_solve: every input must be on one device")
    _cuda.require(q >= 1 and k >= 1 and iv_val.shape == (q, k) and iv_idx.dtype == torch.int32
                  and iv_len.dtype == torch.int32 and iv_len.shape == (q,)
                  and iv_idx.is_contiguous() and iv_val.is_contiguous() and iv_len.is_contiguous(),
                  f"cg_solve: iv_idx (int32) and iv_val must be contiguous ({q}, {k}), iv_len "
                  f"({q},) int32")
    _cuda.require(all(t.shape == (q,) and t.is_contiguous() for t in vecs) and ivu.numel() == 1,
                  f"cg_solve: diag, b and x0 must be contiguous ({q},) vectors, ivu a scalar")
    _cuda.require(max_iter >= 0 and tol >= 0.0, "cg_solve: max_iter and tol must be >= 0")
    f64 = int(dtype == torch.float64)
    grid = lib.ngt_cg_solve_grid(f64)
    _cuda.require(grid >= 1, "cg_solve: the card holds no block of CG1")
    if layout is None:
        cuts, first = cg_layout(iv_len, grid)
        slots = q * k // CHUNK + grid
    else:
        cuts, first, slots = layout
        _cuda.require(cuts.shape == (grid - 1,) and first.shape == (grid + 1,)
                      and cuts.device == first.device == b.device,
                      f"cg_solve: the layout is not one for this device's grid of {grid}")
    x = x0.clone()
    scratch = torch.empty(lib.ngt_cg_solve_scratch_bytes(f64, q, slots, grid), dtype=torch.uint8,
                          device=b.device)
    barrier = torch.zeros(1, dtype=torch.int64, device=b.device)
    iters = torch.empty((), dtype=torch.int32, device=b.device)
    rnorm = torch.empty((), dtype=dtype, device=b.device)
    err = lib.ngt_cg_solve(f64, q, k, diag.data_ptr(), iv_idx.data_ptr(), iv_val.data_ptr(),
                           iv_len.data_ptr(), ivu.contiguous().data_ptr(), b.data_ptr(), x.data_ptr(),
                           cuts.data_ptr(), first.data_ptr(), scratch.data_ptr(), barrier.data_ptr(),
                           iters.data_ptr(), rnorm.data_ptr(), float(tol), int(max_iter), grid, slots,
                           -1 if staged is None else int(staged), _cuda.stream_of(b))
    _cuda.check(err, "cg_solve")
    return x, iters, rnorm


def cg_solve_sparse_kernel(diag, iv_idx, iv_val, iv_len, ivu, b, x0, tol=1e-8, max_iter=1000,
                           staged=None, layout=None):
    """CG1 on the card: the whole solve in one cooperative launch (after
    cg_layout's few where no layout is given), float32 or float64. Returns
    (x, iterations as a 0-d int32 device tensor, ||r||), written by the
    kernel: nothing is read back to the host. staged, layout: as
    solve_with's (tests force the streamed path with staged)."""
    out = solve_with(_cuda.lib(), diag, iv_idx, iv_val, iv_len, ivu, b, x0, tol, max_iter, staged,
                     layout)
    _cuda.LAUNCHES["cg_solve"] += 1
    return out


def cg_solve_sparse(diag, iv_idx, iv_val, iv_len, ivu, b, x0, tol=1e-8, max_iter=1000, layout=None):
    """Solve (diag + ivu K) x = b from x0 by CG, K in padded sparse rows of
    live lengths iv_len; diag (q,) and ivu (0-d) device tensors. Returns
    (x, iterations as a 0-d int32 tensor, ||r||): CG1 for CUDA tensors (it
    raises on what it does not take; layout: the plan's plan_layout, or
    None), the plain version for CPU tensors."""
    if b.is_cuda:
        return cg_solve_sparse_kernel(diag, iv_idx, iv_val, iv_len, ivu, b, x0, tol, max_iter,
                                      layout=layout)
    return cg_solve_sparse_plain(diag, iv_idx, iv_val, iv_len, ivu, b, x0, tol, max_iter)


def _dosages(ms, n, dtype):
    """A marker set's (p_pad, n) dosages and (p_pad,) centers in global locus
    order. The port stores block g = v*T + t at (t, v) of its (T, V, B, W)
    layout (packed or not), so chain v's T blocks are contiguous once V leads."""
    T, V, B, W = ms.mt.shape
    rows = ms.mt.transpose(0, 1).reshape(V * T * B, W)
    return dosages(rows, dtype, n), ms.center.transpose(0, 1).reshape(-1)


def mme_matvec(plan, state, var_e, jitter=0.0):
    """Matvec of the Henderson MME coefficient matrix over the flat
    parameter vector [b; u_1..; beta_1..] for ridge-style (BayesPR) models:

        C = [X'X/ve          X'Z/ve              X'M/ve        ]
            [Z'X/ve   Z'Z/ve + Ainv/vu   ...                   ]
            [M'X/ve          ...        M'M/ve + I/vbeta       ]

    Dense assembly is avoided; each block applies its design matrix, the
    markers' unpacked into (p_pad, n) dosages of the state's dtype (fine at
    the diagnostic sizes this solver serves). Random terms must be the
    per-level scan's (dense Z), as in the JAX package. Returns (matvec, rhs,
    sizes) for the current variance values.
    """
    n = state.ycorr.shape[0]
    dtype = state.ycorr.dtype
    xs = [fs.x for fs in state.fixed]
    for rp in plan.random:
        if rp.sampler == "cg":
            raise NotImplementedError(
                f"mme_matvec: random term {rp.name} is held sparse for the CG sampler; "
                "the MME matvec takes dense random terms (sampler='scan'), as the JAX package's")
    zs = [(rs.z, rs.ivstr, rs.var_u) for rs in state.random]
    ms = []
    for msta, mp in zip(state.markers, plan.markers):
        mt, center = _dosages(msta, n, dtype)
        ivb = 1.0 / msta.var_beta[torch.clamp(msta.region_id.long(), 0, mp.n_var - 1)]
        mask = msta.mask.reshape(-1)
        ms.append((mt, center, torch.where(mask, ivb, torch.ones_like(ivb)), mask))
    sizes = [x.shape[1] for x in xs] + [z.shape[1] for z, _, _ in zs] + [m[0].shape[0] for m in ms]
    ive = 1.0 / var_e

    def parts_of(vec):
        return list(torch.split(vec, sizes))

    def matvec(vec):
        with full_f32():
            parts = parts_of(vec)
            eta = torch.zeros_like(state.ycorr)
            i = 0
            for x in xs:
                eta = eta + x @ parts[i]
                i += 1
            for z, _, _ in zs:
                eta = eta + z @ parts[i]
                i += 1
            for mt, c, _, _ in ms:
                beta = parts[i]
                eta = eta + beta @ mt - torch.dot(beta, c)
                i += 1
            out = []
            i = 0
            for x in xs:
                out.append((x.T @ eta) * ive)
                i += 1
            for z, ivstr, vu in zs:
                out.append((z.T @ eta) * ive + (ivstr @ parts[i]) / vu)
                i += 1
            for mt, c, ivb, mask in ms:
                beta = parts[i]
                mtv = mt @ eta - c * torch.sum(eta)
                out.append(torch.where(mask, mtv * ive + ivb * beta + jitter * beta, beta))
                i += 1
            return torch.cat(out)

    y = state.y
    with full_f32():
        rhs = [(x.T @ y) * ive for x in xs] + [(z.T @ y) * ive for z, _, _ in zs]
        for mt, c, _, mask in ms:
            rhs.append(torch.where(mask, (mt @ y - c * torch.sum(y)) * ive, torch.zeros_like(c)))
    return matvec, torch.cat(rhs), sizes


def solve_mme(plan, state, var_e, tol=1e-10, max_iter=2000):
    """Posterior-mode (BLUP/ridge) solution of the current model by CG:
    ({"b:<name>" | "u:<name>" | "beta:<name>": tensor}, iterations, final
    residual norm)."""
    matvec, rhs, sizes = mme_matvec(plan, state, var_e)
    x, it, res = cg_solve(matvec, rhs, tol=tol, max_iter=max_iter)
    names = ([("b", fp.name) for fp in plan.fixed] + [("u", rp.name) for rp in plan.random]
             + [("beta", mp.name) for mp in plan.markers])
    out = {f"{kind}:{name}": part for (kind, name), part in zip(names, torch.split(x, sizes))}
    return out, int(it), float(res)
