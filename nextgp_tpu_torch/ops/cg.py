"""Conjugate gradient for mixed-model-equation solves.

Counterpart of `nextgp_tpu/ops/cg.py`: `cg_solve` (the CG sampler's solver,
and the point solutions of `solve_mme`), `mme_matvec` and `solve_mme`.
Matrix-free: the caller supplies the matvec. The JAX package runs the loop
as a `lax.while_loop` on the device; here the stopping rule is read on the
host once per iteration (a sync on the card), so a solve cannot be captured
in a CUDA graph. The rule is the JAX one, checked before every iteration:
go on while ||r|| > tol * max(||b||, 1e-30) and it < max_iter, so the
iteration count matches the JAX one on the same system.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..utils import full_f32
from . import pack2


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


def _dosages(ms, n, dtype):
    """A marker set's (p_pad, n) dosages and (p_pad,) centers in global locus
    order. The port stores block g = v*T + t at (t, v) of its (T, V, B, q)
    packed layout, so chain v's T blocks are contiguous once V leads."""
    T, V, B, q = ms.mt.shape
    rows = ms.mt.transpose(0, 1).reshape(V * T * B, q)
    return pack2.unpack2(rows, dtype)[:, :n], ms.center.transpose(0, 1).reshape(-1)


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
