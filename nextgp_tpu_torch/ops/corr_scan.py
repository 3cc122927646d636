"""The in-block scan of correlated marker sets, V chains at a time (CM1,
csrc/corr_scan.cu).

Counterpart of the `lax.scan` over a block's loci in the JAX package's
`sample_corr_marker_set` (nextgp_tpu/engine/samplers/markers.py:898-916;
NextGP.jl functions.jl:140-154). It replaces no Pallas kernel: the JAX
package runs the loop as one compiled scan, and written as plain PyTorch on
the card a locus would be several launches. Each locus carries nT effects,
one per set, with an (nT, nT) conditional covariance:

    pre_j  = r0_j + sum_{b<j} G[j, b] (bold_b - bnew_b) + G[j, j] bold_j
    bnew_j = M_j pre_j + c_j           (0 on a padded locus)

with G[j, b] the (nT, nT) block of the centered cross-Gram,
M_j = cov_j / varE, c_j = chol(cov_j) z_j and cov_j = sym(inv(mpm_j / varE
+ inv(var_beta[region(j)]))). Nothing of M_j and c_j depends on the chain,
so `corr_block_pack` computes them for every locus of the set at once
(batched torch.linalg calls on the card, without host checks), with the
restore G[j, j] bold_j folded into the additive slot. Packed rows, W =
3 nT + nT^2 floats a locus:

    [adj (nT) | bold (nT) | c (nT) | M (nT x nT, row-major)]

The caller adds r0 to adj per block-step. The Gram is (B, nT, V, B, nT) a
step, gram[j, u, v, k, w] = <Mc[j, u], Mc[k, w]> (engine/state.py).
"""
from __future__ import annotations

import torch

from . import _cuda
from .gibbs_kernels import SMEM_BYTES, _step

FAST_NT = 4  # the largest nT with a register form in csrc/corr_scan.cu (its switch)


def pack_width(n_t: int) -> int:
    return 3 * n_t + n_t * n_t


def corr_block_pack(beta_old, z, ivb, mpm, mask, ive):
    """The per-locus rule for all p loci: beta_old (p, nT), z (p, nT), ivb
    (p, nT, nT) the inverse region covariance of each locus, mpm (p, nT, nT),
    mask (p,) -> rows (p, 3 nT + nT^2). A non-positive-definite locus gives
    NaN, with no host check (a captured sweep cannot sync)."""
    p, n_t = beta_old.shape
    cov = torch.linalg.inv_ex(mpm * ive + ivb, check_errors=False)[0]
    cov = (cov + cov.transpose(-1, -2)) / 2.0
    chol = torch.linalg.cholesky_ex(cov, check_errors=False)[0]
    keep = mask[:, None, None].to(cov.dtype)
    M = cov * ive * keep
    c = (chol @ z[..., None])[..., 0] * keep[:, 0]
    adj = (mpm @ beta_old[..., None])[..., 0]
    return torch.cat([adj, beta_old, c, M.reshape(p, -1)], dim=1)


def corr_block_scan_v_plain(gram, pk, n_t):
    """Plain version: gram (B, nT, V, B, nT), pk (V, B, W) -> beta (V, B, nT),
    u (V, B, nT), the JAX package's per-locus body: u holds bold at the
    current locus, bold - bnew before it and 0 after it."""
    V, B, _ = pk.shape
    adj, bold = pk[..., :n_t], pk[..., n_t:2 * n_t]
    c, M = pk[..., 2 * n_t:3 * n_t], pk[..., 3 * n_t:].reshape(V, B, n_t, n_t)
    u = torch.zeros((V, B, n_t), dtype=pk.dtype, device=pk.device)
    beta = torch.zeros_like(u)
    for j in range(B):
        pre = adj[:, j] + torch.einsum("uvkw,vkw->vu", gram[j, :, :, :j], u[:, :j])
        bnew = torch.einsum("vtu,vu->vt", M[:, j], pre) + c[:, j]
        beta[:, j] = bnew
        u[:, j] = bold[:, j] - bnew
    return beta, u


def corr_scan_smem_bytes(B, n_t):
    """Shared memory one block of CM1 takes, as csrc/corr_scan.cu lays it
    out: the chain's u's (a thread per locus, nT each) and two slots of a
    group's (32 nT) x (32 nT) diagonal tile and 32 rows (fast forms); none
    for the generic form."""
    if n_t > FAST_NT:
        return 0
    threads = 32 * -(-B // 32)
    return 4 * (threads * n_t + 2 * (32 * n_t * 32 * n_t + 32 * pack_width(n_t)))


def corr_block_scan_v_kernel(gram_t, pk, n_t):
    """CM1 on the card: one launch, V blocks (one per chain)."""
    gram, t = _step(gram_t, True)
    V, B, W = pk.shape
    _cuda.require(gram.is_cuda and pk.is_cuda and gram.device == pk.device,
                  "corr_block_scan_v: the Gram and the rows must be on one CUDA device")
    _cuda.require(gram.dtype == torch.float32 and pk.dtype == torch.float32,
                  "corr_block_scan_v: float32 only")
    _cuda.require(gram.is_contiguous() and pk.is_contiguous() and W == pack_width(n_t),
                  f"corr_block_scan_v: contiguous inputs, rows of {pack_width(n_t)} floats")
    _cuda.require(gram.shape[1:] == (B, n_t, V, B, n_t) and 0 <= t < gram.shape[0],
                  f"corr_block_scan_v: Gram steps of shape ({B}, {n_t}, {V}, {B}, {n_t})")
    _cuda.require(1 <= B <= 1024 and n_t >= 1, "corr_block_scan_v: 1 <= B <= 1024")
    _cuda.require(corr_scan_smem_bytes(B, n_t) <= SMEM_BYTES,
                  f"corr_block_scan_v: B={B}, nT={n_t} exceed shared memory")
    beta = torch.empty((V, B, n_t), dtype=torch.float32, device=pk.device)
    u = torch.empty_like(beta)
    pre = torch.empty_like(beta) if n_t > FAST_NT else None  # the generic form's sums
    step = gram.data_ptr() + t * B * n_t * V * B * n_t * 4
    err = _cuda.lib().ngt_corr_block_scan_v(
        step, pk.data_ptr(), beta.data_ptr(), u.data_ptr(), None if pre is None else pre.data_ptr(),
        V, B, n_t, _cuda.stream_of(pk))
    _cuda.check(err, "corr_block_scan_v")
    _cuda.LAUNCHES["corr_block_scan_v"] += 1
    return beta, u


def corr_block_scan_v(gram_t, pk, n_t):
    """V-batched correlated block scan (CM1). gram_t: a (B, nT, V, B, nT)
    block or the step-indexed pair ((T, B, nT, V, B, nT), t); pk (V, B, W).
    Returns beta (V, B, nT), u = bold - beta (V, B, nT): the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if pk.is_cuda:
        return corr_block_scan_v_kernel(gram_t, pk, n_t)
    return corr_block_scan_v_plain(_step(gram_t, False), pk, n_t)


def corr_block_system(gram, pk, n_t):
    """The scan as V unit lower-triangular systems of B nT unknowns
    (locus-major): u_j + M_j sum_{b<j} G[j, b] u_b = bold_j - c_j - M_j adj_j,
    which one batched torch.linalg.solve_triangular solves (a yardstick on
    the card, on no sweep path). gram (B, nT, V, B, nT), pk (V, B, W) ->
    matrices (V, B nT, B nT), rhs (V, B nT, 1); beta = bold - u."""
    V, B, _ = pk.shape
    adj, bold = pk[..., :n_t], pk[..., n_t:2 * n_t]
    c, M = pk[..., 2 * n_t:3 * n_t], pk[..., 3 * n_t:].reshape(V, B, n_t, n_t)
    G = gram.permute(2, 0, 1, 3, 4)  # (V, B, nT, B, nT)
    low = torch.tril(torch.ones(B, B, dtype=torch.bool, device=pk.device), diagonal=-1)
    G = G * low[None, :, None, :, None]
    mat = torch.einsum("vjts,vjsbw->vjtbw", M, G).reshape(V, B * n_t, B * n_t)
    mat.diagonal(dim1=1, dim2=2).add_(1.0)
    rhs = bold - c - torch.einsum("vjts,vjs->vjt", M, adj)
    return mat, rhs.reshape(V, -1, 1)
