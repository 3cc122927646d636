"""The in-block scan of correlated marker sets, V chains at a time (CM1,
csrc/corr_scan.cu), and the per-locus rule it reads.

Counterpart of the `lax.scan` over a block's loci in the JAX package's
`sample_corr_marker_set` (nextgp_tpu/engine/samplers/markers.py:893-916;
NextGP.jl functions.jl:140-154). It replaces no Pallas kernel: the JAX
package runs the loop as one compiled scan, and written as plain PyTorch on
the card a locus would be several launches. Each locus carries nT effects,
one per set, with an (nT, nT) conditional covariance:

    pre_j  = r0_j + sum_{b<j} G[j, b] (bold_b - bnew_b) + G[j, j] bold_j
    bnew_j = M_j pre_j + c_j           (0 on a padded locus)

with G[j, b] the (nT, nT) block of the centered cross-Gram,
M_j = cov_j / varE, c_j = chol(cov_j) z_j and cov_j = sym(inv(mpm_j / varE
+ inv(var_beta[region(j)]))). Nothing of M_j and c_j depends on the chain,
so the rule (`corr_rule`: one launch for nT <= 4, one thread a locus;
`corr_block_pack` its plain version) computes them for every locus of the
set at once, with the restore G[j, j] bold_j folded into the additive slot.
Packed rows, W = 3 nT + nT^2 floats a locus:

    [adj (nT) | bold (nT) | c (nT) | M (nT x nT, row-major)]

A block-step (`corr_block_step`) adds r0 - centre * sum(y) to adj, scans
and writes beta; on the card one CM1 launch does all three, reading the
step's rows in place. The Gram is (B, nT, V, B, nT) a step, gram[j, u, v,
k, w] = <Mc[j, u], Mc[k, w]> (engine/state.py).
"""
from __future__ import annotations

import torch

from . import _cuda

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


def corr_rule_plain(beta_old, z, var_beta, region_id, mpm, mask, var_e):
    """Plain version of the rule launch: every region's inverse, gathered by
    locus (region_id clamped to the regions), then corr_block_pack with
    1 / varE. var_beta (n_regions, nT, nT), region_id (p,), var_e 0-d."""
    ivr = torch.linalg.inv_ex(var_beta, check_errors=False)[0]
    ivb = ivr[torch.clamp(region_id, 0, var_beta.shape[0] - 1).long()]
    return corr_block_pack(beta_old, z, ivb, mpm, mask, 1.0 / var_e)


def corr_rule_with(lib, beta_old, z, var_beta, region_id, mpm, mask, var_e):
    """The rule launch through lib's C interface (this tree's launcher for
    another build too): one thread a locus (nT <= 4)."""
    p, n_t = beta_old.shape
    args = (beta_old, z, var_beta, region_id, mpm, mask, var_e)
    _cuda.require(all(a.is_cuda and a.device == beta_old.device for a in args),
                  "corr_rule: every input on one CUDA device")
    _cuda.require(all(a.dtype == torch.float32 for a in (beta_old, z, var_beta, mpm, var_e))
                  and region_id.dtype == torch.int32 and mask.dtype == torch.bool,
                  "corr_rule: float32 values, int32 regions, a bool mask")
    _cuda.require(all(a.is_contiguous() for a in args) and 1 <= n_t <= FAST_NT
                  and z.shape == (p, n_t) and mpm.shape == (p, n_t, n_t)
                  and var_beta.shape[1:] == (n_t, n_t) and var_beta.shape[0] >= 1
                  and region_id.shape == (p,) and mask.shape == (p,) and var_e.numel() == 1,
                  f"corr_rule: contiguous (p, nT) values with 1 <= nT <= {FAST_NT}")
    pk = torch.empty((p, pack_width(n_t)), dtype=torch.float32, device=beta_old.device)
    err = lib.ngt_corr_rule(beta_old.data_ptr(), z.data_ptr(), mpm.data_ptr(), mask.data_ptr(),
                            var_beta.data_ptr(), region_id.data_ptr(), var_e.data_ptr(),
                            pk.data_ptr(), p, var_beta.shape[0], n_t, _cuda.stream_of(pk))
    _cuda.check(err, "corr_rule")
    return pk


def corr_rule_kernel(beta_old, z, var_beta, region_id, mpm, mask, var_e):
    """The rule on the card: one launch, one thread a locus (nT <= 4)."""
    pk = corr_rule_with(_cuda.lib(), beta_old, z, var_beta, region_id, mpm, mask, var_e)
    _cuda.LAUNCHES["corr_rule"] += 1
    return pk


def corr_rule(beta_old, z, var_beta, region_id, mpm, mask, var_e):
    """Packed rows (p, 3 nT + nT^2) of every locus: the rule launch for CUDA
    tensors with nT <= 4, the torch pack above (the generic form's), the
    plain version for CPU tensors."""
    if beta_old.is_cuda and beta_old.shape[1] <= FAST_NT:
        return corr_rule_kernel(beta_old, z, var_beta, region_id, mpm, mask, var_e)
    return corr_rule_plain(beta_old, z, var_beta, region_id, mpm, mask, var_e)


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


def corr_block_step_plain(gram, pk_g, t, r0, cb, sum_y, beta):
    """Plain version of a block-step: step t's rows of pk_g (V, T, B, W),
    r0 - cb * sum_y added to adj, the scan on gram (B, nT, V, B, nT), beta_t
    written into beta[:, t] (beta (V, T, B, nT)); returns u (V, B, nT)."""
    n_t = beta.shape[-1]
    pk_t = pk_g[:, t].clone()
    pk_t[..., :n_t] += r0 - cb * sum_y
    beta_t, u = corr_block_scan_v_plain(gram, pk_t, n_t)
    beta[:, t] = beta_t
    return u


def corr_block_step_with(lib, gram_t, pk_g, r0, cb, sum_y, beta):
    """CM1's block-step through lib's C interface (this tree's launcher for
    another build too): gram_t ((T, B, nT, V, B, nT), t); the rows of step t
    read in place from pk_g (V, T, B, W), r0 - cb * sum_y folded into adj,
    beta_t written into beta (V, T, B, nT) at [:, t]. Returns u (V, B, nT)."""
    gram, t = gram_t
    V, T, B, W = pk_g.shape
    n_t = beta.shape[-1]
    dev = pk_g.device
    fold = (r0, cb, sum_y)
    _cuda.require(gram.is_cuda and gram.device == dev and beta.device == dev,
                  "corr_block_step: the Gram, the rows and beta must be on one CUDA device")
    _cuda.require(gram.dtype == torch.float32 and pk_g.dtype == torch.float32
                  and beta.dtype == torch.float32, "corr_block_step: float32 only")
    _cuda.require(gram.is_contiguous() and pk_g.is_contiguous() and beta.is_contiguous()
                  and W == pack_width(n_t),
                  f"corr_block_step: contiguous inputs, rows of {pack_width(n_t)} floats")
    _cuda.require(gram.shape[1:] == (B, n_t, V, B, n_t) and 0 <= t < gram.shape[0],
                  f"corr_block_step: Gram steps of shape ({B}, {n_t}, {V}, {B}, {n_t})")
    _cuda.require(beta.shape == (V, T, B, n_t) and 0 <= t < T, "corr_block_step: beta (V, T, B, nT)")
    _cuda.require(1 <= B <= 1024 and n_t >= 1, "corr_block_step: 1 <= B <= 1024")
    _cuda.require(all(a.is_cuda and a.device == dev and a.dtype == torch.float32 and a.is_contiguous()
                      for a in fold) and r0.shape == cb.shape == (V, B, n_t) and sum_y.numel() == 1,
                  "corr_block_step: r0 and the centres (V, B, nT), sum(y) one float, float32 on the card")
    u = torch.empty((V, B, n_t), dtype=torch.float32, device=dev)
    pre = torch.empty_like(u) if n_t > FAST_NT else None  # the generic form's sums
    step = gram.data_ptr() + t * B * n_t * V * B * n_t * 4
    err = lib.ngt_corr_block_step(step, pk_g.data_ptr() + 4 * t * B * W, T * B * W,
                                  *(a.data_ptr() for a in fold), beta.data_ptr() + 4 * t * B * n_t,
                                  T * B * n_t, u.data_ptr(), None if pre is None else pre.data_ptr(),
                                  V, B, n_t, _cuda.stream_of(pk_g))
    _cuda.check(err, "corr_block_step")
    return u


def corr_block_step_kernel(gram_t, pk_g, r0, cb, sum_y, beta):
    """CM1's block-step on the card: one launch."""
    u = corr_block_step_with(_cuda.lib(), gram_t, pk_g, r0, cb, sum_y, beta)
    _cuda.LAUNCHES["corr_block_scan_v"] += 1
    return u


def corr_block_step(gram_t, pk_g, r0, cb, sum_y, beta):
    """One block-step of a correlated marker set: gram_t ((T, B, nT, V, B,
    nT), t); pk_g (V, T, B, W) the sweep's packed rows; r0 (V, B, nT) K1's
    output, cb (V, B, nT) the step's centres, sum_y 0-d; beta (V, T, B, nT)
    receives beta_t at [:, t]. Returns u = bold - beta_t (V, B, nT): one CM1
    launch for CUDA tensors, the plain version for CPU tensors."""
    if pk_g.is_cuda:
        return corr_block_step_kernel(gram_t, pk_g, r0, cb, sum_y, beta)
    gram, t = gram_t
    return corr_block_step_plain(gram[t], pk_g, t, r0, cb, sum_y, beta)


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
