"""The BayesR in-block single-site Gibbs scan, V chains at a time.

Counterpart of `nextgp_tpu/ops/gibbs_kernels.py` for the slice the port
carries: `r_block_pack` (per-locus coefficients, a plain tensor function in
both packages) and `r_block_scan_v` (the sequential scan: a plain PyTorch
version and the CUDA kernel K3, csrc/r_scan.cu). V=1 is the single-chain
scan (`r_block_scan` in the JAX package).

Everything per locus that does not depend on the chain state is computed
up front by `r_block_pack`, so one locus of the scan costs one Gram-row dot
product and a few scalar steps (see the JAX module's docstring for the
algebra). Packed coefficient rows, width 8 + 4K:
    [adj, bold, unif, mask, pad*4 | q0(K), q1(K), b(K), c(K)]
The caller adds r0 to slot 0 per block (the restore of beta_old is folded
into `adj`).
"""
from __future__ import annotations

import torch

from . import _cuda
from .dists import categorical_from_probs

MAX_CLASSES = 16  # the kernel's per-thread class buffer


def r_block_pack(beta_old, z, unif, mpm, lss, rss, mask, varc, logpi, ive, var_e):
    """BayesR coefficients for all p loci -> (p, 8 + 4K) in beta_old's dtype:
    logl_k = q0_k + q1_k * pre^2, beta = c_k + b_k * pre, with rss folded
    into the additive slot (rhs = (r0 + dot + mpm*bold + rss*varE) * iVarE)."""
    dtype = beta_old.dtype
    nz = varc > 0
    one = torch.ones((), dtype=dtype, device=beta_old.device)
    zero = torch.zeros((), dtype=dtype, device=beta_old.device)
    varc_s = torch.where(nz, varc, one)
    mpm_safe = torch.where(mask, mpm, one)
    lhs = torch.where(nz[None, :], mpm_safe[:, None] * ive + lss[:, None] + 1.0 / varc_s[None, :], zero)
    lhs_s = torch.where(nz[None, :], lhs, one)
    invlhs = torch.where(nz[None, :], 1.0 / lhs_s, zero)
    q0 = torch.where(nz[None, :], -0.5 * torch.log(varc_s[None, :] * lhs_s), zero) + logpi[None, :]
    q1 = 0.5 * invlhs * ive * ive
    bco = torch.where(mask[:, None], ive * invlhs, zero)
    cco = torch.where(mask[:, None], z[:, None] * torch.sqrt(invlhs), zero)
    adj = mpm * beta_old + rss * var_e
    head = torch.stack([adj, beta_old, unif, mask.to(dtype)], dim=1)
    pad = torch.zeros((beta_old.shape[0], 4), dtype=dtype, device=beta_old.device)
    return torch.cat([head, pad, q0, q1, bco, cco], dim=1)


def r_block_scan_v_plain(gram, pk, n_classes):
    """Plain version of the scan. gram (B, V, B) locus-major, pk (V, B, W)
    -> beta (V, B), u (V, B), delta (V, B) int32."""
    K = n_classes
    V, B, _ = pk.shape
    u = torch.zeros((V, B), dtype=pk.dtype, device=pk.device)
    beta = torch.zeros_like(u)
    delta = torch.zeros((V, B), dtype=torch.int32, device=pk.device)
    for j in range(B):
        s = pk[:, j]  # (V, W)
        pre = s[:, 0] + (gram[j] * u).sum(-1)
        logl = s[:, 8:8 + K] + s[:, 8 + K:8 + 2 * K] * (pre * pre)[:, None]
        logl = logl - logl.max(dim=-1, keepdim=True).values
        e = torch.exp(logl)
        cls = categorical_from_probs(s[:, 2], e / e.sum(dim=-1, keepdim=True)).long()
        bco = s[:, 8 + 2 * K:8 + 3 * K].gather(1, cls[:, None])[:, 0]
        cco = s[:, 8 + 3 * K:8 + 4 * K].gather(1, cls[:, None])[:, 0]
        bnew = cco + bco * pre
        beta[:, j] = bnew
        u[:, j] = s[:, 1] - bnew
        delta[:, j] = torch.where(s[:, 3] != 0, cls + 1, 0).to(torch.int32)
    return beta, u, delta


def _scan_kernel(gram_all, t, pk, K):
    name = "gibbs_kernels.r_block_scan_v"
    _cuda.require(gram_all.is_cuda and pk.device == gram_all.device,
                  f"{name}: gram and pk must be on one CUDA device")
    _cuda.require(gram_all.dtype == torch.float32 and pk.dtype == torch.float32,
                  f"{name}: gram and pk must be float32")
    _cuda.require(gram_all.is_contiguous() and pk.is_contiguous(),
                  f"{name}: gram and pk must be contiguous")
    T, B, V, B2 = gram_all.shape
    _cuda.require(B == B2 and 0 <= t < T, f"{name}: gram must be (T, B, V, B) and 0 <= t < T")
    _cuda.require(pk.shape == (V, B, 8 + 4 * K), f"{name}: pk must be ({V}, {B}, {8 + 4 * K})")
    _cuda.require(1 <= K <= MAX_CLASSES and B <= 1024, f"{name}: needs K <= {MAX_CLASSES}, B <= 1024")
    _cuda.require(4 * (B + 32 + B * (8 + 4 * K)) <= 227 * 1024,
                  f"{name}: coefficient rows of B={B}, K={K} exceed shared memory")
    L = _cuda.lib()
    beta = torch.empty((V, B), dtype=torch.float32, device=pk.device)
    u = torch.empty_like(beta)
    delta = torch.empty((V, B), dtype=torch.int32, device=pk.device)
    err = L.ngt_r_block_scan_v(gram_all.data_ptr() + t * B * V * B * 4, pk.data_ptr(),
                               beta.data_ptr(), u.data_ptr(), delta.data_ptr(), V, B, K,
                               _cuda.stream_of(pk))
    _cuda.check(err, name)
    _cuda.LAUNCHES["r_block_scan_v"] += 1
    return beta, u, delta


def r_block_scan_v(gram_t, pk, n_classes):
    """V-batched BayesR scan. gram_t is the locus-major (B, V, B) Gram block
    or the step-indexed pair ((T, B, V, B), t); pk (V, B, 8 + 4K).
    Returns beta (V, B), u (V, B), delta (V, B) int32."""
    gram, t = gram_t if isinstance(gram_t, tuple) else (gram_t, None)
    if pk.is_cuda:
        if t is None:
            gram, t = gram[None], 0
        return _scan_kernel(gram, t, pk, n_classes)
    return r_block_scan_v_plain(gram if t is None else gram[t], pk, n_classes)
