"""The in-block single-site Gibbs scans, V chains at a time.

Counterpart of `nextgp_tpu/ops/gibbs_kernels.py` for the methods the port
carries. Per method, a coefficient pack (a plain tensor function in both
packages) and a sequential scan with a plain PyTorch version and a CUDA
kernel:

    BayesR       r_block_pack      r_block_scan_v     K3, csrc/r_scan.cu
    BayesPR      gauss_block_pack  gauss_block_scan_v K6, csrc/gauss_bc_scan.cu
    BayesB/C     bc_block_pack     bc_block_scan_v    K8, csrc/gauss_bc_scan.cu
    BayesB/C+D   bc_block_pack     bc_block_scan_wv   K10, csrc/gauss_bc_scan.cu

V=1 is each scan's single-chain form (`r_block_scan`, `gauss_block_scan`,
`bc_block_scan`, `bc_block_scan_w` in the JAX package).

Everything per locus that does not depend on the chain state is computed
up front by the pack, so one locus of a scan costs one Gram-row dot product
(two for the weighted B/C scan) and a few scalar steps (see the JAX module's
docstring for the algebra). Packed coefficient rows:
    gauss (8):     [adj, bold, b, c, pad*4]
    bc (8):        [adj, bold, q0, q1, w, b, c, adj_raw]
    r (8 + 4K):    [adj, bold, unif, mask, pad*4 | q0(K), q1(K), b(K), c(K)]
The caller adds r0 to slot 0 per block (the restore of beta_old is folded
into `adj`), and for the weighted B/C scan the raw r0 to slot 7. Unlike the
JAX packs, which always emit float32, the packs here keep their input's
dtype.
"""
from __future__ import annotations

import torch

from . import _cuda
from .dists import categorical_from_probs

MAX_CLASSES = 16  # the kernel's per-thread class buffer


def _pack8(*cols):
    pk = torch.stack(cols, dim=1)
    pad = 8 - pk.shape[1]
    return torch.cat([pk, pk.new_zeros((pk.shape[0], pad))], dim=1) if pad else pk


def gauss_block_pack(r0_extra, beta_old, z, ivb, mpm, lss, rss, mask, ive):
    """Gaussian (BayesPR) coefficients for all p loci -> (p, 8):
    beta = c + b * pre. r0_extra: an additive offset already known before
    the sweep."""
    lhs = mpm * ive + lss + ivb
    invlhs = 1.0 / lhs
    zero = torch.zeros((), dtype=beta_old.dtype, device=beta_old.device)
    b = torch.where(mask, ive * invlhs, zero)
    c = torch.where(mask, rss * invlhs + z * torch.sqrt(invlhs), zero)
    return _pack8(r0_extra + mpm * beta_old, beta_old, b, c)


def bc_block_pack(beta_old, z, unif, vb, ivb, mpm, lss, rss, mask, ive, var_e, lp0, lp1, common,
                  mpm_raw=None):
    """BayesB/C coefficients -> (p, 8). The indicator u < 1/(1+exp(ld0-ld1))
    becomes q0 + q1*rrr^2 < w = log((1-u)/u) (functions.jl:171-173). Padded
    loci get q0 = +inf and are never included; vb = 0 gives ivb = inf and so
    b = c = 0. mpm_raw (weighted models only): the raw m'm diagonal; slot 7
    then carries the raw restore mpm_raw * beta_old."""
    one = torch.ones((), dtype=beta_old.dtype, device=beta_old.device)
    mpm_safe = torch.where(mask, mpm, one)
    v0 = mpm_safe * var_e
    v1 = mpm_safe * mpm_safe * vb + v0
    q0 = -0.5 * (torch.log(v0) - torch.log(v1)) + lp0 - lp1
    q0 = torch.where(mask, q0, torch.full_like(q0, float("inf")))
    q1 = -0.5 * (1.0 / v0 - 1.0 / v1)
    w = torch.log1p(-unif) - torch.log(unif)
    lhs = mpm_safe * ive + lss + ivb
    invlhs = 1.0 / lhs
    b = ive * invlhs
    rss_eff = 0.0 if common else rss  # BayesC omits rhs_ss (functions.jl:219)
    c = rss_eff * invlhs + z * torch.sqrt(invlhs)
    cols = (mpm * beta_old, beta_old, q0, q1, w, b, c)
    if mpm_raw is not None:
        cols = cols + (mpm_raw * beta_old,)
    return _pack8(*cols)


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


def gauss_block_scan_v_plain(gram, pk):
    """Plain version of the Gaussian scan. gram (B, V, B) locus-major,
    pk (V, B, 8) -> beta (V, B), u (V, B)."""
    V, B, _ = pk.shape
    u = torch.zeros((V, B), dtype=pk.dtype, device=pk.device)
    beta = torch.zeros_like(u)
    for j in range(B):
        s = pk[:, j]
        pre = s[:, 0] + (gram[j] * u).sum(-1)
        bnew = s[:, 3] + s[:, 2] * pre
        beta[:, j] = bnew
        u[:, j] = s[:, 1] - bnew
    return beta, u


def _bc_plain(gram, graw, pk):
    V, B, _ = pk.shape
    u = torch.zeros((V, B), dtype=pk.dtype, device=pk.device)
    beta = torch.zeros_like(u)
    delta = torch.zeros((V, B), dtype=torch.int32, device=pk.device)
    zero = torch.zeros((), dtype=pk.dtype, device=pk.device)
    for j in range(B):
        s = pk[:, j]
        pre = s[:, 0] + (gram[j] * u).sum(-1)
        prer = pre if graw is None else s[:, 7] + (graw[j] * u).sum(-1)
        inc = s[:, 2] + s[:, 3] * prer * prer < s[:, 4]
        bnew = torch.where(inc, s[:, 6] + s[:, 5] * pre, zero)
        beta[:, j] = bnew
        u[:, j] = s[:, 1] - bnew
        delta[:, j] = inc.to(torch.int32)
    return beta, u, delta


def bc_block_scan_v_plain(gram, pk):
    """Plain version of the B/C scan. gram (B, V, B), pk (V, B, 8) ->
    beta (V, B), u (V, B), delta (V, B) int32 (1 = included)."""
    return _bc_plain(gram, None, pk)


def bc_block_scan_wv_plain(gram, graw, pk):
    """Plain version of the weighted B/C scan: the weighted Gram gram sets
    beta, the raw Gram graw (with slot 7) decides the indicator."""
    return _bc_plain(gram, graw, pk)


def _launch(name, entry, grams, pk, width, with_delta, *extra):
    """Launch one V-batched scan kernel. grams: the step-indexed
    ((T, B, V, B), t) pairs the kernel reads; returns beta, u[, delta]."""
    tensors = [g for g, _ in grams] + [pk]
    _cuda.require(all(x.is_cuda and x.device == pk.device for x in tensors),
                  f"{name}: gram and pk must be on one CUDA device")
    _cuda.require(all(x.dtype == torch.float32 for x in tensors),
                  f"{name}: gram and pk must be float32")
    _cuda.require(all(x.is_contiguous() for x in tensors), f"{name}: gram and pk must be contiguous")
    T, B, V, B2 = grams[0][0].shape
    _cuda.require(B == B2 and all(g.shape == (T, B, V, B) and 0 <= t < T for g, t in grams),
                  f"{name}: gram must be (T, B, V, B) and 0 <= t < T")
    _cuda.require(pk.shape == (V, B, width), f"{name}: pk must be ({V}, {B}, {width})")
    _cuda.require(B <= 1024, f"{name}: needs B <= 1024")
    _cuda.require(4 * (B + 64 + B * width) <= 227 * 1024,
                  f"{name}: coefficient rows of B={B}, width {width} exceed shared memory")
    beta = torch.empty((V, B), dtype=torch.float32, device=pk.device)
    u = torch.empty_like(beta)
    outs = [beta, u]
    if with_delta:
        outs.append(torch.empty((V, B), dtype=torch.int32, device=pk.device))
    ptrs = [g.data_ptr() + t * B * V * B * 4 for g, t in grams]
    err = entry(_cuda.lib())(*ptrs, pk.data_ptr(), *(o.data_ptr() for o in outs), V, B, *extra,
                             _cuda.stream_of(pk))
    _cuda.check(err, f"gibbs_kernels.{name}")
    _cuda.LAUNCHES[name] += 1
    return tuple(outs)


def _step(gram_t, on_cuda):
    """(gram, t) for a locus-major (B, V, B) block or a step-indexed pair:
    the kernels take the pair (a single block is step 0 of a one-step
    array), the plain versions a (B, V, B) block."""
    gram, t = gram_t if isinstance(gram_t, tuple) else (gram_t, None)
    if on_cuda:
        return (gram[None], 0) if t is None else (gram, t)
    return gram if t is None else gram[t]


def r_block_scan_v(gram_t, pk, n_classes):
    """V-batched BayesR scan (K3). gram_t is the locus-major (B, V, B) Gram
    block or the step-indexed pair ((T, B, V, B), t); pk (V, B, 8 + 4K).
    Returns beta (V, B), u (V, B), delta (V, B) int32."""
    K = n_classes
    if pk.is_cuda:
        _cuda.require(1 <= K <= MAX_CLASSES, f"r_block_scan_v: needs K <= {MAX_CLASSES}")
        return _launch("r_block_scan_v", lambda L: L.ngt_r_block_scan_v, [_step(gram_t, True)],
                       pk, 8 + 4 * K, True, K)
    return r_block_scan_v_plain(_step(gram_t, False), pk, K)


def gauss_block_scan_v(gram_t, pk):
    """V-batched Gaussian scan (K6), BayesPR. gram_t as for r_block_scan_v;
    pk (V, B, 8). Returns beta (V, B), u (V, B)."""
    if pk.is_cuda:
        return _launch("gauss_block_scan_v", lambda L: L.ngt_gauss_block_scan_v,
                       [_step(gram_t, True)], pk, 8, False)
    return gauss_block_scan_v_plain(_step(gram_t, False), pk)


def bc_block_scan_v(gram_t, pk):
    """V-batched BayesB/C scan (K8). Returns beta, u, delta (V, B)."""
    if pk.is_cuda:
        return _launch("bc_block_scan_v", lambda L: L.ngt_bc_block_scan_v, [_step(gram_t, True)],
                       pk, 8, True)
    return bc_block_scan_v_plain(_step(gram_t, False), pk)


def bc_block_scan_wv(gram_t, graw_t, pk):
    """V-batched weighted BayesB/C scan (K10): two Gram streams, the
    weighted gram_t and the raw graw_t, each a (B, V, B) block or a
    step-indexed pair. Returns beta, u, delta (V, B)."""
    if pk.is_cuda:
        return _launch("bc_block_scan_wv", lambda L: L.ngt_bc_block_scan_wv,
                       [_step(gram_t, True), _step(graw_t, True)], pk, 8, True)
    return bc_block_scan_wv_plain(_step(gram_t, False), _step(graw_t, False), pk)
