"""Blocked single-site Gibbs for BayesR marker effects
(sampleBayesR!, NextGP.jl functions.jl:238-289).

Counterpart of `nextgp_tpu/engine/samplers/markers.py` (`_blocked_sweep`,
`_sweep_r`, `sample_marker_set`) for packed storage and the one (T, V, B, q)
layout. Each block-step t touches the residual twice, through the packed
passes of ops/pack2.py:

    r0 = Mc_t @ ycorr          (gather, K1)
    scan the V blocks' B loci  (ops/gibbs_kernels.r_block_scan_v, K3)
    ycorr += u @ Mc_t          (scatter, K2)

and the in-block chain stays exact through the centered Gram blocks (see
the JAX module's docstring for the algebra). V block chains advance per
step: chain v owns the contiguous blocks [v*T, (v+1)*T), and the residual
synchronizes between steps. The residual is carried padded to n4 = 4q; the
padded entries are genotype 0 and stay pinned at zero, so sums and gathers
over the padded vector equal the unpadded ones.

All randomness is drawn per sweep up front from the marker set's site and
consumed by position, so an injected stream reproduces the JAX chain.
"""
from __future__ import annotations

import torch

from ...ops import gibbs_kernels, pack2
from ...ops.dists import sample_chi2, sample_dirichlet
from ...utils import replace
from ..plan import METHOD_R, MarkerPlan


def _blocked_sweep(ms, ycorr, pk, n_classes):
    """Run every block-step of one marker set.

    pk: (p_pad, W) per-locus coefficient rows in global locus order.
    Returns (ycorr, beta (p_pad,), delta (p_pad,)) with beta and delta in
    global flat locus order.
    """
    T, V, B, q = ms.mt.shape
    n = ycorr.shape[0]
    y = torch.zeros(4 * q, dtype=ycorr.dtype, device=ycorr.device)
    y[:n] = ycorr
    mt_rows = ms.mt.view(T * V * B, q)
    rows = V * B
    # (nb, B, W) in global block order g = v*T + t  ->  per step (V, B, W)
    pk_g = pk.view(V, T, B, -1)
    beta = torch.empty((V, T, B), dtype=ycorr.dtype, device=ycorr.device)
    delta = torch.empty((V, T, B), dtype=torch.int32, device=ycorr.device)
    for t in range(T):
        cb = ms.center[t]  # (V, B)
        r0 = pack2.matvec_step(mt_rows, t, pack2.y_planar(y), rows).view(V, B) - cb * y.sum()
        pk_t = pk_g[:, t].clone()
        pk_t[:, :, 0] += r0
        beta_t, u, delta_t = gibbs_kernels.r_block_scan_v((ms.gram, t), pk_t, n_classes)
        corr = pack2.rank_update_step(mt_rows, t, u.reshape(-1)).reshape(-1) - (u * cb).sum()
        y[:n] += corr[:n]  # the padded entries stay zero
        beta[:, t] = beta_t
        delta[:, t] = delta_t
    return y[:n], beta.reshape(-1), delta.reshape(-1)


def _sweep_r(stream, site, ms, mp: MarkerPlan, ycorr, var_e):
    """sampleBayesR! (functions.jl:238-289)."""
    sz, su, sv, sp = site.split(4)
    K = mp.n_classes
    z = stream.normal(sz, (mp.p_pad,))
    unif = stream.uniform(su, (mp.p_pad,))
    ive = 1.0 / var_e
    varc = ms.var_beta[0] * ms.v_class  # (K,) (functions.jl:244)
    pk = gibbs_kernels.r_block_pack(
        ms.beta, z, unif, ms.mpm.reshape(-1), ms.lhs_ss.reshape(-1), ms.rhs_ss.reshape(-1),
        ms.mask.reshape(-1), varc, ms.log_pi, ive, var_e)
    ycorr, beta, delta = _blocked_sweep(ms, ycorr, pk, K)

    cls0 = torch.clamp(delta - 1, 0, K - 1).long()
    vsel = ms.v_class[cls0]
    active = (delta > 0) & (vsel > 0)
    one = torch.ones((), dtype=beta.dtype, device=beta.device)
    sum_s = torch.where(active, beta * beta / torch.where(active, vsel, one), 0.0).sum()
    n_nz = active.sum().to(beta.dtype)
    var_beta = ((ms.scale * mp.df + sum_s) / sample_chi2(stream, sv, mp.df + n_nz)).reshape(1)

    out = replace(ms, beta=beta, delta=delta, var_beta=var_beta.to(ms.var_beta.dtype))
    if mp.est_pi:  # Dirichlet(nLoci .+ 1) (functions.jl:536-538)
        classes = torch.arange(1, K + 1, device=delta.device, dtype=delta.dtype)
        counts = (delta[:, None] == classes[None, :]).to(beta.dtype).sum(dim=0)
        pi_hat = sample_dirichlet(stream, sp, counts + 1.0)
        out = replace(out, pi_hat=pi_hat, log_pi=torch.log(pi_hat))
    return out, ycorr


def sample_marker_set(stream, site, ms, mp: MarkerPlan, ycorr, var_e):
    if mp.method == METHOD_R:
        return _sweep_r(stream, site, ms, mp, ycorr, var_e)
    raise NotImplementedError(f"marker method {mp.method} is not ported yet")
