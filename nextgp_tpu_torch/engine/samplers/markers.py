"""Blocked single-site Gibbs for marker effects: BayesPR, BayesB, BayesC
and BayesR, with a plain or a weighted ("D") residual
(sampleBayesPR!/B!/C!/R!, NextGP.jl functions.jl:118-289).

Counterpart of `nextgp_tpu/engine/samplers/markers.py` (`_blocked_sweep`,
`_gauss_effect_sweep`, `_sweep_pr`, `_sweep_bc`, `_sweep_r`,
`sample_marker_set`) for packed storage and the one (T, V, B, q) layout.
Each block-step t touches the residual through the packed passes of
ops/pack2.py:

    r0 = Mc_t @ (d_inv * ycorr)  (gather, K1; d_inv = 1 unweighted)
    r0_raw = Mc_t @ ycorr        (a second gather, weighted B/C only)
    scan the V blocks' B loci    (ops/gibbs_kernels, K3 / K6 / K8 / K10)
    ycorr += u @ Mc_t            (scatter, K2)

and the in-block chain stays exact through the centered Gram blocks (see
the JAX module's docstring for the algebra); a weighted model keeps the
weighted Gram for rhs and the raw one for B/C's indicator. V block chains
advance per step: chain v owns the contiguous blocks [v*T, (v+1)*T), and the
residual synchronizes between steps. The residual is carried padded to
n4 = 4q; the padded entries are genotype 0 and stay pinned at zero (d_inv
is padded with zeros), so sums and gathers over the padded vectors equal
the unpadded ones. ycorr is the raw residual in every model.

All randomness is drawn per sweep up front from the marker set's site and
consumed by position, so an injected stream reproduces the JAX chain.
"""
from __future__ import annotations

import torch

from ...ops import gibbs_kernels, pack2
from ...ops.dists import sample_beta_dist, sample_chi2, sample_dirichlet
from ...utils import replace
from ..plan import METHOD_B, METHOD_C, METHOD_PR, METHOD_R, MarkerPlan


def _padded(v, n4):
    out = v.new_zeros(n4)
    out[:v.shape[0]] = v
    return out


def _blocked_sweep(ms, ycorr, pk, scan, d_inv=None, need_raw=False):
    """Run every block-step of one marker set.

    pk: (p_pad, 8 or 8 + 4K) per-locus coefficient rows in global locus
    order. scan(t, pk_t) runs step t's V blocks and returns (beta (V, B),
    u (V, B), delta (V, B) int32 or None). d_inv: (n,) inverse residual
    weights of a weighted model; need_raw adds the raw r0 to slot 7 of the
    rows (weighted B/C). Returns (ycorr, beta (p_pad,), delta (p_pad,) or
    None) with beta and delta in global flat locus order.
    """
    T, V, B, q = ms.mt.shape
    n = ycorr.shape[0]
    y = _padded(ycorr, 4 * q)
    dw = None if d_inv is None else _padded(d_inv, 4 * q)
    mt_rows = ms.mt.view(T * V * B, q)
    rows = V * B
    # (nb, B, W) in global block order g = v*T + t  ->  per step (V, B, W)
    pk_g = pk.view(V, T, B, -1)
    beta = torch.empty((V, T, B), dtype=ycorr.dtype, device=ycorr.device)
    delta = None

    def gather(t, yv, cb):
        return pack2.matvec_step(mt_rows, t, pack2.y_planar(yv), rows).view(V, B) - cb * yv.sum()

    for t in range(T):
        cb = ms.center[t]  # (V, B)
        pk_t = pk_g[:, t].clone()
        pk_t[:, :, 0] += gather(t, y if dw is None else dw * y, cb)
        if need_raw and dw is not None:
            pk_t[:, :, 7] += gather(t, y, cb)
        beta_t, u, delta_t = scan(t, pk_t)
        corr = pack2.rank_update_step(mt_rows, t, u.reshape(-1)).reshape(-1) - (u * cb).sum()
        y[:n] += corr[:n]  # the padded entries stay zero
        beta[:, t] = beta_t
        if delta_t is not None:
            if delta is None:
                delta = torch.empty((V, T, B), dtype=torch.int32, device=ycorr.device)
            delta[:, t] = delta_t
    return y[:n], beta.reshape(-1), None if delta is None else delta.reshape(-1)


def _gram_raw_diag(ms):
    """Raw per-locus m'm (the diagonal of gram_raw) in global flat locus
    order: the weighted B/C scan's raw restore (functions.jl:168)."""
    d = torch.diagonal(ms.gram_raw, dim1=1, dim2=3)  # (T, B, V, B) -> (T, V, B)
    return d.transpose(0, 1).reshape(-1)  # global block g = v*T + t


def _region_sum(mp: MarkerPlan, x):
    """Per-region sums of x (p_pad,) over the loci < p, without float
    atomics: a fixed order grouped by region (mp.region_order, stable),
    summed segment by segment, so the result is the same on every run."""
    if mp.n_var == 1:
        return x[:mp.p].sum().reshape(1)
    return torch.segment_reduce(x[:mp.p][mp.region_order], "sum", lengths=mp.region_len)


# ------------------------------------------------------------------ BayesPR


def _gauss_effect_sweep(ms, mp: MarkerPlan, ycorr, var_e, d_inv, z, ivb_locus):
    """Gaussian effect update (functions.jl:118-134). Returns (ycorr, beta)."""
    ive = 1.0 / var_e
    pk = gibbs_kernels.gauss_block_pack(
        torch.zeros_like(ms.beta), ms.beta, z, ivb_locus, ms.mpm.reshape(-1),
        ms.lhs_ss.reshape(-1), ms.rhs_ss.reshape(-1), ms.mask.reshape(-1), ive)

    def scan(t, pk_t):
        return (*gibbs_kernels.gauss_block_scan_v((ms.gram, t), pk_t), None)

    ycorr, beta, _ = _blocked_sweep(ms, ycorr, pk, scan, d_inv)
    return ycorr, beta


def _sweep_pr(stream, site, ms, mp: MarkerPlan, ycorr, var_e, d_inv):
    """sampleBayesPR! (functions.jl:118-137)."""
    sz, sv = site.split(2)
    z = stream.normal(sz, (mp.p_pad,))
    inf = torch.full_like(ms.var_beta, float("inf"))
    ivb = torch.where(ms.var_beta > 0, 1.0 / ms.var_beta, inf)
    ivb_locus = ivb[torch.clamp(ms.region_id, 0, mp.n_var - 1).long()]
    ycorr, beta = _gauss_effect_sweep(ms, mp, ycorr, var_e, d_inv, z, ivb_locus)

    # region variance update (functions.jl:135, sampleVarBetaPR :509-511)
    ss = _region_sum(mp, beta * beta)
    sizes = mp.region_len.to(beta.dtype)
    var_beta = (ms.scale * mp.df + ss) / sample_chi2(stream, sv, mp.df + sizes)
    return replace(ms, beta=beta, var_beta=var_beta.to(ms.var_beta.dtype)), ycorr


# ------------------------------------------------------------------ BayesB / BayesC


def _sweep_bc(stream, site, ms, mp: MarkerPlan, ycorr, var_e, d_inv, common: bool):
    """sampleBayesB! (functions.jl:157-195) / sampleBayesC! (:197-236)."""
    kz, ku, kv, kp = site.split(4)
    z = stream.normal(kz, (mp.p_pad,))
    unif = stream.uniform(ku, (mp.p_pad,))
    ive = 1.0 / var_e
    vb_locus = ms.var_beta[0].expand(mp.p_pad) if common else ms.var_beta
    ivb_locus = torch.where(vb_locus > 0, 1.0 / vb_locus, torch.full_like(vb_locus, float("inf")))
    weighted = d_inv is not None
    pk = gibbs_kernels.bc_block_pack(
        ms.beta, z, unif, vb_locus, ivb_locus, ms.mpm.reshape(-1), ms.lhs_ss.reshape(-1),
        ms.rhs_ss.reshape(-1), ms.mask.reshape(-1), ive, var_e, ms.log_pi[0], ms.log_pi[1],
        common, mpm_raw=_gram_raw_diag(ms) if weighted else None)

    # weighted "D": the weighted Gram drives rhs, the raw Gram the
    # indicator's rrr (functions.jl:168; mme.jl:71-75)
    def scan(t, pk_t):
        if weighted:
            return gibbs_kernels.bc_block_scan_wv((ms.gram, t), (ms.gram_raw, t), pk_t)
        return gibbs_kernels.bc_block_scan_v((ms.gram, t), pk_t)

    ycorr, beta, delta = _blocked_sweep(ms, ycorr, pk, scan, d_inv, need_raw=True)
    n_in = delta.sum().to(beta.dtype)

    if common:
        ss = torch.dot(beta, beta)  # all loci incl. zeros (functions.jl:230)
        var_beta = ((ms.scale * mp.df + ss) / sample_chi2(stream, kv, mp.df + n_in)).reshape(1)
    else:
        chi = sample_chi2(stream, kv, torch.full_like(beta, mp.df + 1.0))
        vb = (ms.scale * mp.df + beta * beta) / chi  # per locus (functions.jl:182)
        var_beta = torch.where(delta == 1, vb, torch.zeros_like(vb))

    out = replace(ms, beta=beta, delta=delta, var_beta=var_beta.to(ms.var_beta.dtype))
    if mp.est_pi:  # samplePi Beta(nIn+1, nTotal-nIn+1) (functions.jl:531-533)
        pi_in = sample_beta_dist(stream, kp, n_in + 1.0, mp.p - n_in + 1.0)
        pi_hat = torch.stack([1.0 - pi_in, pi_in])
        out = replace(out, pi_hat=pi_hat, log_pi=torch.log(pi_hat))
    return out, ycorr


# ------------------------------------------------------------------ BayesR


def _sweep_r(stream, site, ms, mp: MarkerPlan, ycorr, var_e, d_inv):
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

    def scan(t, pk_t):
        return gibbs_kernels.r_block_scan_v((ms.gram, t), pk_t, K)

    ycorr, beta, delta = _blocked_sweep(ms, ycorr, pk, scan, d_inv)

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


# ------------------------------------------------------------------ dispatch


def sample_marker_set(stream, site, ms, mp: MarkerPlan, ycorr, var_e, d_inv=None):
    if mp.method == METHOD_PR:
        return _sweep_pr(stream, site, ms, mp, ycorr, var_e, d_inv)
    if mp.method == METHOD_B:
        return _sweep_bc(stream, site, ms, mp, ycorr, var_e, d_inv, False)
    if mp.method == METHOD_C:
        return _sweep_bc(stream, site, ms, mp, ycorr, var_e, d_inv, True)
    if mp.method == METHOD_R:
        return _sweep_r(stream, site, ms, mp, ycorr, var_e, d_inv)
    raise NotImplementedError(f"marker method {mp.method} is not ported yet")
