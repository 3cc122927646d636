"""Blocked single-site Gibbs for marker effects: BayesPR, BayesB, BayesC,
BayesR, BayesRCpi, BayesRCplus and BayesLV, with a plain or a weighted ("D")
residual (sampleBayesPR!/B!/C!/R!/RCpi!/RCplus!/LV!, NextGP.jl
functions.jl:118-486), and correlated marker sets (functions.jl:140-154).

Counterpart of `nextgp_tpu/engine/samplers/markers.py` (`_blocked_sweep`,
`_gauss_effect_sweep`, `_sweep_pr`, `_sweep_bc`, `_sweep_r`, `_sweep_rcpi`,
`_sweep_rcplus`, `_sweep_lv`, `sample_marker_set`,
`sample_corr_marker_set`) for packed storage and the one (T, V, B, q)
layout.
Each block-step t touches the residual through the packed passes of
ops/pack2.py:

    r0 = Mc_t @ (d_inv * ycorr)  (gather, K1; d_inv = 1 unweighted)
    r0_raw = Mc_t @ ycorr        (a second gather, weighted B/C only)
    scan the V blocks' B loci    (ops/gibbs_kernels, K3 / K6 / K8 / K10 / K12 / K14)
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

from ...ops import corr_scan, gibbs_kernels, pack2
from ...ops.dists import (
    sample_beta_dist, sample_chi2, sample_dirichlet, sample_inv_wishart_split,
)
from ...utils import replace
from ..plan import (
    METHOD_B, METHOD_C, METHOD_LV, METHOD_PR, METHOD_R, METHOD_RCPI, METHOD_RCPLUS, CorrMarkerPlan,
    MarkerPlan,
)


def _padded(v, n4):
    out = v.new_zeros(n4)
    out[:v.shape[0]] = v
    return out


def _blocked_sweep(ms, ycorr, pk, scan, d_inv=None, need_raw=False):
    """Run every block-step of one marker set.

    pk: (p_pad, W) per-locus coefficient rows in global locus order.
    scan(t, pk_t) runs step t's V blocks and returns (beta (V, B), u (V, B),
    *more), each further output (V, B, ...) per locus (delta, and what the
    annotation scans add). d_inv: (n,) inverse residual weights of a
    weighted model; need_raw adds the raw r0 to slot 7 of the rows
    (weighted B/C). Returns (ycorr, beta (p_pad,), more) with beta and every
    further output (p_pad, ...) in global flat locus order.
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
    more = None

    def gather(t, yv, cb):
        return pack2.matvec_step(mt_rows, t, pack2.y_planar(yv), rows).view(V, B) - cb * yv.sum()

    for t in range(T):
        cb = ms.center[t]  # (V, B)
        pk_t = pk_g[:, t].clone()
        pk_t[:, :, 0] += gather(t, y if dw is None else dw * y, cb)
        if need_raw and dw is not None:
            pk_t[:, :, 7] += gather(t, y, cb)
        beta_t, u, *more_t = scan(t, pk_t)
        corr = pack2.rank_update_step(mt_rows, t, u.reshape(-1)).reshape(-1) - (u * cb).sum()
        y[:n] += corr[:n]  # the padded entries stay zero
        beta[:, t] = beta_t
        if more is None:
            more = [x.new_empty((V, T) + x.shape[1:]) for x in more_t]
        for buf, x in zip(more, more_t):
            buf[:, t] = x
    return y[:n], beta.reshape(-1), tuple(x.reshape((V * T * B,) + x.shape[3:]) for x in more)


def _gram_raw_diag(ms):
    """Raw per-locus m'm (the diagonal of gram_raw) in global flat locus
    order: the weighted B/C scan's raw restore (functions.jl:168)."""
    d = torch.diagonal(ms.gram_raw, dim1=1, dim2=3)  # (T, B, V, B) -> (T, V, B)
    return d.transpose(0, 1).reshape(-1)  # global block g = v*T + t


def _region_sum(mp: MarkerPlan, x):
    """Per-region sums of x (p_pad,) over the loci < p, without float
    atomics or a host sync (a sweep captured in a CUDA graph runs it): each
    region's loci gathered into a row of mp.region_rows (padding reads an
    appended zero) and the rows summed, in a fixed order, so the result is
    the same on every run."""
    if mp.n_var == 1:
        return x[:mp.p].sum().reshape(1)
    return torch.cat([x[:mp.p], x.new_zeros(1)])[mp.region_rows].sum(dim=1)


# ------------------------------------------------------------------ BayesPR


def _gauss_effect_sweep(ms, mp: MarkerPlan, ycorr, var_e, d_inv, z, ivb_locus):
    """Gaussian effect update (functions.jl:118-134). Returns (ycorr, beta)."""
    ive = 1.0 / var_e
    pk = gibbs_kernels.gauss_block_pack(
        torch.zeros_like(ms.beta), ms.beta, z, ivb_locus, ms.mpm.reshape(-1),
        ms.lhs_ss.reshape(-1), ms.rhs_ss.reshape(-1), ms.mask.reshape(-1), ive)

    def scan(t, pk_t):
        return gibbs_kernels.gauss_block_scan_v((ms.gram, t), pk_t)

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

    ycorr, beta, (delta,) = _blocked_sweep(ms, ycorr, pk, scan, d_inv, need_raw=True)
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

    ycorr, beta, (delta,) = _blocked_sweep(ms, ycorr, pk, scan, d_inv)

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


# ------------------------------------------------------------------ BayesRCpi / BayesRCplus


def _annot_variances(stream, site, ms, mp: MarkerPlan, contrib, n_nz):
    """Per-annotation variance draw from the (p_pad, A) contributions
    beta^2 / v_class and the (p_pad, A) counts of non-null draws. The sums
    over loci are plain reductions along the locus axis (a fixed order, no
    float atomics)."""
    chi = sample_chi2(stream, site, mp.df + n_nz.sum(dim=0).to(contrib.dtype))
    return ((ms.scale * mp.df + contrib.sum(dim=0)) / chi).to(ms.var_beta.dtype)


def _annot_pi(stream, site, ms, joint):
    """Per-annotation Dirichlet over the class counts (functions.jl:352-357);
    joint (p_pad, A, K) bool."""
    pi_hat = sample_dirichlet(stream, site, joint.sum(dim=0).to(ms.beta.dtype) + 1.0)
    return dict(pi_hat=pi_hat, log_pi=torch.log(pi_hat))


def _sweep_rcpi(stream, site, ms, mp: MarkerPlan, ycorr, var_e, d_inv):
    """sampleBayesRCpi! (functions.jl:291-360)."""
    sz, sua, suv, sg1, sg2, sv, sp = site.split(7)
    A, K = mp.n_annot, mp.n_classes
    z = stream.normal(sz, (mp.p_pad,))
    unif_a = stream.uniform(sua, (mp.p_pad,))
    unif_v = stream.uniform(suv, (mp.p_pad,))
    # the gammas of sampleProb's Dirichlet (functions.jl:541-544): shape
    # annot_input, plus 1 at the annotation the scan draws
    g1 = stream.gamma(sg1, torch.clamp(ms.annot_input, min=1e-6))
    g2 = stream.gamma(sg2, ms.annot_input + 1.0)
    ive = 1.0 / var_e
    varc = ms.var_beta[:, None] * ms.v_class[None, :]  # (A, K)
    pk = gibbs_kernels.rcpi_block_pack(
        ms.beta, z, unif_a, unif_v, g1, g2, ms.annot_prob, ms.annot_nz, ms.mpm.reshape(-1),
        ms.lhs_ss.reshape(-1), ms.rhs_ss.reshape(-1), ms.mask.reshape(-1), varc, ms.log_pi, ive,
        var_e)

    def scan(t, pk_t):
        return gibbs_kernels.rcpi_block_scan_v((ms.gram, t), pk_t, A, K)

    ycorr, beta, (delta, acat, annot_prob) = _blocked_sweep(ms, ycorr, pk, scan, d_inv)

    cls0 = torch.clamp(delta - 1, 0, K - 1).long()
    a0 = torch.clamp(acat - 1, 0, A - 1)
    vsel = ms.v_class[cls0]
    active = (delta > 0) & (vsel > 0)
    one = torch.ones((), dtype=beta.dtype, device=beta.device)
    zero = torch.zeros((), dtype=beta.dtype, device=beta.device)
    contrib = torch.where(active, beta * beta / torch.where(active, vsel, one), zero)
    annots = torch.arange(A, device=beta.device)
    onehot_a = (a0[:, None] == annots[None, :]) & (acat > 0)[:, None]
    var_beta = _annot_variances(stream, sv, ms, mp,
                                torch.where(onehot_a, contrib[:, None], zero),
                                onehot_a & active[:, None])
    out = replace(ms, beta=beta, delta=delta, annot_cat=acat, annot_prob=annot_prob,
                  var_beta=var_beta)
    if mp.est_pi:
        classes = torch.arange(K, device=beta.device)
        joint = (onehot_a[:, :, None] & (cls0[:, None, None] == classes[None, None, :])
                 & (delta > 0)[:, None, None])
        out = replace(out, **_annot_pi(stream, sp, ms, joint))
    return out, ycorr


def _sweep_rcplus(stream, site, ms, mp: MarkerPlan, ycorr, var_e, d_inv):
    """sampleBayesRCplus! (functions.jl:362-419): every non-zero annotation
    adds a component to the locus effect, and the rhs is refreshed after
    each (functions.jl:379, 400). The scan excludes the locus's own
    coefficient (functions.jl:376) and restores it per component through the
    Gram diagonal."""
    sz, su, sv, sp = site.split(4)
    A, K = mp.n_annot, mp.n_classes
    z = stream.normal(sz, (mp.p_pad, A))
    unif = stream.uniform(su, (mp.p_pad, A))
    ive = 1.0 / var_e
    varc = ms.var_beta[:, None] * ms.v_class[None, :]  # (A, K)
    pk = gibbs_kernels.rcplus_block_pack(
        ms.beta, z, unif, ms.annot_nz, ms.mpm.reshape(-1), ms.lhs_ss.reshape(-1),
        ms.rhs_ss.reshape(-1), ms.mask.reshape(-1), varc, ms.log_pi, ive, var_e)

    def scan(t, pk_t):
        return gibbs_kernels.rcplus_block_scan_v((ms.gram, t), pk_t, A, K)

    ycorr, beta, (delta, cls_a, bs_a, nz_a) = _blocked_sweep(ms, ycorr, pk, scan, d_inv)

    nz_a = nz_a > 0
    vsel = ms.v_class[torch.clamp(cls_a - 1, 0, K - 1).long()]
    one = torch.ones((), dtype=beta.dtype, device=beta.device)
    zero = torch.zeros((), dtype=beta.dtype, device=beta.device)
    contrib = torch.where(nz_a, bs_a * bs_a / torch.where(nz_a, vsel, one), zero)
    out = replace(ms, beta=beta, delta=delta,
                  var_beta=_annot_variances(stream, sv, ms, mp, contrib, nz_a))
    if mp.est_pi:
        classes = torch.arange(1, K + 1, device=beta.device, dtype=cls_a.dtype)
        out = replace(out, **_annot_pi(stream, sp, ms,
                                       cls_a[:, :, None] == classes[None, None, :]))
    return out, ycorr


# ------------------------------------------------------------------ BayesLV


def _sweep_lv(stream, site, ms, mp: MarkerPlan, ycorr, var_e, d_inv):
    """sampleBayesLV! (functions.jl:421-486): the Gaussian effect update with
    per-locus variances, then the bounded-uniform draw of each variance
    through three auxiliary variables, the log-linear coefficient draw, and
    varZeta. A locus whose bounds cross ("trapped") keeps its variance."""
    sz, su, sc = site.split(3)
    z = stream.normal(sz, (mp.p_pad,))
    u4 = stream.uniform(su, (mp.p_pad, 4))
    inf = torch.full_like(ms.var_beta, float("inf"))
    ivb_locus = torch.where(ms.var_beta > 0, 1.0 / ms.var_beta, inf)
    ycorr, bi = _gauss_effect_sweep(ms, mp, ycorr, var_e, d_inv, z, ivb_locus)

    # per-locus variance: bounded-uniform slice draw (functions.jl:444-470)
    vz = ms.var_zeta
    mask = ms.mask.reshape(-1)
    zero = torch.zeros((), dtype=bi.dtype, device=bi.device)
    vari = torch.where(mask, ms.var_beta, torch.ones_like(ms.var_beta))
    zeta = ms.lv_resid
    u1, u2, u3, uu = u4[:, 0], u4[:, 1], u4[:, 2], u4[:, 3]
    var_mui = ms.log_var - zeta
    c1 = vari ** (-1.5) * u1
    log_c2 = -0.5 * bi * bi / vari + torch.log(u2)
    temp = torch.sqrt(zeta * zeta - 2.0 * vz * torch.log(u3))  # = sqrt(-2 vz log c3)
    lb = torch.exp(var_mui - temp)
    rb = torch.exp(var_mui + temp)
    rb = torch.minimum(rb, torch.exp((-2.0 / 3.0) * torch.log(c1)))
    lb = torch.maximum(lb, -0.5 * bi * bi / log_c2)
    newv = lb + uu * (rb - lb)
    upd = mask & ~(lb >= rb)
    var_beta = torch.where(upd, newv, ms.var_beta)
    log_var = torch.where(upd, torch.log(newv), ms.log_var)

    # c ~ MvNormal(iCpC C' logVar, iCpC * varZeta) (functions.jl:473-476)
    zc = stream.normal(sc, (mp.n_lv_cov,))
    mean_c = ms.lv_icpc @ (ms.lv_design.T @ log_var)
    c = mean_c + torch.sqrt(vz) * (ms.lv_icpc_chol @ zc)
    resid = log_var - ms.lv_design @ c

    # varZeta rule (functions.jl:479-485); sample variance (ddof = 1) over loci < p
    def var_of(x):
        s1 = torch.where(mask, x, zero).sum()
        s2 = torch.where(mask, x * x, zero).sum()
        mean = s1 / mp.p
        return (s2 - mp.p * mean * mean) / (mp.p - 1)

    if isinstance(mp.est_var_zeta, bool):
        var_zeta = var_of(resid) if mp.est_var_zeta else vz
    else:
        var_zeta = mp.est_var_zeta * var_of(log_var)
    return replace(ms, beta=bi, var_beta=var_beta, log_var=log_var, lv_c=c, lv_resid=resid,
                   var_zeta=var_zeta), ycorr


# ------------------------------------------------------------------ correlated marker sets


def sample_corr_marker_set(stream, site, cs, cp: CorrMarkerPlan, ycorr, var_e):
    """Correlated marker sets, BayesPR semantics (functions.jl:140-154): a
    per-locus MvNormal across the nT sets and a per-region inverse-Wishart
    covariance (sampleVarCovBetaPR, functions.jl:513-516). No weighting and
    no summary statistics, as in the reference. A block-step is K1 over its
    V * B * nT rows (one per locus and set), CM1 on the V chains (which adds
    r0 - centre * sum(y) to its rows and writes beta in place), and K2 on
    the same rows; the per-locus rule of every locus comes first, one
    launch (ops/corr_scan.corr_rule). The region sums are fixed-order
    gathers, and every region's inverse-Wishart is one split-batched draw
    of normals and one of gammas. Returns (state, ycorr)."""
    n_t = cp.n_t
    kz, kv = site.split(2)
    z = stream.normal(kz, (cp.p_pad, n_t))
    pk = corr_scan.corr_rule(cs.beta, z, cs.var_beta.contiguous(), cs.region_id,
                             cs.mpm.reshape(-1, n_t, n_t), cs.mask.reshape(-1), var_e)

    T, V, B, _, q = cs.mt.shape
    n = ycorr.shape[0]
    y = _padded(ycorr, 4 * q)
    mt_rows = cs.mt.view(T * V * B * n_t, q)
    pk_g = pk.view(V, T, B, -1)  # global block g = v*T + t
    beta = torch.empty((V, T, B, n_t), dtype=ycorr.dtype, device=ycorr.device)
    for t in range(T):
        cb = cs.center[t]  # (V, B, nT)
        r0 = pack2.matvec_step(mt_rows, t, pack2.y_planar(y), V * B * n_t).view(V, B, n_t)
        u = corr_scan.corr_block_step((cs.gram, t), pk_g, r0, cb, y.sum(), beta)
        corr = pack2.rank_update_step(mt_rows, t, u.reshape(-1)).reshape(-1) - (u * cb).sum()
        y[:n] += corr[:n]  # the padded entries stay zero
    beta = beta.reshape(cp.p_pad, n_t)

    # per-region InverseWishart (functions.jl:152, :513-516)
    outer = (beta[:cp.p, :, None] * beta[:cp.p, None, :]).reshape(cp.p, -1)
    sb = torch.cat([outer, outer.new_zeros((1, n_t * n_t))])[cp.region_rows].sum(dim=1)
    s_full = cs.scale + sb.view(cp.n_regions, n_t, n_t)
    s_full = (s_full + s_full.transpose(-1, -2)) / 2.0
    var_beta = sample_inv_wishart_split(stream, kv, cp.df + cp.region_len.to(beta.dtype), s_full)
    return replace(cs, beta=beta, var_beta=var_beta.to(cs.var_beta.dtype)), y[:n]


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
    if mp.method == METHOD_RCPI:
        return _sweep_rcpi(stream, site, ms, mp, ycorr, var_e, d_inv)
    if mp.method == METHOD_RCPLUS:
        return _sweep_rcplus(stream, site, ms, mp, ycorr, var_e, d_inv)
    if mp.method == METHOD_LV:
        return _sweep_lv(stream, site, ms, mp, ycorr, var_e, d_inv)
    raise NotImplementedError(f"marker method {mp.method} is not a marker method of the port")
