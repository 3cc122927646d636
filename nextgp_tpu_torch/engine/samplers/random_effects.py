"""Random-effect Gibbs stages (sampleZ!/sampleU, NextGP.jl functions.jl:
57-110) with their variance draws (sampleVarU / sampleCoVarU, functions.jl:
498-506).

Counterparts of `sample_random_uni`, `sample_random_cg` and
`sample_random_corr` in `nextgp_tpu/engine/samplers/random_effects.py`. The
per-level scan is a Gauss-Seidel pass against the dense inverse structure
(A^-1, G^-1 or I) through RE1 (ops/random_scan.py), and for a correlated
group through RE2 with an inverse-Wishart covariance; the CG sampler draws
u jointly by perturbed conjugate gradient over a level index and padded
sparse rows. The whole-matrix products around the scans (Z u, Z' ycorr,
u' K u) are torch.matmul in full float32. The CG sampler's solve is one
call of ops/cg.cg_solve_sparse (CG1 on the card, which decides its
stopping rule there); its segment sums (Z' v and the Henderson factor's
(I - P)' x, once a sweep) are padded gathers over the plan's static
level->records and parent->children tables, summed in a fixed order: no
float atomics and no host sync.
"""
from __future__ import annotations

import torch

from ...ops.cg import cg_solve_sparse
from ...ops.dists import sample_inv_wishart, sample_scaled_inv_chi2
from ...ops.random_scan import corr_level_scan, level_scan
from ...utils import full_f32


def sample_random_uni(stream, site, rs, ycorr, var_e, df):
    """Univariate random effect by the per-level scan. Returns
    (u, var_u, ycorr)."""
    q = rs.u.shape[0]
    kz, kv = site.split(2)
    z = stream.normal(kz, (q,))
    ive = 1.0 / var_e
    ivu = 1.0 / rs.var_u
    with full_f32():
        ycorr = ycorr + rs.z @ rs.u
        yi = (rs.zp @ ycorr) * ive  # functions.jl:61
        u = level_scan(rs.ivstr, yi, rs.zpz, z, rs.u, ive, ivu)
        ycorr = ycorr - rs.z @ u
        ss = u @ rs.ivstr @ u
    var_u = sample_scaled_inv_chi2(stream, kv, df, rs.scale, ss, float(q))  # functions.jl:498-501
    return u, var_u, ycorr


def sample_random_corr(stream, site, rs, ycorr, var_e, df):
    """A correlated group (tuple key): per-level MvNormal with Kronecker
    structure (functions.jl:75-110), by the correlated level scan (RE2).
    The covariance is drawn before the effects are taken out of ycorr, as
    in the reference (functions.jl:105-106). Returns (u, var_u, ycorr)."""
    n_t, q = rs.u.shape
    kz, kv = site.split(2)
    z = stream.normal(kz, (q, n_t))

    def zu(u):  # sum_t Z_t u_t, one batched matrix-vector product over zs (nT, n, q)
        return torch.matmul(rs.zs, u[..., None]).sum(dim=0)[:, 0]

    with full_f32():
        ycorr = ycorr + zu(rs.u)  # restore every component
        yi = torch.matmul(ycorr, rs.zs)  # (nT, q): per-level Z_l' ycorr
        ivu = torch.linalg.inv_ex(rs.var_u, check_errors=False)[0]
        u = corr_level_scan(rs.ivstr, yi, rs.zpz, z, rs.u, var_e, ivu)
        ss = u @ rs.ivstr @ u.T + rs.scale
        var_u = sample_inv_wishart(stream, kv, df + q, (ss + ss.T) / 2.0)
        ycorr = ycorr - zu(u)
    return u, var_u, ycorr


def _padded_sum(x, rows):
    """sum_k x[rows[:, k]] with rows padded by len(x) (a zero appended)."""
    xp = torch.cat([x, x.new_zeros(1)])
    return torch.index_select(xp, 0, rows.reshape(-1)).view(rows.shape).sum(dim=1)


def sample_random_cg(stream, site, rs, ycorr, var_e, df, rp, d_inv=None):
    """Exact joint MvNormal draw of u | rest by perturbed conjugate gradient
    (matrix-free; for large q in place of the per-level scan).

    With C = Z'D^-1 Z / ve + K / vu (K = inverse structure), the draw
        u = C^-1 [ Z'D^-1 (ycorr + e1) / ve + s ],
        e1 ~ N(0, ve D),  s ~ N(0, K / vu)
    has exactly the conditional distribution N(C^-1 Z'D^-1 ycorr / ve, C^-1)
    that the scan targets one coordinate at a time. s uses the Henderson
    factorization K = (I-P)' D_f^-1 (I-P) (data/pedigree.py:
    a_inverse_factor), so no Cholesky of K is formed. Z is one-hot, so
    Z'D^-1 Z is the plan's diagonal z_diag and the solve's matvec is
    (z_diag / ve + K / vu) v over the live entries of K's padded rows
    (cg_solve_sparse). Returns (u, var_u, ycorr, iterations), the
    iterations a 0-d int32 tensor on u's device: nothing is read back to the
    host, so the stage can be captured in a CUDA graph.
    """
    q = rs.u.shape[0]
    n = ycorr.shape[0]
    k1, k2, kv = site.split(3)
    idx = torch.where(rs.z_idx >= 0, rs.z_idx, q)

    def Zt(vec_n):  # Z' v: each level's records, summed in record order
        return _padded_sum(vec_n, rp.z_rows)

    def Z(vec_q):  # Z v by gather (records of no level read the appended 0)
        return torch.index_select(torch.cat([vec_q, vec_q.new_zeros(1)]), 0, idx)

    def ivmul(v):  # K v from the padded sparse rows
        return torch.sum(rs.iv_val * torch.index_select(v, 0, rs.iv_idx.reshape(-1)).view(
            rs.iv_idx.shape), dim=1)

    def factor_t(x):  # (I - P)' x
        half = 0.5 * x
        return x - _padded_sum(half, rp.sire_kids) - _padded_sum(half, rp.dam_kids)

    ive = 1.0 / var_e
    ivu = 1.0 / rs.var_u
    ycorr = ycorr + Z(rs.u)

    w = (1.0 / d_inv) if d_inv is not None else 1.0
    e1 = stream.normal(k1, (n,)) * torch.sqrt(var_e * w)
    xi = stream.normal(k2, (q,))
    s = factor_t(rs.fac_dsqrt * xi) * torch.sqrt(ivu)
    yp = ycorr + e1
    rhs = Zt(d_inv * yp if d_inv is not None else yp) * ive + s

    u, iters, _ = cg_solve_sparse(rp.z_diag * ive, rs.iv_idx, rs.iv_val, rp.iv_len, ivu, rhs, rs.u,
                                  tol=rp.cg_tol, max_iter=rp.cg_iters, layout=rp.cg_layout)
    ycorr = ycorr - Z(u)

    ss = u @ ivmul(u)
    var_u = sample_scaled_inv_chi2(stream, kv, df, rs.scale, ss, float(q))
    return u, var_u, ycorr, iters
