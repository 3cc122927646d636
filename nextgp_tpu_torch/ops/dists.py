"""Conditional draws used by the Gibbs stages.

Counterparts of `nextgp_tpu/ops/dists.py:19-98`, with the same
parameterizations (NextGP.jl functions.jl:493-544). Randomness comes from a
stream and a draw site (engine/rng.py) instead of a JAX key; a draw that
JAX takes from `jax.random.split(key)` is taken here from `site.split(n)`,
so an injected stream can reproduce the JAX draws exactly.
"""
from __future__ import annotations

import torch


def sample_chi2(stream, site, df):
    """chi2(df) = 2 * Gamma(df/2); df a tensor (it may depend on the chain)."""
    return 2.0 * stream.gamma(site, df / 2.0)


def sample_scaled_inv_chi2(stream, site, df, scale, ss, n):
    """(df*scale + ss) / chi2(df + n), the conditional of every scalar
    variance in the reference (functions.jl:498-525)."""
    # a fill on the device, not a copy from the host: a captured sweep runs it
    return (df * scale + ss) / sample_chi2(stream, site, torch.full((), df + n, dtype=ss.dtype,
                                                                    device=ss.device))


def sample_beta_dist(stream, site, a, b):
    """Beta(a, b) via two gammas (samplePi, functions.jl:531-533)."""
    s1, s2 = site.split(2)
    g1 = stream.gamma(s1, a)
    g2 = stream.gamma(s2, b)
    return g1 / (g1 + g2)


def sample_dirichlet(stream, site, alpha):
    """Dirichlet(alpha) via normalized gammas (functions.jl:536-538)."""
    g = stream.gamma(site, alpha)
    return g / g.sum(dim=-1, keepdim=True)


def categorical_from_probs(u, probs):
    """Inverse-CDF categorical draw from one uniform per row, replicating
    the reference's `findfirst(x->x>=rand(), cumsum(probs))`
    (functions.jl:259-261). Returns int32 indices along the last axis,
    clamped to the last class: a float cumsum can round its final entry
    just below 1.0, and a uniform in that sliver would index one past it."""
    cum = torch.cumsum(probs, dim=-1)
    cls = (cum < u[..., None]).sum(dim=-1)
    return torch.clamp(cls, max=probs.shape[-1] - 1).to(torch.int32)


def sample_normal(stream, site, mean, sd):
    """mean + sd * N(0, 1) of mean's shape."""
    return mean + sd * stream.normal(site, tuple(mean.shape))


def _bartlett(nrm, gam, scale_chol):
    """(L A)(L A)' with A = tril(nrm, -1) + diag(sqrt(2 gam)): the Bartlett
    form of a Wishart draw, batched over any leading axes."""
    a = torch.tril(nrm, diagonal=-1) + torch.diag_embed(torch.sqrt(2.0 * gam))
    la = scale_chol @ a
    return la @ la.transpose(-1, -2)


def _dfs(df, p, like):
    """df - (0, 1, .., p-1) over df's leading axes; df a number or a tensor
    (a number is filled on the device: a captured sweep runs this)."""
    if not isinstance(df, torch.Tensor):
        df = torch.full((), df, dtype=like.dtype, device=like.device)
    return df.to(like.dtype)[..., None] - torch.arange(p, dtype=like.dtype, device=like.device)


def sample_wishart(stream, site, df, scale_chol):
    """Wishart(df, V) by the Bartlett decomposition, scale_chol = chol(V)
    (lower, (p, p)); df > p - 1, a number or a 0-d tensor. The normals and
    the gammas come from site.split(2), as the JAX package draws them."""
    p = scale_chol.shape[-1]
    kn, kc = site.split(2)
    nrm = stream.normal(kn, (p, p))
    gam = stream.gamma(kc, _dfs(df, p, scale_chol) / 2.0)
    return _bartlett(nrm, gam, scale_chol)


def _inv_chol(S):
    """chol(inv(S)) without a host check: a matrix that is not positive
    definite gives NaN, as in the JAX package, and no sync (a captured sweep
    cannot read `info`)."""
    s_inv = torch.linalg.inv_ex(S, check_errors=False)[0]
    return torch.linalg.cholesky_ex(s_inv, check_errors=False)[0]


def sample_inv_wishart(stream, site, df, S):
    """InverseWishart(df, S) in Distributions.jl's parameterization (mean
    S / (df - p - 1)): inv(Wishart(df, inv(S))), as the JAX package draws it
    (sampleCoVarU / sampleVarCovBetaPR, functions.jl:503-516)."""
    w = sample_wishart(stream, site, df, _inv_chol(S))
    return torch.linalg.inv_ex(w, check_errors=False)[0]


def sample_inv_wishart_split(stream, site, df, S):
    """R inverse-Wishart draws at once: row r is sample_inv_wishart at
    site.split(R)[r] with df[r] and S[r] (df (R,), S (R, p, p)), as the JAX
    package draws the regions of a correlated marker set
    (`jax.random.split(kv, n_regions)`). The normals and the gammas of all
    rows are one split-batched draw each (a KeyedStream launches one kernel
    for each)."""
    R, p = S.shape[0], S.shape[-1]
    nrm = stream.normal_split(site, R, (p, p), then=((2, 0),))
    gam = stream.gamma_split(site, R, _dfs(df, p, S) / 2.0, then=((2, 1),))
    w = _bartlett(nrm, gam, _inv_chol(S))
    return torch.linalg.inv_ex(w, check_errors=False)[0]
