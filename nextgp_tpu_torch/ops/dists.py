"""Scalar conditional draws used by the Gibbs stages.

Counterparts of `nextgp_tpu/ops/dists.py:19-53, 86-98`, with the same
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
