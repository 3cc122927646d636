"""Posterior summaries and convergence diagnostics.

Copy of `nextgp_tpu.io.summary` (numpy): `summary_mcmc` reproduces the
reference's posterior-mean reader (`summaryMCMC`, misc.jl:241-244); R-hat
and ESS are the JAX package's additions (the reference delegates
convergence checks to user-side MCMCChains code, docs/src/index.md:62-88).
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np


def read_samples(param: str, out_folder: str = "outMCMC") -> np.ndarray:
    """Load `<param>Out` as a (draws, dims) float array."""
    path = os.path.join(out_folder, f"{param}Out")
    return np.loadtxt(path, skiprows=1, ndmin=2)


def summary_mcmc(param: str, out_folder: str = "outMCMC") -> np.ndarray:
    """Column means of the thinned-sample file (misc.jl:241-244)."""
    return read_samples(param, out_folder).mean(axis=0)


def posterior_stats(draws: np.ndarray) -> Dict[str, np.ndarray]:
    draws = np.atleast_2d(draws)
    return {
        "mean": draws.mean(0),
        "sd": draws.std(0, ddof=1) if draws.shape[0] > 1 else np.zeros(draws.shape[1]),
        "q05": np.quantile(draws, 0.05, axis=0),
        "q95": np.quantile(draws, 0.95, axis=0),
    }


def split_rhat(chains: np.ndarray) -> np.ndarray:
    """Split-chain R-hat (Gelman et al. 2013). chains: (n_chains, n_draws, dim)."""
    c = np.atleast_3d(chains)
    n_ch, n_dr, dim = c.shape
    half = n_dr // 2
    if half < 2:  # too few draws to split: R-hat undefined
        return np.full(c.shape[2], np.nan)
    split = np.concatenate([c[:, :half], c[:, half : 2 * half]], axis=0)
    m, n = split.shape[0], split.shape[1]
    means = split.mean(axis=1)  # (m, dim)
    between = n * means.var(axis=0, ddof=1)
    within = split.var(axis=1, ddof=1).mean(axis=0)
    var_plus = (n - 1) / n * within + between / n
    with np.errstate(divide="ignore", invalid="ignore"):
        rhat = np.sqrt(var_plus / within)
    return rhat


def ess_bulk(chains: np.ndarray, max_lag: int = 200) -> np.ndarray:
    """Effective sample size via Geyer initial-positive-sequence
    autocorrelation, normalized by the MULTI-CHAIN variance estimate
    var_plus (Vehtari et al. 2021 / Stan): rho_t = 1 - (W - acov_t)/var+,
    so disagreeing (unmixed) chains deflate ESS instead of inflating it.
    NaN when fewer than 2 draws per chain (like split_rhat)."""
    c = np.atleast_3d(chains)
    n_ch, n_dr, dim = c.shape
    if n_dr < 2:
        return np.full(dim, np.nan)
    ess = np.empty(dim)
    for d in range(dim):
        x = c[:, :, d]
        means = x.mean(axis=1, keepdims=True)
        xc = x - means
        within = float(np.mean(x.var(axis=1, ddof=1))) if n_dr > 1 else 0.0
        between = (
            float(n_dr * means[:, 0].var(ddof=1)) if n_ch > 1 else 0.0
        )
        var_plus = (n_dr - 1) / n_dr * within + between / n_dr
        acov = np.zeros(max(1, min(max_lag, n_dr - 1)))
        for lag in range(len(acov)):
            acov[lag] = np.mean(
                [np.dot(xc[i, : n_dr - lag], xc[i, lag:]) / n_dr for i in range(n_ch)]
            )
        if var_plus <= 0:
            ess[d] = n_ch * n_dr
            continue
        rho = 1.0 - (within - acov) / var_plus  # rho[0] ~ 1 - noise
        s = 0.0
        for k in range(1, len(rho) - 1, 2):
            pair = rho[k] + rho[k + 1]
            if pair < 0:
                break
            s += pair
        ess[d] = n_ch * n_dr / max(1.0, 1.0 + 2.0 * s)
    return ess
