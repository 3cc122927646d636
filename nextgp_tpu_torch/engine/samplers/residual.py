"""Residual-variance draw (sampleVarE, NextGP.jl functions.jl:523-528)."""
from __future__ import annotations

import torch

from ...ops.dists import sample_scaled_inv_chi2


def sample_var_e(stream, site, e_state, ycorr, n, e_df):
    """varE ~ (df*scale + e'We) / chi2(df + n); W = I, or diag(1/w) for a
    weighted residual (functions.jl:523-525 unweighted, :526-528 weighted)."""
    if e_state.d_inv is not None:
        ss = torch.sum(e_state.d_inv * ycorr * ycorr)
    else:
        ss = torch.dot(ycorr, ycorr)
    return sample_scaled_inv_chi2(stream, site, e_df, e_state.scale, ss, float(n))
