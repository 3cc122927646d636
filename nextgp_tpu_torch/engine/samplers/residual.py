"""Residual-variance draw (sampleVarE, NextGP.jl functions.jl:523-525)."""
from __future__ import annotations

import torch

from ...ops.dists import sample_scaled_inv_chi2


def sample_var_e(stream, site, e_state, ycorr, n, e_df):
    """varE ~ (df*scale + e'e) / chi2(df + n)."""
    return sample_scaled_inv_chi2(stream, site, e_df, e_state.scale, torch.dot(ycorr, ycorr),
                                  float(n))
