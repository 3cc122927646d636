"""Fixed-effect Gibbs stages (sampleX!/sampleb!, NextGP.jl functions.jl:22-53).

Single-column blocks use the summary-stat offsets; multi-column blocks run
the Gauss-Seidel scan over coefficients, which, as in the reference, does
not apply them (functions.jl:29-30).
"""
from __future__ import annotations

import torch


def sample_fixed_block(stream, site, fs, ycorr, var_e, single: bool):
    """Returns (new_b, new_ycorr)."""
    ive = 1.0 / var_e
    k = fs.b.shape[0]
    z = stream.normal(site, (k,))
    if single:
        x = fs.x[:, 0]
        ycorr = ycorr + x * fs.b[0]
        rhs = torch.dot(fs.xp[0], ycorr) * ive + fs.rhs_ss[0]
        lhs = fs.xpx[0, 0] * ive + fs.lhs_ss[0]
        bnew = rhs / lhs + z[0] * torch.sqrt(1.0 / lhs)
        return bnew.reshape(1), ycorr - x * bnew

    ycorr = ycorr + fs.x @ fs.b
    yi = (fs.xp @ ycorr) * ive  # X'ycorr/varE for all coefficients (functions.jl:25)
    b = fs.b.clone()
    for i in range(k):
        b[i] = 0.0
        rhsb = yi[i] - torch.dot(fs.xpx[i], b) * ive
        lhsb = fs.xpx[i, i] * ive
        b[i] = rhsb / lhsb + z[i] * torch.sqrt(1.0 / lhsb)
    return b, ycorr - fs.x @ b
