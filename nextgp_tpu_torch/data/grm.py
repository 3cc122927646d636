"""Genomic relationship matrices (vanRaden methods 1 and 2) and their inverse.

Counterparts of `nextgp_tpu/data/grm.py` (NextGP.jl's makeG, misc.jl:122-160):
column mean-centering, method 1 = MM'/sum(2pq), method 2 = per-locus scaling
by sqrt(2pq) then MM'/nLoci, plus a 0.001*I ridge; GBLUP takes the
symmetrized inverse as its random effect's structure (prepMatVec.jl:123-127).
The JAX package computes them in numpy on the host; here they are torch
float64 on the device the caller names, the card unless device="cpu": at
10,000 individuals x 49,152 loci they are one product and one inverse on the
card, where the host would take minutes.
"""
from __future__ import annotations

import torch

from ..utils import default_device


def make_g(m, method: int = 1, ridge: float = 0.001, device=None) -> torch.Tensor:
    """vanRaden GRM, (nInd, nInd) float64 on `device`, from an (nInd, nSNP)
    0/1/2 dosage matrix (numpy or torch), or from a genotype file path (the
    reference's file overload, misc.jl:145-160)."""
    if isinstance(m, str):
        from .ingest import read_genotype_file

        m = read_genotype_file(m).genotypes
    device = torch.device(device) if device is not None else default_device()
    m = torch.as_tensor(m).to(device=device, dtype=torch.float64)
    mean = m.mean(dim=0)
    p = mean / 2.0
    q = 1.0 - p
    mc = m - mean
    if method == 1:
        g = (mc @ mc.T) / torch.sum(2.0 * p * q)
    elif method == 2:
        s = torch.sqrt(2.0 * p * q)
        mc = torch.where(s > 0, mc / s, torch.zeros((), dtype=mc.dtype, device=device))
        g = (mc @ mc.T) / p.numel()
    else:
        raise ValueError("method must be 1 or 2")
    g.diagonal().add_(ridge)
    return g


def make_g_inverse(m, method: int = 1, ridge: float = 0.001, device=None) -> torch.Tensor:
    """Inverse GRM, symmetrized (prepMatVec.jl:124), float64 on `device`."""
    gi = torch.linalg.inv(make_g(m, method=method, ridge=ridge, device=device))
    return (gi + gi.T) / 2.0

