"""Serving: genomic values from the assembled marker storage.

Counterpart of `nextgp_tpu/predict.py:genomic_values_state`.
"""
from __future__ import annotations

import torch

from .ops import pack2


def genomic_values_state(plan, state, marker: int = 0, beta=None):
    """g = Mc @ beta computed off the packed panel already on the device,
    through the scatter pass (K2 on CUDA) over the whole panel. beta=None
    takes the current draw; otherwise any (p,) vector, e.g. a posterior
    mean. Returns an (n,) tensor in the state's dtype on its device."""
    mp = plan.markers[marker]
    ms = state.markers[marker]
    dtype = state.ycorr.dtype
    if beta is None:
        b_flat = ms.beta
    else:
        b_flat = torch.zeros(mp.p_pad, dtype=dtype, device=ms.beta.device)
        b_flat[: mp.p] = torch.as_tensor(beta, dtype=dtype).reshape(-1)[: mp.p]
    T, V, B, q = ms.mt.shape
    # global locus order (v, t, b) -> storage row order (t, v, b)
    u = b_flat.view(V, T, B).transpose(0, 1).reshape(-1)
    offset = torch.dot(ms.center.reshape(-1), u)
    g = pack2.rank_update(ms.mt.view(-1, q), u).reshape(-1)[: plan.n]
    return g - offset
