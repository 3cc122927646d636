"""Serving: genomic values (EBV) and out-of-sample prediction.

Counterparts of `nextgp_tpu/predict.py`:

* `genomic_values(md, beta)`: centered training-panel genomic values
  Mc @ beta in host float64, from an int8 or a 2-bit packed `MarkerData`
  whose rows may be numpy arrays or tensors on any device (copied to the
  host a chunk at a time; the packed path sums the planar fields without
  unpacking the panel).
* `predict(md_train, beta, new_genotypes)`: (new_genotypes - training
  centers) @ beta for new individuals, in host float64.
* `genomic_values_state(plan, state)`: Mc @ beta off the panel already
  on the device: through the scatter pass (K2 on CUDA) on packed storage,
  as a matrix product in the state's dtype on int8 or float storage.

`assemble` reads a MarkerData's panel without consuming it (the JAX
package donates a `from_packed` device panel to its storage and then
refuses it here), so `genomic_values` gives the same result before and
after `assemble`.
"""
from __future__ import annotations

import numpy as np
import torch

from .data.ingest import MarkerData
from .ops import pack2
from .utils import full_f32


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _beta_vec(beta, p):
    b = np.asarray(_host(beta), dtype=np.float64).reshape(-1)
    if b.shape[0] != p:
        raise ValueError(f"beta has {b.shape[0]} entries, marker set has {p} loci")
    return b


def genomic_values(md: MarkerData, beta, chunk: int = 8192) -> np.ndarray:
    """Training-panel genomic values g = (M - center) @ beta, (nInd,) f64.

    Accumulation is host float64 wherever the panel lives: a panel on the
    card is copied to the host a chunk at a time before the products."""
    b = _beta_vec(beta, md.n_snp)
    offset = float(np.dot(_host(md.center).astype(np.float64), b))
    g = md.genotypes
    if not md.packed:
        n = md.n_ind
        out = np.empty(n, np.float64)
        for i0 in range(0, n, chunk):
            out[i0:i0 + chunk] = _host(g[i0:i0 + chunk]).astype(np.float64) @ b
        return out - offset
    # packed rows: accumulate beta-weighted planar sums chunk by chunk
    q = g.shape[1]
    acc = np.zeros(4 * q, np.float64)
    for i0 in range(0, g.shape[0], chunk):
        blk = _host(g[i0:i0 + chunk]).astype(np.int32)
        bb = b[i0:i0 + chunk]
        for k in range(4):
            acc[k * q:(k + 1) * q] += ((blk >> (2 * k)) & 3).T.astype(np.float64) @ bb
    return acc[: md.n_ind] - offset


def genomic_values_state(plan, state, marker: int = 0, beta=None):
    """g = Mc @ beta computed off the panel already on the device. beta=None
    takes the current draw; otherwise any (p,) vector, e.g. a posterior
    mean. Packed storage goes through the scatter pass (K2 on CUDA, in the
    state's dtype: its float32 or float64 instance) over the whole panel;
    int8 or float storage is one product in the state's dtype (TF32 off),
    the JAX package's branch.
    Returns an (n,) tensor in the state's dtype on its device."""
    mp = plan.markers[marker]
    ms = state.markers[marker]
    dtype = state.ycorr.dtype
    if beta is None:
        b_flat = ms.beta
    else:
        b_flat = torch.zeros(mp.p_pad, dtype=dtype, device=ms.beta.device)
        b_flat[: mp.p] = torch.as_tensor(beta, dtype=dtype).reshape(-1)[: mp.p]
    T, V, B, W = ms.mt.shape
    # global locus order (v, t, b) -> storage row order (t, v, b)
    u = b_flat.view(V, T, B).transpose(0, 1).reshape(-1)
    offset = torch.dot(ms.center.reshape(-1), u)
    rows = ms.mt.view(-1, W)
    if mp.packed:
        g = pack2.rank_update(rows, u).reshape(-1)
    else:
        with full_f32():
            g = u @ rows.to(dtype)
    return g[: plan.n] - offset


def predict(md_train: MarkerData, beta, new_genotypes) -> np.ndarray:
    """Genomic values for new individuals under the trained model:
    (new_genotypes - training centers) @ beta. new_genotypes (m, p) dosages
    in the TRAINING locus order, a host array or a tensor."""
    b = _beta_vec(beta, md_train.n_snp)
    g = np.asarray(_host(new_genotypes), dtype=np.float64)
    if g.ndim != 2 or g.shape[1] != md_train.n_snp:
        raise ValueError(
            f"new_genotypes must be (m, {md_train.n_snp}); got {g.shape}")
    return g @ b - float(np.dot(_host(md_train.center).astype(np.float64), b))
