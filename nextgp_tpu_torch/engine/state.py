"""The Gibbs state as frozen dataclasses of tensors.

Counterparts of the pytrees in `nextgp_tpu/engine/state.py`, with the same
field names, for the terms the port carries: residual, fixed blocks and
BayesR marker sets. A sweep returns a new state (`utils.replace`).

Marker storage has one layout for every V (V=1 included), with
T = n_blocks / V block-steps and global block g = v*T + t:
    mt     (T, V, B, q) uint8, 2-bit planar-packed rows
    center (T, V, B)
    gram   (T, B, V, B) centered Gram blocks, locus-major
The JAX package stores V=1 as (nb, B, q) / (nb, B) / (nb, B, B); those are
the same bytes, and `state_from_numpy` reshapes them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FixedState:
    x: torch.Tensor  # (n, k)
    xp: torch.Tensor  # (k, n)
    xpx: torch.Tensor  # (k, k), ridge-jittered when k > 1
    lhs_ss: torch.Tensor  # (k,) summary-statistic offsets (zero in the port)
    rhs_ss: torch.Tensor  # (k,)
    b: torch.Tensor  # (k,)


@dataclasses.dataclass(frozen=True)
class MarkerState:
    """One BayesR marker set. B = block size, nb = n_blocks."""

    mt: torch.Tensor  # (T, V, B, q) uint8
    center: torch.Tensor  # (T, V, B)
    gram: torch.Tensor  # (T, B, V, B)
    mpm: torch.Tensor  # (nb, B) diag of the Gram, global block order
    lhs_ss: torch.Tensor  # (nb, B) summary-statistic offsets (zero in the port)
    rhs_ss: torch.Tensor  # (nb, B)
    mask: torch.Tensor  # (nb, B) bool, False on padded loci
    region_id: torch.Tensor  # (p_pad,) int32, all 0: BayesR has one variance
    beta: torch.Tensor  # (p_pad,)
    delta: torch.Tensor  # (p_pad,) int32, 1-based class (0 on padded loci)
    var_beta: torch.Tensor  # (1,)
    scale: torch.Tensor  # ()
    log_pi: torch.Tensor  # (K,)
    pi_hat: torch.Tensor  # (K,)
    v_class: torch.Tensor  # (K,)


@dataclasses.dataclass(frozen=True)
class ResidualState:
    scale: torch.Tensor  # ()
    var_e: torch.Tensor  # () last drawn value


@dataclasses.dataclass(frozen=True)
class ModelState:
    y: torch.Tensor  # (n,)
    ycorr: torch.Tensor  # (n,)
    e: ResidualState
    fixed: Tuple[FixedState, ...]
    markers: Tuple[MarkerState, ...]
    sweep_index: int  # host counter; names the draw sites of the next sweep


_INT_FIELDS = {"region_id": torch.int32, "delta": torch.int32, "mt": torch.uint8,
               "mask": torch.bool}


def state_from_numpy(plan, arrays: Dict[str, np.ndarray]) -> ModelState:
    """Build a ModelState on plan.device from numpy arrays keyed by the JAX
    field paths ("ycorr", "e.var_e", "fixed.0.b", "markers.0.gram", ...,
    "sweep_index"), for instance a flattened JAX ModelState. Every field
    must be given and no other; float fields take plan.dtype, and marker
    storage is reshaped to the port's layout."""
    used = set()

    def get(key, dtype=None, shape=None):
        if key not in arrays:
            raise KeyError(f"state_from_numpy: missing {key!r}")
        used.add(key)
        t = torch.tensor(np.asarray(arrays[key]))  # a copy: the arrays may be read-only
        t = t.to(device=plan.device, dtype=dtype or plan.dtype)
        return t.reshape(shape) if shape is not None else t

    def fields(cls, prefix, shapes=None):
        shapes = shapes or {}
        return cls(**{
            f.name: get(prefix + f.name, _INT_FIELDS.get(f.name), shapes.get(f.name))
            for f in dataclasses.fields(cls)})

    markers = []
    for i, mp in enumerate(plan.markers):
        V, B = mp.vshards, mp.block
        T = mp.n_blocks // V
        q = arrays[f"markers.{i}.mt"].shape[-1]
        markers.append(fields(MarkerState, f"markers.{i}.", {
            "mt": (T, V, B, q), "center": (T, V, B), "gram": (T, B, V, B)}))
    state = ModelState(
        y=get("y"),
        ycorr=get("ycorr"),
        e=fields(ResidualState, "e."),
        fixed=tuple(fields(FixedState, f"fixed.{i}.") for i in range(len(plan.fixed))),
        markers=tuple(markers),
        sweep_index=int(get("sweep_index", torch.int64)),
    )
    extra = set(arrays) - used
    if extra:
        raise KeyError(f"state_from_numpy: unknown fields {sorted(extra)}")
    return state
