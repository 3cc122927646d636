"""Checkpoint and exact resume of a Gibbs chain.

Counterpart of `nextgp_tpu.io.checkpoint` (`plan_fingerprint`,
`save_checkpoint`, `read_meta`, `load_checkpoint`). A chain is a function
of its stream's seed and the sweep number (engine/rng.py: PhiloxStream and
KeyedStream key every draw by its site), so a restored state continues the
chain bit for bit; a KeyedStream reads the device's `sweep_counter`, which
a checkpoint holds beside `sweep_index` (the two must agree).

What a checkpoint holds differs from the JAX package's file on purpose. It
holds only the leaves a sweep replaces (the fields `engine/state.
_CHAIN_FIELDS` names: the residual, the effects, their variances and the
marker states' draws), keyed by their path in the state ("markers.0.beta"),
and `sweep_index`. The constant leaves (the packed panel, the Gram blocks,
A^-1, ...) are rebuilt by `assemble` from the spec: at 10,000 x 49,152
they are ~0.17 GB, and at 50,000 x 590,000 the packed panel alone is
7.4 GB. Since the plan's fingerprint pins shapes and settings, not data,
the meta blob also records a digest of the constant leaves
(`constants_digest`), and a checkpoint of another panel of the same shapes
is refused as a fingerprint mismatch is. The meta blob keeps the JAX
package's keys: the fingerprint and the kept-row count that resume cuts
the output files back to.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..engine.state import chain_leaves
from ..engine.sweep import _leaves, _with_leaves
from ..utils import replace

_META_KEY = "__meta__"
_INDEX_KEY = "sweep_index"
_DIGEST_CHUNK = 1 << 24  # elements copied to the host at a time


def _static(obj):
    """The plan's fields that take part in its equality, recursively. The
    others (compare=False) are tensors derived from the data, whose repr
    would print their values and device."""
    if dataclasses.is_dataclass(obj):
        return (type(obj).__name__, tuple((f.name, _static(getattr(obj, f.name)))
                                          for f in dataclasses.fields(obj) if f.compare))
    if isinstance(obj, tuple):
        return tuple(_static(x) for x in obj)
    return obj


def plan_fingerprint(plan: Any) -> str:
    """Stable digest of the static SweepPlan: shapes, methods, settings,
    dtype and device."""
    return hashlib.sha256(repr(_static(plan)).encode()).hexdigest()[:16]


def constants_digest(state) -> str:
    """Digest of the leaves a sweep does not replace (their names, shapes,
    dtypes and bytes): the data a checkpoint was taken on. It copies them to
    the host in chunks, so take it once a run."""
    carried = chain_leaves(state)
    h = hashlib.sha256()
    for key, t in _leaves(state).items():
        if key in carried or key == "sweep_index.":  # a batched state's chain indices
            continue
        h.update(f"{key}{tuple(t.shape)}{t.dtype}".encode())
        flat = t.detach().reshape(-1)
        for i in range(0, flat.numel(), _DIGEST_CHUNK):
            h.update(flat[i:i + _DIGEST_CHUNK].cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _host_index(state) -> np.ndarray:
    s = state.sweep_index
    return s.cpu().numpy() if isinstance(s, torch.Tensor) else np.asarray(s, np.int64)


def save_checkpoint(path: str, state: Any, meta: Optional[Dict[str, Any]] = None):
    """Write the state's carried leaves and sweep_index (+ JSON meta) to
    `path` (.npz). Atomic: a temp file, fsync, rename, fsync the folder."""
    arrays = {k.rstrip("."): t.cpu().numpy() for k, t in chain_leaves(state).items()}
    arrays[_INDEX_KEY] = _host_index(state)
    if meta:
        blob = json.dumps(meta).encode()
        arrays[_META_KEY] = np.frombuffer(blob, np.uint8).copy()
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.savez(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())  # rename-before-data on power loss would
    os.replace(tmp, path)      # destroy BOTH checkpoints otherwise
    try:  # persist the rename itself
        dfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def read_meta(path: str) -> Dict[str, Any]:
    """The JSON meta blob stored with the checkpoint ({} if none)."""
    with np.load(path) as data:
        if _META_KEY in data.files:
            return json.loads(bytes(data[_META_KEY]).decode())
    return {}


def load_checkpoint(path: str, template: Any, fingerprint: Optional[str] = None,
                    constants: Optional[str] = None):
    """`template` (an assembled state of the same model, on its device) with
    the checkpoint's carried leaves and sweep_index.

    fingerprint / constants: when given and the checkpoint recorded one,
    they must match (`plan_fingerprint`, `constants_digest`): a checkpoint
    of another model, or of the same model on other data, is an error, not a
    silent resume. So are other leaves, shapes or dtypes, and a
    sweep_counter that is not sweep_index.
    """
    with np.load(path) as data:
        meta = json.loads(bytes(data[_META_KEY]).decode()) if _META_KEY in data.files else {}
        stored = meta.get("fingerprint")
        if fingerprint is not None and stored is not None and stored != fingerprint:
            raise ValueError(f"checkpoint at {path!r} was written by a different model "
                             f"(plan fingerprint {stored} != {fingerprint})")
        stored = meta.get("constants")
        if constants is not None and stored is not None and stored != constants:
            raise ValueError(f"checkpoint at {path!r} was written on different data "
                             f"(digest of the constant leaves {stored} != {constants})")
        leaves = chain_leaves(template)
        want = {k.rstrip(".") for k in leaves} | {_INDEX_KEY}
        have = set(data.files) - {_META_KEY}
        if have != want:
            raise ValueError(f"checkpoint at {path!r} holds leaves {sorted(have ^ want)} "
                             "that the model does not, or lacks them")
        new = {}
        for key, t in leaves.items():
            arr = data[key.rstrip(".")]
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{key.rstrip('.')}: shape {arr.shape} != {tuple(t.shape)}")
            loaded = torch.from_numpy(arr)
            if loaded.dtype != t.dtype:
                raise ValueError(f"{key.rstrip('.')}: dtype {loaded.dtype} != {t.dtype}")
            new[key] = loaded.to(t.device)
        index = data[_INDEX_KEY]
    if index.shape != _host_index(template).shape:
        raise ValueError(f"sweep_index: shape {index.shape} != {_host_index(template).shape}")
    if not np.array_equal(new["sweep_counter."].cpu().numpy(), index):
        raise ValueError("checkpoint's sweep_counter differs from its sweep_index")
    if isinstance(template.sweep_index, torch.Tensor):
        index = torch.from_numpy(index).to(template.sweep_index.device)
    else:
        index = int(index)
    return replace(_with_leaves(template, new), sweep_index=index)
