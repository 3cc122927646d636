"""Multi-process start-up and chain-redundancy helpers.

Counterpart of `nextgp_tpu/parallel/multihost.py` on torch.distributed:
every process calls `init_distributed()`, builds the same global mesh over
the world's ranks (`global_mesh`), and the sharded sweep's psums and
gathers run over the mesh's process groups with no further change.

NCCL is the backend where a CUDA device is present (one card a rank), gloo
otherwise. A caller may also initialise a gloo world itself (for instance
several ranks time-sharing one card, whose CUDA tensors gloo reduces
through the host); every function here takes the world as it finds it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist


def _backend() -> str:
    return "nccl" if torch.cuda.is_available() else "gloo"


def _init(backend: str, local_rank: int, **kwargs) -> None:
    if backend == "nccl":  # one card a rank of this host
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend, **kwargs)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> bool:
    """torch.distributed.init_process_group with the JAX package's
    environment fallbacks (COORDINATOR_ADDRESS "host:port" / NUM_PROCESSES
    / PROCESS_ID); where none is given or set, torchrun's env:// variables
    (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, LOCAL_RANK), the
    counterpart of the JAX package's cloud autodetection. NCCL where a CUDA
    device is present (each rank on card LOCAL_RANK, else its process id,
    modulo the cards), gloo otherwise. Returns True if a process group was
    initialised (a world of one included, where the address is given),
    False for a single process."""
    coordinator_address = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None and "NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and "PROCESS_ID" in os.environ:
        process_id = int(os.environ["PROCESS_ID"])
    backend = _backend()
    if coordinator_address is None and num_processes is None:
        if "MASTER_ADDR" not in os.environ or int(os.environ.get("WORLD_SIZE", "1")) <= 1:
            return False
        _init(backend, int(os.environ.get("LOCAL_RANK", os.environ.get("RANK", "0"))),
              init_method="env://")
        return True
    _init(backend, int(os.environ.get("LOCAL_RANK", process_id or 0)),
          init_method=f"tcp://{coordinator_address}", world_size=num_processes, rank=process_id)
    return True


def global_mesh(n_chains: int = 1, n_shards: Optional[int] = None):
    """A (chains, shards) mesh over all the world's ranks. Chains ride the
    outer axis, so a row's shards are neighbouring ranks (one host's cards
    where n_shards <= the cards a host)."""
    from .sharded import _world, make_mesh

    return make_mesh(n_chains, n_shards, ranks=range(_world()[1]))


def _leaves(obj):
    """The JAX package's tree_leaves of a state: dataclass fields in order,
    tuples in order, None left out, and the port's own sweep_counter (the
    device copy of sweep_index) too."""
    if obj is None:
        return []
    if dataclasses.is_dataclass(obj):
        return [x for f in dataclasses.fields(obj) if f.name != "sweep_counter"
                for x in _leaves(getattr(obj, f.name))]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in _leaves(v)]
    return [obj]


def chain_checksum(state) -> float:
    """Deterministic scalar fingerprint of a chain state (or any part of
    one), for cross-rank divergence detection: the same seed and sweep give
    the same checksum on every rank. The JAX function's leaves and
    arithmetic."""
    acc = 0.0
    for leaf in _leaves(state):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        a = np.asarray(leaf, dtype=np.float64)
        if a.size:
            acc = float(np.sum(np.abs(a)) + acc * 1.000000119)
    return acc
