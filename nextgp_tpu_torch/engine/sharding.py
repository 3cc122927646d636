"""Shard context threaded through the marker samplers.

Counterpart of `nextgp_tpu/engine/sharding.py`. One implementation serves
the single-rank and the sharded sweep: a marker set's blocks are split
across the ranks of a chain's row of the mesh (parallel/sharded.py), the
residual is replicated, and each block-step's correction and every
cross-locus reduction are merged with `psum`, one `all_reduce` over the
row's process group. The context says where those points are and how to
slice the per-locus draws, which every rank makes at global length, so
that a chain is the same chain whatever the number of shards.

Fields: `group` stands for the JAX package's `axis` (the mesh axis the psum
runs over): the torch.distributed process group of this rank's row, or
None for the unsharded sweep. `index` is this rank's shard in its row and
`n_shards` the row's length, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    group: Optional[Any] = None  # the row's process group for the marker psum
    index: int = 0  # this rank's shard index in its row
    n_shards: int = 1

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """x summed over the row's ranks: a new tensor (the caller's is
        never reduced in place); x itself without a group."""
        if self.group is None:
            return x
        out = x.clone()
        dist.all_reduce(out, group=self.group)
        return out

    def slice_p(self, arr: torch.Tensor, p_local: int) -> torch.Tensor:
        """This shard's run of a per-locus array drawn at global length."""
        if self.group is None:
            return arr
        return arr.narrow(0, self.index * p_local, p_local)

    def n_real(self, p: int, p_local: int) -> int:
        """How many of this shard's p_local loci are real (< p): the run
        the region sums read, before the padded loci at the end."""
        return max(0, min(p - self.index * p_local, p_local))


UNSHARDED = ShardCtx()
