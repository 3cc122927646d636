"""Multi-rank execution: chains x marker shards over a mesh of ranks.

Counterpart of `nextgp_tpu/parallel/sharded.py` on torch.distributed. A rank
(one process) stands for a JAX device, and a mesh is a (chains, shards)
grid of ranks. The marker blocks of each chain's row are split across its
shard ranks, the residual is replicated, and each block-step's correction
is merged with one `all_reduce` over the row's process group
(engine/samplers/markers.py carries the psum points through ShardCtx). The
chains run data-parallel, one row each, and every non-marker stage runs on
each shard of the row alike (the same arithmetic on replicated inputs).

Per-locus draws are made at global length and sliced per shard, so a chain
is the same chain whatever the shard count: with V = vshards block chains,
shard s owns the V/S of them numbered [s*V/S, (s+1)*V/S), which is the
single-rank V-wide schedule; at V = 1 it owns the block-steps
[s*T/S, (s+1)*T/S), the S-wide schedule, as the JAX package shards the
block axis. A mesh of one rank samples the unsharded chain bit for bit.

The collectives are NCCL's for CUDA tensors and gloo's for CPU tensors,
as multihost.init_distributed picks them; a gloo world that the caller
initialises itself (several ranks time-sharing one card) runs on the card
too. A sharded sweep runs eagerly: a gloo collective cannot be captured in
a CUDA graph.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..engine.plan import METHOD_B, METHOD_LV, SweepPlan
from ..engine.sharding import ShardCtx
from ..engine.state import ModelState, chain_leaves
from ..engine.sweep import _with_leaves, make_sweep
from ..utils import replace

CHAINS, SHARDS = "chains", "shards"

# chain fields sharded along the locus axis, as in the JAX package; the
# other chain fields (variances, pi, lv_c, var_zeta, ...) are replicated.
# annot_input stays replicated: the RCpi gammas are drawn on it at global
# length and sliced per shard.
_SHARD_CHAIN = ("beta", "delta", "annot_prob", "annot_cat", "log_var", "lv_resid")
# constant per-locus fields of a marker set, sharded along the locus axis
_SHARD_LOCI = ("region_id", "annot_nz", "lv_design")
# constant per-block fields (nb, B, ...), sharded along the block axis
_SHARD_BLOCKS = ("mpm", "lhs_ss", "rhs_ss", "mask")


def _world() -> Tuple[int, int]:
    """(rank, world size): (0, 1) without an initialised process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A (chains, shards) grid of ranks, the counterpart of the JAX Mesh
    with axes ("chains", "shards"): `devices` the (C, S) ranks, `shape` the
    axis sizes by name, and each row's process group (None without an
    initialised process group, where the mesh is this one rank; a row of
    one rank in an initialised world has a group of one, whose psum is the
    identity)."""

    def __init__(self, ranks: np.ndarray, groups: List[Optional[object]]):
        self.devices = ranks
        self.shape = {CHAINS: ranks.shape[0], SHARDS: ranks.shape[1]}
        self.groups = groups

    def coords(self, rank: Optional[int] = None) -> Optional[Tuple[int, int]]:
        """(chain, shard) of `rank` (this process's by default), None for a
        rank that the mesh does not hold."""
        rank = _world()[0] if rank is None else rank
        at = np.argwhere(self.devices == rank)
        return (int(at[0, 0]), int(at[0, 1])) if at.size else None

    def ctx(self) -> ShardCtx:
        """This rank's shard context: its row's group, its shard index."""
        at = self.coords()
        if at is None:
            raise ValueError(f"rank {_world()[0]} is not in the mesh {self.devices.tolist()}")
        return ShardCtx(group=self.groups[at[0]], index=at[1], n_shards=self.shape[SHARDS])


def make_mesh(n_chains: int = 1, n_shards: Optional[int] = None, ranks=None) -> Mesh:
    """A (n_chains, n_shards) mesh over `ranks` (the whole world by default),
    row-major as the JAX package reshapes its devices. Every rank of the
    world calls it alike: it makes each row's process group."""
    size = _world()[1]
    ranks = np.asarray(list(ranks) if ranks is not None else range(size), dtype=np.int64)
    if n_shards is None:
        n_shards = ranks.size // n_chains
    if n_chains * n_shards != ranks.size:
        raise ValueError(f"chains*shards = {n_chains * n_shards} != {ranks.size} ranks")
    if ranks.size and (ranks.min() < 0 or ranks.max() >= size or np.unique(ranks).size != ranks.size):
        raise ValueError(f"ranks {ranks.tolist()} are not distinct ranks of the world of {size}")
    grid = ranks.reshape(n_chains, n_shards)
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh(grid, [None] * n_chains)
    return Mesh(grid, [dist.new_group(row.tolist()) for row in grid])


# ------------------------------------------------------------------ the state's layout


def stack_chains(states: List[ModelState]) -> ModelState:
    """One ModelState whose chain fields (engine/state._CHAIN_FIELDS) hold
    the chains' values stacked on a leading chain axis (sweep_index a (C,)
    int64 tensor); the other fields are the first chain's, which every
    chain shares."""
    leaves = [chain_leaves(s) for s in states]
    new = {k: torch.stack([lv[k] for lv in leaves]) for k in leaves[0]}
    index = torch.tensor([s.sweep_index for s in states], dtype=torch.int64,
                         device=states[0].ycorr.device)
    return replace(_with_leaves(states[0], new), sweep_index=index)


def pick_chain(batched: ModelState, c: int) -> ModelState:
    """Chain c of a chains-batched state (the inverse of stack_chains)."""
    leaves = {k: v[c] for k, v in chain_leaves(batched).items()}
    return replace(_with_leaves(batched, leaves), sweep_index=int(batched.sweep_index[c]))


def batch_state(plan: SweepPlan, state: ModelState, n_chains: int) -> ModelState:
    """Add a leading chains axis to every chain field (each chain a copy)."""
    return stack_chains([state] * n_chains)


def _take(x, dim, start, length):
    """A contiguous copy of x's run [start, start + length) along dim: the
    kernels read whole (rows, q) panels, and the global tensor is freed once
    its holder lets it go."""
    if x is None:
        return None
    return x.narrow(dim, start, length).clone(memory_format=torch.contiguous_format)


def _sharded_chain(mp) -> Tuple[str, ...]:
    """A marker set's chain fields that lie along its loci: var_beta too
    where it is per locus (BayesB, BayesLV)."""
    return _SHARD_CHAIN + (("var_beta",) if mp.method in (METHOD_B, METHOD_LV) else ())


def _slicer(V, T, nb, p_pad, n_shards, s):
    """Functions that cut shard s's share out of a set's storage steps,
    blocks and loci: storage along its V axis (V > 1, local V = V/S) or its
    T axis (V = 1, T/S steps), per-block fields in runs of nb/S blocks,
    per-locus fields in runs of p_pad/S loci."""
    def steps(x, v_axis):
        if V > 1:
            return _take(x, v_axis, s * (V // n_shards), V // n_shards)
        return _take(x, 0, s * (T // n_shards), T // n_shards)

    def blocks(x):
        return _take(x, 0, s * (nb // n_shards), nb // n_shards)

    def loci(x):
        return _take(x, 0, s * (p_pad // n_shards), p_pad // n_shards)

    return steps, blocks, loci


def _shard_marker(ms, mp, n_shards, s):
    steps, blocks, loci = _slicer(mp.vshards, mp.n_blocks // mp.vshards, mp.n_blocks, mp.p_pad,
                                  n_shards, s)
    kw = dict(mt=steps(ms.mt, 1), center=steps(ms.center, 1), gram=steps(ms.gram, 2),
              gram_raw=steps(ms.gram_raw, 2))
    kw.update({f: blocks(getattr(ms, f)) for f in _SHARD_BLOCKS})
    kw.update({f: loci(getattr(ms, f)) for f in _SHARD_LOCI + _sharded_chain(mp)})
    return replace(ms, **kw)


def _shard_corr(cs, cp, n_shards, s):
    steps, blocks, loci = _slicer(cp.vshards, cp.n_blocks // cp.vshards, cp.n_blocks, cp.p_pad,
                                  n_shards, s)
    return replace(cs, mt=steps(cs.mt, 1), center=steps(cs.center, 1), gram=steps(cs.gram, 3),
                   mpm=blocks(cs.mpm), mask=blocks(cs.mask), region_id=loci(cs.region_id),
                   beta=loci(cs.beta))


def _local_rows(rows, p, p_pad, n_shards, s):
    """A region table (n_regions, longest) of global locus numbers padded
    with p, as shard s's region sums read it: its own loci renumbered from
    its first, each row's loci first, padded with the number of its real
    loci (markers._region_sum appends a zero there)."""
    p_l = p_pad // n_shards
    lo, n = s * p_l, ShardCtx(index=s, n_shards=n_shards).n_real(p, p_l)
    r = rows.cpu().numpy()
    inside = (r >= lo) & (r < lo + n)
    order = np.argsort(~inside, axis=1, kind="stable")
    local = np.take_along_axis(np.where(inside, r - lo, n), order, axis=1)
    width = max(1, int(inside.sum(axis=1).max()))
    return torch.as_tensor(local[:, :width].copy(), device=rows.device)


def local_plan(plan: SweepPlan, n_shards: int, index: int) -> SweepPlan:
    """The plan a shard sweeps with: its region tables index its own loci.
    The plan itself where there is one shard."""
    if n_shards == 1:
        return plan

    def rows(p):
        if p.region_rows is None:
            return p
        return replace(p, region_rows=_local_rows(p.region_rows, p.p, p.p_pad, n_shards, index))

    return replace(plan, markers=tuple(rows(mp) for mp in plan.markers),
                   corr_markers=tuple(rows(cp) for cp in plan.corr_markers))


# ------------------------------------------------------------------ refusals


def _check_shardable(plan: SweepPlan, n_shards: int) -> None:
    for cp in plan.corr_markers:
        if cp.vshards > 1:
            if cp.vshards % n_shards:
                raise ValueError(
                    f"correlated marker set {'+'.join(cp.names)}: vshards="
                    f"{cp.vshards} must be a multiple of n_shards={n_shards} "
                    f"— assemble with vshards = k * n_shards"
                )
        elif cp.n_blocks % n_shards:
            raise ValueError(
                f"correlated marker set {'+'.join(cp.names)}: n_blocks="
                f"{cp.n_blocks} is not divisible by n_shards={n_shards}; "
                f"pick a block size so nb % S == 0"
            )
    for mp in plan.markers:
        if mp.vshards > 1:
            if mp.vshards % n_shards:
                raise ValueError(
                    f"marker set {mp.name}: vshards={mp.vshards} must be a "
                    f"multiple of n_shards={n_shards} — assemble with "
                    f"vshards = k * n_shards"
                )
        elif mp.n_blocks % n_shards:
            raise ValueError(
                f"marker set {mp.name}: n_blocks={mp.n_blocks} is not "
                f"divisible by n_shards={n_shards}; pick a block size so "
                f"blocks split evenly across shards"
            )


def _check_asked(plan: SweepPlan, n_shards: int) -> None:
    """Refuse a V that assemble lowered from the one asked for (to its
    largest divisor of the block count) where the shards do not divide it:
    the sharded chain would be neither the asked-for schedule nor one the
    caller chose. The JAX package shards such a plan silently."""
    for p, kind, name in [(mp, "marker set", mp.name) for mp in plan.markers] + [
            (cp, "correlated marker set", "+".join(cp.names)) for cp in plan.corr_markers]:
        if p.vshards_asked != p.vshards and p.vshards % n_shards:
            raise ValueError(
                f"{kind} {name}: vshards={p.vshards_asked} was asked for, but its "
                f"n_blocks={p.n_blocks} gave V={p.vshards} (the largest divisor), which is "
                f"not a multiple of n_shards={n_shards}; assemble with a vshards = k * "
                f"n_shards that divides n_blocks")


# ------------------------------------------------------------------ placing and sweeping


def distribute(plan: SweepPlan, state: ModelState, mesh: Mesh, n_chains: int):
    """This rank's state on the mesh: its chain's fields (state may be
    batched on a leading chains axis, as a checkpoint holds it, or one state
    that every chain starts from) and its shard's contiguous copies of the
    marker storage, blocks and loci; every other field is the state's own.
    Nothing is kept of the global tensors it cut, so they are freed once the
    caller drops `state`. None on a rank that the mesh does not hold."""
    n_shards = mesh.shape[SHARDS]
    if mesh.shape[CHAINS] != n_chains:
        raise ValueError(f"distribute: {n_chains} chains on a mesh of {mesh.shape[CHAINS]} "
                         "chain rows (one chain a row)")
    _check_asked(plan, n_shards)
    _check_shardable(plan, n_shards)
    at = mesh.coords()
    if at is None:
        return None
    c, s = at
    if isinstance(state.sweep_index, torch.Tensor):
        state = pick_chain(state, c)
    if n_shards == 1:
        return state
    return replace(
        state,
        markers=tuple(_shard_marker(ms, mp, n_shards, s)
                      for ms, mp in zip(state.markers, plan.markers)),
        corr_markers=tuple(_shard_corr(cs, cp, n_shards, s)
                           for cs, cp in zip(state.corr_markers, plan.corr_markers)))


def make_sharded_sweep(plan: SweepPlan, mesh: Mesh, n_sweeps: int = 1):
    """step(local_state, stream) -> local_state: `n_sweeps` sweeps of this
    rank's chain on its share (distribute), eagerly, with the psums over
    its row. `stream` is the chain's draw stream (the JAX function takes
    the chains' keys instead). Marker sets assembled with vshards=V run the
    V-wide schedule split across the row (V/S local block chains a rank):
    the chain equals the single-rank V chain. `step.plan` is the plan the
    shard sweeps with, `step.ctx` its ShardCtx."""
    n_shards = mesh.shape[SHARDS]
    _check_shardable(plan, n_shards)
    ctx = mesh.ctx()
    lplan = local_plan(plan, n_shards, ctx.index)
    sweep = make_sweep(lplan, ctx)

    def step(local: ModelState, stream) -> ModelState:
        for _ in range(n_sweeps):
            local = sweep(local, stream)
        return local

    step.plan, step.ctx = lplan, ctx
    return step


def gather_chain(local: ModelState, plan: SweepPlan, ctx: ShardCtx) -> ModelState:
    """`local` with its sharded chain fields gathered over the row into
    global locus order (one all_gather each), the same on every rank of the
    row; its constant fields stay the rank's share. What collect_sample and
    a checkpoint read."""
    if ctx.n_shards == 1:
        return local

    def cat(t):
        parts = [torch.empty_like(t) for _ in range(ctx.n_shards)]
        dist.all_gather(parts, t.contiguous(), group=ctx.group)
        return torch.cat(parts)

    markers = tuple(replace(ms, **{f: cat(getattr(ms, f)) for f in _sharded_chain(mp)
                                   if getattr(ms, f) is not None})
                    for ms, mp in zip(local.markers, plan.markers))
    corr = tuple(replace(cs, beta=cat(cs.beta)) for cs in local.corr_markers)
    return replace(local, markers=markers, corr_markers=corr)

