"""One Gibbs sweep over all effect families, and the chain runners.

Stage order as in `nextgp_tpu/engine/sweep.py` (and NextGP.jl's
runSampler!, samplers.jl:29-53): residual variance -> fixed-effect blocks
-> random effects (with their variances) -> marker sets -> correlated
marker sets. PyTorch runs
eagerly: a sweep launches its kernels on the current CUDA stream without
waiting for them (a CG random term's solve is one launch, CG1, which
decides its stopping rule on the card). The stages carry the JAX package's
scope names (`gibbs.var_e`, `gibbs.fixed.<i>`, `gibbs.random.<i>`,
`gibbs.marker.<set>`, `gibbs.corr_marker`) as
`torch.profiler.record_function` scopes, so a trace (`diag.trace`)
attributes host and device time to them.

The runners are the counterparts of the JAX package's `make_chain_runner`
(a jitted `lax.scan` over a thinning interval) and `make_scan_sampler` (the
whole chain on the device). On the card with a stream that can be captured
(`KeyedStream`, whose draws read the state's device sweep counter) they
capture one sweep in a CUDA graph, and one sweep that also writes its sample
into slot k of preallocated draw buffers (k a device index), and replay
them: the host issues one replay a sweep. Everywhere else a thinning
interval is a Python loop of sweeps. `Chain` is the one driver of a whole
chain: `scan_chain` (so `make_scan_sampler`) and the runtime's `run_lmem`
and `run_chains` run through it, and `_replayed` makes its choice between
replays and eager sweeps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch.profiler import record_function

from ..utils import replace
from .plan import (
    METHOD_B, METHOD_C, METHOD_LV, METHOD_R, METHOD_RCPI, METHOD_RCPLUS, SweepPlan,
)
from .rng import STAGE_FIXED, STAGE_MARKER, STAGE_RANDOM, STAGE_VAR_E, Site
from .samplers.fixed import sample_fixed_block
from .samplers.markers import sample_corr_marker_set, sample_marker_set
from .samplers.random_effects import sample_random_cg, sample_random_corr, sample_random_uni
from .samplers.residual import sample_var_e
from .state import ModelState


def make_sweep(plan: SweepPlan):
    """Build sweep(state, stream) -> state for the static plan. The draw
    sites are named by state.sweep_index (and, for a KeyedStream, by the
    same number in state.sweep_counter on the device), so a chain is a
    function of the stream's seed and the starting state. After each call
    `sweep.cg_iterations` maps each CG random term's index to the number of
    CG iterations its solve took in that sweep, a 0-d int32 tensor on the
    plan's device (reading it is the caller's sync)."""

    def sweep(state: ModelState, stream) -> ModelState:
        s, c = state.sweep_index, state.sweep_counter
        ycorr = state.ycorr
        with record_function("gibbs.var_e"):
            var_e = sample_var_e(stream, Site(s, STAGE_VAR_E, counter=c), state.e, ycorr, plan.n,
                                 plan.e_df)

        fixed = []
        for i, (fs, fp) in enumerate(zip(state.fixed, plan.fixed)):
            with record_function(f"gibbs.fixed.{i}"):
                b, ycorr = sample_fixed_block(stream, Site(s, STAGE_FIXED, i, counter=c), fs, ycorr,
                                              var_e, fp.single)
            fixed.append(replace(fs, b=b))

        random = []
        for i, (rs, rp) in enumerate(zip(state.random, plan.random)):
            site = Site(s, STAGE_RANDOM, i, counter=c)
            with record_function(f"gibbs.random.{i}"):
                if rp.correlated:
                    u, var_u, ycorr = sample_random_corr(stream, site, rs, ycorr, var_e, rp.df)
                elif rp.sampler == "cg":
                    u, var_u, ycorr, sweep.cg_iterations[i] = sample_random_cg(
                        stream, site, rs, ycorr, var_e, rp.df, rp, d_inv=state.e.d_inv)
                else:
                    u, var_u, ycorr = sample_random_uni(stream, site, rs, ycorr, var_e, rp.df)
            random.append(replace(rs, u=u, var_u=var_u))

        markers = []
        for i, (ms, mp) in enumerate(zip(state.markers, plan.markers)):
            with record_function(f"gibbs.marker.{mp.name}"):
                ms, ycorr = sample_marker_set(stream, Site(s, STAGE_MARKER, i, counter=c), ms, mp,
                                              ycorr, var_e, state.e.d_inv)
            markers.append(ms)

        corr_markers = []
        for i, (cs, cp) in enumerate(zip(state.corr_markers, plan.corr_markers)):
            site = Site(s, STAGE_MARKER, len(plan.markers) + i, counter=c)
            with record_function("gibbs.corr_marker"):
                cs, ycorr = sample_corr_marker_set(stream, site, cs, cp, ycorr, var_e)
            corr_markers.append(cs)

        return replace(state, ycorr=ycorr, e=replace(state.e, var_e=var_e), fixed=tuple(fixed),
                       random=tuple(random), markers=tuple(markers), sweep_index=s + 1,
                       corr_markers=tuple(corr_markers), sweep_counter=c + 1)

    sweep.cg_iterations = {}
    return sweep


def collect_sample(state: ModelState, plan: SweepPlan) -> Dict[str, Any]:
    """The tracked quantities the reference streams per kept iteration
    (samplers.jl:56-104): b, varE, u/varU per random term (a correlated
    group's names joined by "_"), and beta/delta/var per marker set, with
    the per-locus variances cut to p (BayesB, BayesLV), pi where the method
    has one (BayesB/C/R; flattened (A, K) for BayesRCpi/RCplus, with the
    annotation categories), and c and varZeta for BayesLV; per correlated
    marker set, beta of each set and var (names joined by "_") as
    (n_regions, nT^2)."""
    out: Dict[str, Any] = {"varE": state.e.var_e}
    if state.fixed:
        out["b"] = torch.cat([fs.b for fs in state.fixed])
    for rs, rp in zip(state.random, plan.random):
        nm = rp.name if isinstance(rp.name, str) else "_".join(rp.name)
        out[f"u{nm}"] = rs.u
        out[f"varU{nm}"] = rs.var_u
    for ms, mp in zip(state.markers, plan.markers):
        out[f"beta{mp.name}"] = ms.beta[: mp.p]
        out[f"delta{mp.name}"] = ms.delta[: mp.p]
        out[f"var{mp.name}"] = ms.var_beta[: mp.p] if mp.n_var == mp.p_pad else ms.var_beta
        if mp.method in (METHOD_B, METHOD_C, METHOD_R):
            out[f"pi{mp.name}"] = ms.pi_hat
        if mp.method in (METHOD_RCPI, METHOD_RCPLUS):
            out[f"pi{mp.name}"] = ms.pi_hat.reshape(-1)
            out[f"annot{mp.name}"] = ms.annot_cat[: mp.p]
        if mp.method == METHOD_LV:
            out[f"c{mp.name}"] = ms.lv_c
            out[f"varZeta{mp.name}"] = ms.var_zeta
    for cs, cp in zip(state.corr_markers, plan.corr_markers):
        for t, nm in enumerate(cp.names):
            out[f"beta{nm}"] = cs.beta[: cp.p, t]
        out[f"var{'_'.join(cp.names)}"] = cs.var_beta.reshape(cp.n_regions, -1)
    return out


# ------------------------------------------------------------------ replayed sweeps


def _leaves(obj, prefix=""):
    """{"markers.0.beta": tensor, ...}: the tensors of a state, None fields
    left out."""
    if isinstance(obj, torch.Tensor):
        return {prefix: obj}
    out = {}
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            out.update(_leaves(getattr(obj, f.name), f"{prefix}{f.name}."))
    elif isinstance(obj, tuple):
        for i, x in enumerate(obj):
            out.update(_leaves(x, f"{prefix}{i}."))
    return out


def _with_leaves(obj, new, prefix=""):
    """obj with the tensors at the keys of `new` (as `_leaves` names them)
    replaced."""
    if isinstance(obj, torch.Tensor):
        return new.get(prefix, obj)
    if dataclasses.is_dataclass(obj):
        return replace(obj, **{f.name: _with_leaves(getattr(obj, f.name), new, f"{prefix}{f.name}.")
                               for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_with_leaves(x, new, f"{prefix}{i}.") for i, x in enumerate(obj))
    return obj


def _replayed(plan: SweepPlan, stream, eager_ok: bool = False) -> bool:
    """Whether a chain replays CUDA graphs: on the card, where the stream
    must be one that can be captured. A stream that cannot is run as eager
    sweeps where `eager_ok`, else refused."""
    if plan.device.type != "cuda":
        return False
    if getattr(stream, "capturable", False):
        return True
    if eager_ok:
        return False
    raise TypeError(
        f"{type(stream).__name__} cannot be captured in a CUDA graph (its draws are seeded on "
        "the host, so a replay would repeat the captured sweep's numbers): pass a KeyedStream "
        "to run replayed sweeps on the card")


class ReplayedSweep:
    """One sweep of `plan` captured in a CUDA graph (`sweep`) and, where
    n_keep > 0, one that also writes collect_sample into slot `slot` of the
    (n_keep, ...) buffers `draws` and advances the slot (`keep`). Both run on
    `static`, a copy of the starting state whose carried tensors (those a
    sweep replaces) are buffers of their own: each captured sweep ends by
    copying its outputs back into them, so a replay reads what the last
    replay left. Every other tensor is the starting state's own.

    Before capture one sweep runs eagerly on the capture stream, so that
    what the kernels allocate at first use (K2's tickets, keyed by stream)
    and the libraries' handles exist outside the graphs' memory. A capture
    that fails raises: nothing falls back to eager sweeps.

    `cg_iterations` maps each CG random term's index to a 0-d int32 buffer
    that both graphs write: after a replay it holds that replay's count."""

    def __init__(self, plan: SweepPlan, state: ModelState, stream, n_keep: int = 0):
        if not _replayed(plan, stream):
            raise ValueError(f"a CUDA graph needs the card; the plan's device is {plan.device}")
        sweep = make_sweep(plan)
        dev = plan.device
        main = torch.cuda.current_stream(dev)
        self.side = side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            warm = sweep(state, stream)
            sample = collect_sample(warm, plan)
        main.wait_stream(side)
        before, after = _leaves(state), _leaves(warm)
        self.carried = [k for k, t in before.items() if after[k] is not t]
        self.static = _with_leaves(state, {k: before[k].clone() for k in self.carried})
        self.fixed_leaves = {k: t for k, t in before.items() if k not in self.carried}
        self.draws = {nm: v.new_empty((n_keep,) + v.shape) for nm, v in sample.items()}
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.cg_iterations = {i: t.clone() for i, t in sweep.cg_iterations.items()}
        del warm, sample
        self.stream = stream
        self.sweep = self._capture(sweep, plan, keep=False)
        self.keep = self._capture(sweep, plan, keep=True) if n_keep else None

    def _capture(self, sweep, plan, keep):
        graph = torch.cuda.CUDAGraph()
        static = _leaves(self.static)
        with torch.cuda.graph(graph, stream=self.side):
            out = _leaves(sweep(self.static, self.stream))
            for k in self.carried:
                static[k].copy_(out[k])
            for i, t in self.cg_iterations.items():
                t.copy_(sweep.cg_iterations[i])
            if keep:
                for nm, v in collect_sample(self.static, plan).items():
                    self.draws[nm].index_copy_(0, self.slot, v.unsqueeze(0))
                self.slot.add_(1)
        return graph

    def holds(self, state: ModelState, stream) -> bool:
        """Whether `state` runs on these graphs: the same stream and the
        same constant tensors (the carried ones are loaded with `load`)."""
        leaves = _leaves(state)
        return stream is self.stream and leaves.keys() == _leaves(self.static).keys() and all(
            leaves[k] is t for k, t in self.fixed_leaves.items())

    def load(self, state: ModelState) -> None:
        """Copy state's carried tensors into the static buffers, where they
        are not those buffers already."""
        static, leaves = _leaves(self.static), _leaves(state)
        for k in self.carried:
            if leaves[k] is not static[k]:
                static[k].copy_(leaves[k])

    def run(self, n_sweeps: int, n_keep: int = 0, thin: int = 1) -> None:
        """n_sweeps replays of the sweep, then n_keep thinning intervals of
        thin sweeps, the last of each kept into the next slot."""
        for _ in range(n_sweeps):
            self.sweep.replay()
        if n_keep:
            self.slot.zero_()
        for _ in range(n_keep):
            for _ in range(thin - 1):
                self.sweep.replay()
            self.keep.replay()

    def state(self, sweep_index: int) -> ModelState:
        return replace(self.static, sweep_index=sweep_index)


class Chain:
    """One chain of `plan` from `state` with `stream`, `thin` sweeps a kept
    sample. On the card with a stream that can be captured (KeyedStream) the
    sweeps are replays of a ReplayedSweep with room for `room` kept samples;
    on the CPU, and on the card with another stream where `eager_ok`, they
    are a loop of eager sweeps (without `eager_ok` such a stream raises).
    `keep(m)` runs m thinning intervals and returns their samples, the keys
    of collect_sample each stacked with a leading m, on the plan's device:
    on the card views of the replays' buffers, which the next `keep`
    overwrites."""

    def __init__(self, plan: SweepPlan, state: ModelState, stream, thin: int, room: int,
                 eager_ok: bool = False):
        self.plan, self.stream, self.thin = plan, stream, thin
        self.index = state.sweep_index
        self.rep = None
        if _replayed(plan, stream, eager_ok):
            self.rep = ReplayedSweep(plan, state, stream, room)
        else:
            self.sweep, self._state = make_sweep(plan), state

    def burn(self, n: int) -> None:
        if self.rep is not None:
            self.rep.run(n)
        else:
            for _ in range(n):
                self._state = self.sweep(self._state, self.stream)
        self.index += n

    def keep(self, m: int) -> Dict[str, torch.Tensor]:
        self.index += m * self.thin
        if self.rep is not None:
            self.rep.run(0, m, self.thin)
            return {nm: v[:m] for nm, v in self.rep.draws.items()}
        kept = []
        for _ in range(m):
            for _ in range(self.thin):
                self._state = self.sweep(self._state, self.stream)
            kept.append(collect_sample(self._state, self.plan))
        return {nm: torch.stack([s[nm] for s in kept]) for nm in kept[0]} if kept else {}

    @property
    def state(self) -> ModelState:
        return self.rep.state(self.index) if self.rep is not None else self._state


def scan_chain(plan: SweepPlan, state: ModelState, stream, n_burn: int, n_keep: int, thin: int):
    """n_burn sweeps, then n_keep thinning intervals of `thin` sweeps, as one
    Chain. Returns (state, draws): the keys of collect_sample, each stacked
    with a leading n_keep, on the plan's device. On the card the sweeps are
    graph replays (the stream must be capturable: KeyedStream; any other
    raises), and the state returned holds the graphs' static buffers; on the
    CPU they are a loop of sweeps."""
    chain = Chain(plan, state, stream, thin, n_keep)
    chain.burn(n_burn)
    draws = chain.keep(n_keep)
    return chain.state, draws


def make_chain_runner(plan: SweepPlan, thin: int):
    """run_thin(state, stream) -> (state, sample): `thin` sweeps, then the
    sample of the last one. On the card with a KeyedStream the sweeps are
    replays of graphs captured at the first call (and again when the stream
    or the state's constant tensors change), as the JAX package jits its
    runner once; the state and the sample returned then live in the
    runner's buffers and the next call overwrites them, as the JAX runner
    donates its state. Otherwise (the CPU, or the card with PhiloxStream or
    HostStream) a loop of eager sweeps."""
    sweep = make_sweep(plan)
    cache = []

    def run_thin(state, stream):
        if _replayed(plan, stream, eager_ok=True):
            if not cache or not cache[0].holds(state, stream):
                cache[:] = [ReplayedSweep(plan, state, stream, n_keep=1)]
            rep = cache[0]
            rep.load(state)
            rep.run(0, 1, thin)
            return rep.state(state.sweep_index + thin), {nm: v[0] for nm, v in rep.draws.items()}
        for _ in range(thin):
            state = sweep(state, stream)
        return state, collect_sample(state, plan)

    return run_thin


def make_scan_sampler(plan: SweepPlan, n_keep: int, thin: int):
    """Whole-chain runner, the counterpart of the JAX package's
    make_scan_sampler (nextgp_tpu/engine/sweep.py:142-162): run(state,
    stream) -> (state, draws), n_keep thinning intervals of `thin` sweeps,
    draws the keys of collect_sample each stacked with a leading n_keep, on
    the plan's device. On the card it replays CUDA graphs (one sweep per
    replay) and needs a stream that can be captured (KeyedStream): any
    other raises, naming the stream; it never falls back to eager sweeps.
    On the CPU it runs the same sweeps as a loop."""

    def run(state, stream):
        return scan_chain(plan, state, stream, 0, n_keep, thin)

    return run
