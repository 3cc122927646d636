"""High-level entry points: `run_lmem`, `prep`, `run_chains` and `model_card`.

Counterparts of `nextgp_tpu/runtime.py` (NextGP.jl's runLMEM and prep,
MCMC.jl:31-41, prepMatVec.jl:39-176) with the JAX package's names,
signatures, defaults and file formats, so that a script written for
`nextgp_tpu` runs unchanged: wipe the output folder -> build the model ->
run the chain with thinned output -> leave `<quantity>Out` files for
`summary_mcmc`, with checkpoints and exact resume. The port adds `device=`
(the card unless "cpu"; without a card the entry points raise before they
touch the disk) and the draw streams (`stream=`, `streams=`;
engine/rng.py).

Each chain runs as an engine/sweep.Chain: on the card with a stream that
can be captured (KeyedStream), CUDA-graph replays that keep their samples
on the card. The host copies the quantities it keeps once a chunk of kept
samples, never once a sweep: once at the end where nothing is written,
else every `_CHUNK` kept samples and at every checkpoint.
"""
from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from .api.spec import ModelSpec
from .engine.plan import SweepPlan, assemble
from .engine.rng import PhiloxStream, _splitmix64
from .engine.state import ModelState, chain_leaves
from .engine.sweep import Chain, _with_leaves, collect_sample
from .io.checkpoint import (
    constants_digest, load_checkpoint, plan_fingerprint, read_meta, save_checkpoint,
)
from .io.summary import ess_bulk, split_rhat
from .io.writer import MCMCWriter, folder_handler, truncate_outputs
from .utils import default_device, replace

_CHUNK = 32  # kept samples between host copies of a replayed chain that writes files


def _headers(spec: ModelSpec, plan: SweepPlan) -> Dict[str, List[str]]:
    """Column headers matching the reference's output files (mme.jl:541-596)."""
    h: Dict[str, List[str]] = {"varE": ["e"]}
    blevels: List[str] = []
    by_name = {t.name: t for t in spec.fixed}
    for fp in plan.fixed:
        names = fp.name if isinstance(fp.name, tuple) else (fp.name,)
        for nm in names:
            t = by_name[nm]
            blevels += list(t.levels) if t.levels else (
                [nm] if t.n_col == 1 else [f"{nm}_{i + 1}" for i in range(t.n_col)]
            )
    if blevels:
        h["b"] = blevels
    for t, rp in zip(spec.random, plan.random):
        nm = rp.name if isinstance(rp.name, str) else "_".join(rp.name)
        lv = list(t.levels) if t.levels else [f"{nm}{i + 1}" for i in range(rp.q)]
        h[f"u{nm}"] = lv
        h[f"varU{nm}"] = [nm] if not rp.correlated else [
            f"{nm}_{i + 1}" for i in range(rp.n_t**2)
        ]
    for t, mp in zip(spec.markers, plan.markers):
        h[f"beta{mp.name}"] = list(t.data.snp_ids)
        h[f"delta{mp.name}"] = list(t.data.snp_ids)
        if mp.n_var == mp.p_pad:
            h[f"var{mp.name}"] = [f"reg_{i + 1}" for i in range(mp.p)]
        else:
            h[f"var{mp.name}"] = [f"reg_{i + 1}" for i in range(mp.n_var)]
        if mp.method in ("BayesB", "BayesC", "BayesR"):
            h[f"pi{mp.name}"] = [f"pi{v + 1}" for v in range(max(mp.n_classes, 2))]
        if mp.method in ("BayesRCpi", "BayesRCplus"):
            h[f"pi{mp.name}"] = [f"pi{v + 1}" for v in range(mp.n_classes * mp.n_annot)]
            h[f"annot{mp.name}"] = list(t.data.snp_ids)
        if mp.method == "BayesLV":
            h[f"c{mp.name}"] = [f"c{v + 1}" for v in range(mp.n_lv_cov)]
            h[f"varZeta{mp.name}"] = ["varZeta"]
    for ct, cp in zip(getattr(spec, "corr_markers", []), plan.corr_markers):
        for t, nm in enumerate(cp.names):
            ids = getattr(ct.datas[t], "snp_ids", None)
            h[f"beta{nm}"] = list(ids) if ids is not None else [
                f"{nm}_{i + 1}" for i in range(cp.p)]
        h[f"var{'_'.join(cp.names)}"] = [
            f"reg{r + 1}_{i + 1}_{j + 1}"
            for r in range(cp.n_regions)
            for i in range(cp.n_t) for j in range(cp.n_t)
        ]
    return h


def model_card(spec: ModelSpec, plan: SweepPlan, state=None) -> str:
    """Assemble-time summary of the resolved model: what the reference
    prints as input/analysis tables (prepMatVec.jl:172-173, mme.jl:537-538)
    and green prior-resolution notices (mme.jl:29-41,67-80,290,336). Every
    silently-substituted default is spelled out. With `state` (the
    assembled ModelState) the resolved prior scales are shown too — the
    reference's analysis-summary `scale` column (mme.jl:537-538). The text
    is the JAX package's, line for line; the port has no Pallas flag, and
    its marker sets are always 2-bit packed."""

    def _sc(container, i):
        if state is None:
            return ""
        try:
            s = getattr(state, container)[i].scale.detach().cpu().numpy()
            if s.ndim == 0:
                return f", scale {float(s):g}"
            flat = s.ravel()
            if flat.size <= 6:
                return ", scale [" + ", ".join(f"{float(x):g}" for x in flat) + "]"
            head = ", ".join(f"{float(x):g}" for x in flat[:3])
            return f", scale [{head}, ...] ({flat.size} regions)"
        except (AttributeError, IndexError, TypeError, ValueError):
            return ""

    dtype = str(plan.dtype).removeprefix("torch.")
    lines = [f"Model: n = {plan.n} observations, dtype {dtype}"]
    res = spec.residual
    if res is None:
        lines.append("  residual: Random('I', 100.0)  [default — no 'e' prior given]")
    else:
        s = res.str_ if isinstance(res.str_, str) else "D (weights)"
        lines.append(f"  residual: Random({s!r}, {res.v})")
    e_sc = "" if state is None else f", scale = {float(state.e.scale):g}"
    lines.append(f"    df = {plan.e_df}{e_sc}, weighted = {plan.weighted}")
    for fp in plan.fixed:
        nm = fp.name if isinstance(fp.name, str) else " + ".join(fp.name)
        kind = "blocked fixed" if isinstance(fp.name, tuple) else "fixed"
        lines.append(f"  {kind}: {nm}  ({fp.k} column{'s' if fp.k != 1 else ''})")
    # positional spec<->plan pairing: names can repeat (PED(Dam) + (1|Dam)
    # are both "Dam"), so a name-keyed dict would collapse them
    positional = len(spec.random) == len(plan.random)
    by_name = {t.name: t for t in spec.random}
    for i, rp in enumerate(plan.random):
        nm = rp.name if isinstance(rp.name, str) else " + ".join(rp.name)
        t = spec.random[i] if positional else by_name.get(rp.name)
        label = getattr(t, "structure_label", None) or "I"
        dflt = "" if (t is None or t.prior is not None) else "  [default Random('I', 100.0)]"
        corr = ", correlated" if rp.correlated else ""
        lines.append(
            f"  random: {nm}  ({rp.q} levels, structure {label}, "
            f"sampler {rp.sampler}{corr}, df {rp.df}{_sc('random', i)}){dflt}"
        )
    spec_m = {t.name: t for t in spec.markers}
    for mi, mp in enumerate(plan.markers):
        t = spec_m.get(mp.name)
        dflt = (
            "  [default BayesPR(9999, 0.05) — no prior given]"
            if (t is not None and t.prior is None)
            else ""
        )
        extra = []
        if mp.n_classes:
            extra.append(f"{mp.n_classes} classes")
        if mp.n_annot:
            extra.append(f"{mp.n_annot} annotations")
        if mp.method == "BayesPR":
            extra.append(f"{mp.n_regions} region{'s' if mp.n_regions != 1 else ''}")
        if mp.est_pi:
            extra.append("estimate pi")
        extra.append(f"df {mp.df}{_sc('markers', mi)}")
        extra.append(f"block {mp.block} x {mp.n_blocks}")
        if mp.vshards > 1:
            extra.append(f"vshards {mp.vshards}")
        lines.append(
            f"  markers: {mp.name}  ({mp.method}, {mp.p} loci, "
            + ", ".join(extra) + f"){dflt}"
        )
    for ci, cp in enumerate(plan.corr_markers):
        extra = ""
        if state is not None and state.corr_markers[ci].mt.dtype == torch.uint8:
            extra = ", 2-bit packed"
        if cp.vshards > 1:
            extra += f", vshards {cp.vshards}"
        lines.append(
            f"  correlated markers: {' + '.join(cp.names)}  "
            f"(BayesPR, {cp.p} loci, {cp.n_t} sets, {cp.n_regions} regions"
            f"{extra})"
        )
    for key in spec.summary_stats:
        nm = key if isinstance(key, str) else " + ".join(key)
        lines.append(f"  summary statistics attached to: {nm}")
    return "\n".join(lines)


def _write_group_infos(spec: ModelSpec, out_folder: str) -> None:
    """groupInfo_<set>.txt per mapped BayesPR marker set, as the reference
    emits during setup (prep2RegionData, misc.jl:209)."""
    from .api import priors as P
    from .data.regions import build_regions, write_group_info

    for t in spec.markers:
        ci = getattr(t.data, "chr_ids", None)
        if ci is None or not isinstance(t.prior, P.BayesPR):
            continue
        info = build_regions(t.data.n_snp, t.prior.r, ci)
        write_group_info(out_folder, t.name, t.data.snp_ids, ci, info,
                         r=t.prior.r)


@dataclass
class LMEMResult:
    plan: SweepPlan
    state: Any
    draws: Dict[str, np.ndarray] = field(default_factory=dict)
    out_folder: Optional[str] = None
    sweeps_per_sec: float = 0.0

    def posterior_mean(self, name: str) -> np.ndarray:
        return np.asarray(self.draws[name]).mean(axis=0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _drive(plan, states, streams, n_burn, n_keep, n_thin, *, writers, track, keep_in_memory,
           checkpoint: Optional[Callable], every: int, progress: bool):
    """Run each chain from its state (all at one sweep index): what is left
    of the burn-in, then the kept intervals not yet run. The chains take
    turns a chunk of kept samples at a time, so that their writers and the
    checkpoint advance together; a chunk ends at each multiple of `every`
    (where `checkpoint(chains, kept_rows)` is called after the writers are
    flushed) and, where anything is written, after `_CHUNK` kept samples.
    Returns (final states, per chain {name: [arrays]}, seconds)."""
    done = states[0].sweep_index
    k = max(0, done - n_burn) // n_thin
    cap = _CHUNK if (writers or checkpoint) else max(1, n_keep - k)
    _sync(plan.device)
    t0 = time.perf_counter()
    chains = [Chain(plan, s, st, n_thin, min(cap, max(0, n_keep - k)), eager_ok=True)
              for s, st in zip(states, streams)]
    for c in chains:
        c.burn(max(0, n_burn - done))
    draws: List[Dict[str, list]] = [{} for _ in chains]
    while k < n_keep:
        end = min(n_keep, k + cap)
        if checkpoint:
            end = min(end, (k // every + 1) * every)
        for i, c in enumerate(chains):
            kept = c.keep(end - k)  # on the card, copied below before the next replay
            names = list(kept) if track == "all" else [nm for nm in track if nm in kept]
            rows = {nm: kept[nm].cpu().numpy() for nm in names}
            if writers:
                for j in range(end - k):
                    writers[i].put({nm: rows[nm][j] for nm in names})
            if keep_in_memory:
                for nm in names:
                    draws[i].setdefault(nm, []).append(rows[nm])
        if progress:
            for j in range(k + 1, end + 1):
                if j % max(1, n_keep // 10) == 0:
                    print(f"  kept {j}/{n_keep}")
        k = end
        if checkpoint and k % every == 0:
            for w in writers:
                w.flush()
            checkpoint([c.state for c in chains], k)
    _sync(plan.device)
    return [c.state for c in chains], draws, time.perf_counter() - t0


def run_lmem(
    spec: ModelSpec,
    n_chain: int,
    n_burn: int,
    n_thin: int,
    out_folder: Optional[str] = "outMCMC",
    seed: int = 0,
    dtype=None,
    keep_in_memory: bool = True,
    progress: bool = False,
    vshards="auto",
    checkpoint_every: int = 0,
    resume: bool = False,
    device=None,
    stream=None,
) -> LMEMResult:
    """Single-chain MCMC mirroring runLMEM (MCMC.jl:31-41).

    Kept iterations are `(n_burn + n_thin) : n_thin : n_chain`
    (samplers.jl:26) — honored exactly for any (n_burn, n_thin), including
    `n_burn % n_thin != 0`. Kept draws are returned in memory as stacked
    numpy arrays (keep_in_memory) and, with out_folder, written to
    `<out_folder>/<quantity>Out` files in the reference layout (the folder
    is wiped first, and groupInfo_<set>.txt written for mapped BayesPR
    sets).

    vshards defaults to "auto", which is 1 (the reference-sequential
    order), as the JAX package resolves it off its TPU kernel path: the
    H100's rule has not been measured. `stream` overrides the default
    PhiloxStream(seed) (engine/rng.py), whose chain runs as eager sweeps; a
    KeyedStream runs on the card as CUDA-graph replays. `device`: where the
    model is assembled and swept (the card unless "cpu"; without a card
    this raises before the output folder is touched).

    checkpoint_every=k writes `<out_folder>/chain.ckpt` every k kept samples
    (atomic, exact-resume: every draw is keyed by its sweep, io/checkpoint.py).
    resume=True restarts from that file if present — output files are then
    cut back to the checkpoint's rows and appended to, not wiped.
    `sweeps_per_sec` counts the sweeps this call ran, to the device
    finishing the last.
    """
    device = torch.device(device) if device is not None else default_device()
    ckpt_path = os.path.join(out_folder, "chain.ckpt") if out_folder else None
    resuming = bool(resume and ckpt_path and os.path.exists(ckpt_path))
    if out_folder and not resuming:
        folder_handler(out_folder)
        _write_group_infos(spec, out_folder)
    plan, state = assemble(spec, dtype=dtype, device=device, vshards=vshards)
    if progress:
        print(model_card(spec, plan, state))
    stream = stream or PhiloxStream(seed, plan.device, plan.dtype)
    fingerprint = plan_fingerprint(plan)
    saves = bool(checkpoint_every and ckpt_path)
    digest = constants_digest(state) if (saves or resuming) else None

    if resuming:
        state = load_checkpoint(ckpt_path, state, fingerprint=fingerprint, constants=digest)
        meta = read_meta(ckpt_path)
        if "kept_rows" in meta:
            # rows spooled after the checkpoint would be re-emitted below;
            # cut the files back so resume is exact for outputs too
            truncate_outputs(out_folder, int(meta["kept_rows"]))
        if progress:
            print(f"  resumed at sweep {state.sweep_index}")

    def checkpoint(states, kept_rows):
        save_checkpoint(ckpt_path, states[0], meta={
            "fingerprint": fingerprint, "kept_rows": kept_rows, "constants": digest})

    writer = MCMCWriter(out_folder, None if resuming else _headers(spec, plan)) if out_folder else None
    n_keep = (n_chain - n_burn) // n_thin
    done = state.sweep_index
    try:
        (state,), (draws,), dt = _drive(
            plan, [state], [stream], n_burn, n_keep, n_thin, writers=[writer] if writer else [],
            track="all", keep_in_memory=keep_in_memory, checkpoint=checkpoint if saves else None,
            every=checkpoint_every, progress=progress)
    finally:
        if writer:
            writer.close()
    ran = n_burn + n_keep * n_thin - done
    return LMEMResult(
        plan=plan,
        state=state,
        draws={k: np.concatenate(v) for k, v in draws.items()},
        out_folder=out_folder,
        sweeps_per_sec=ran / dt if dt > 0 else 0.0,
    )


def prep(spec: ModelSpec, dtype=None, device=None):
    """Standalone model inspection, mirroring exported `prep`
    (prepMatVec.jl:39-176): returns (plan, state) without sampling, on the
    card unless device="cpu"."""
    return assemble(spec, dtype=dtype, device=device)


def chain_seed(seed: int, c: int) -> int:
    """The default PhiloxStream seed of chain c of `run_chains`:
    splitmix64(splitmix64(seed) ^ c) (engine/rng.py's mixer), distinct for
    every chain of one seed."""
    return _splitmix64(_splitmix64(seed & ((1 << 64) - 1)) ^ c)


def _stack(states: List[ModelState]) -> ModelState:
    """One ModelState whose _CHAIN_FIELDS hold the chains' values stacked on
    a leading chain axis (sweep_index a (C,) int64 tensor); the other
    fields are the first chain's, which every chain shares."""
    leaves = [chain_leaves(s) for s in states]
    new = {k: torch.stack([lv[k] for lv in leaves]) for k in leaves[0]}
    index = torch.tensor([s.sweep_index for s in states], dtype=torch.int64,
                         device=states[0].ycorr.device)
    return replace(_with_leaves(states[0], new), sweep_index=index)


def _pick(batched: ModelState, c: int) -> ModelState:
    """Chain c of a chains-batched state (the inverse of `_stack`): chain c
    of every _CHAIN_FIELDS tensor, and its sweep index."""
    leaves = {k: v[c] for k, v in chain_leaves(batched).items()}
    return replace(_with_leaves(batched, leaves), sweep_index=int(batched.sweep_index[c]))


def run_chains(
    spec: ModelSpec,
    n_chains: int,
    n_chain: int,
    n_burn: int,
    n_thin: int,
    seed: int = 0,
    dtype=None,
    n_shards: Optional[int] = None,
    mesh=None,
    track=("varE",),
    out_folder: Optional[str] = None,
    vshards="auto",
    checkpoint_every: int = 0,
    resume: bool = False,
    progress: bool = False,
    device=None,
    streams=None,
) -> Dict[str, Any]:
    """Several chains of one model with built-in cross-chain convergence
    diagnostics — the reference runs one chain and defers diagnostics to
    user-side MCMCChains scripts (docs/src/index.md:62-88).

    On one card the chains run in turn, a chunk of kept samples each, on
    one assembled state (the constant tensors are shared), each with its own
    runner (on the card with KeyedStreams, its own CUDA graphs). Batching
    the chains into one launch of each kernel, and the JAX package's mesh
    (n_shards > 1, mesh), are not ported (ROADMAP M14): they raise.

    track: quantity names to keep in memory for R̂/ESS, or "all".
    out_folder: when set, every tracked quantity streams to
    `<out_folder>/chain<i>/<q>Out` TSVs in the reference layout, and
    `checkpoint_every`/`resume` give the run the same exact-resume
    semantics as `run_lmem` (`<out_folder>/chains.ckpt`).
    streams: one draw stream per chain; by default chain c draws from
    PhiloxStream(chain_seed(seed, c)).

    Returns {"draws": {name: (n_chains, n_keep, ...)}, "rhat": {...},
    "ess": {...}, "state": the chains' ModelState, batched on a leading
    chain axis}.
    """
    if n_shards not in (None, 1) or mesh is not None:
        raise NotImplementedError(
            "run_chains: n_shards > 1 and mesh (chains x shards over devices) are not ported yet "
            "(ROADMAP M14); on one card the chains run in turn")
    device = torch.device(device) if device is not None else default_device()
    if streams is not None and len(streams) != n_chains:
        raise ValueError(f"run_chains: {len(streams)} streams for {n_chains} chains")
    ckpt_path = os.path.join(out_folder, "chains.ckpt") if out_folder else None
    resuming = bool(resume and ckpt_path and os.path.exists(ckpt_path))
    if out_folder and not resuming:
        folder_handler(out_folder)
        _write_group_infos(spec, out_folder)

    plan, state = assemble(spec, dtype=dtype, device=device, vshards=vshards)
    fingerprint = plan_fingerprint(plan)
    saves = bool(checkpoint_every and ckpt_path)
    digest = constants_digest(state) if (saves or resuming) else None
    streams = list(streams) if streams is not None else [
        PhiloxStream(chain_seed(seed, c), plan.device, plan.dtype) for c in range(n_chains)]
    states = [state] * n_chains

    if resuming:
        batched = load_checkpoint(ckpt_path, _stack(states), fingerprint=fingerprint,
                                  constants=digest)
        states = [_pick(batched, c) for c in range(n_chains)]
        meta = read_meta(ckpt_path)
        if "kept_rows" in meta:
            for c in range(n_chains):
                truncate_outputs(os.path.join(out_folder, f"chain{c + 1}"), int(meta["kept_rows"]))
        if progress:
            print(f"  resumed at sweep {states[0].sweep_index}")

    def checkpoint(states, kept_rows):
        save_checkpoint(ckpt_path, _stack(states), meta={
            "fingerprint": fingerprint, "kept_rows": kept_rows, "constants": digest})

    writers = []
    if out_folder:
        headers = _headers(spec, plan)
        writers = [MCMCWriter(os.path.join(out_folder, f"chain{c + 1}"),
                              None if resuming else headers) for c in range(n_chains)]
    n_keep = (n_chain - n_burn) // n_thin
    try:
        states, draws, _ = _drive(
            plan, states, streams, n_burn, n_keep, n_thin, writers=writers, track=track,
            keep_in_memory=True, checkpoint=checkpoint if saves else None,
            every=checkpoint_every, progress=progress)
    finally:
        for w in writers:
            w.close()
    out_draws = {k: np.stack([np.concatenate(d[k]) for d in draws]) for k in draws[0]}
    rhat = {k: split_rhat(v if v.ndim > 2 else v[..., None]) for k, v in out_draws.items()}
    ess = {k: ess_bulk(v if v.ndim > 2 else v[..., None]) for k, v in out_draws.items()}
    return {"draws": out_draws, "rhat": rhat, "ess": ess, "state": _stack(states)}


def _collect_batched(batched, plan) -> Dict[str, Any]:
    """collect_sample over a chains-batched state: index chain c out of every
    chain-batched leaf (_CHAIN_FIELDS), then collect; host arrays with a
    leading chain axis."""
    n_chains = batched.ycorr.shape[0]
    out: Dict[str, Any] = {}
    for c in range(n_chains):
        sample = collect_sample(_pick(batched, c), plan)
        for k, v in sample.items():
            out.setdefault(k, []).append(v.cpu().numpy())
    return {k: np.stack(v) for k, v in out.items()}
