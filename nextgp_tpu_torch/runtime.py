"""High-level entry point: the `runLMEM` equivalent, draws kept in memory.

Counterpart of `nextgp_tpu/runtime.py:run_lmem` (NextGP.jl MCMC.jl:31-41).
Output files, checkpointing and resume are not ported yet and raise.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

import numpy as np
import torch

from .api.spec import ModelSpec
from .engine.plan import SweepPlan, assemble
from .engine.rng import PhiloxStream
from .engine.sweep import make_chain_runner, make_sweep


@dataclass
class LMEMResult:
    plan: SweepPlan
    state: Any
    draws: Dict[str, np.ndarray] = field(default_factory=dict)
    sweeps_per_sec: float = 0.0

    def posterior_mean(self, name: str) -> np.ndarray:
        return np.asarray(self.draws[name]).mean(axis=0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_lmem(
    spec: ModelSpec,
    n_chain: int,
    n_burn: int,
    n_thin: int,
    out_folder: Optional[str] = None,
    seed: int = 0,
    dtype=None,
    device=None,
    vshards=1,
    checkpoint_every: int = 0,
    resume: bool = False,
    stream=None,
) -> LMEMResult:
    """Single-chain MCMC mirroring runLMEM (MCMC.jl:31-41).

    Kept iterations are `(n_burn + n_thin) : n_thin : n_chain`
    (samplers.jl:26), for any (n_burn, n_thin). Draws are returned in
    memory as stacked numpy arrays. `stream` overrides the default
    PhiloxStream(seed) (engine/rng.py). vshards defaults to 1, the
    reference-sequential order: the H100 value of V has not been measured.
    `sweeps_per_sec` counts every sweep run, from the first to the device
    finishing the last.
    """
    if out_folder is not None:
        raise NotImplementedError("out_folder: output files are not ported yet; "
                                  "pass out_folder=None and read LMEMResult.draws")
    if checkpoint_every or resume:
        raise NotImplementedError("checkpointing and resume are not ported yet")
    plan, state = assemble(spec, dtype=dtype, device=device, vshards=vshards)
    stream = stream or PhiloxStream(seed, plan.device, plan.dtype)
    sweep = make_sweep(plan)
    runner = make_chain_runner(plan, n_thin)
    n_keep = (n_chain - n_burn) // n_thin
    draws: Dict[str, list] = {}

    _sync(plan.device)
    t0 = time.perf_counter()
    for _ in range(n_burn):
        state = sweep(state, stream)
    for _ in range(n_keep):
        state, sample = runner(state, stream)
        for nm, v in sample.items():
            draws.setdefault(nm, []).append(v.cpu().numpy())
    _sync(plan.device)
    dt = time.perf_counter() - t0
    ran = n_burn + n_keep * n_thin
    return LMEMResult(
        plan=plan,
        state=state,
        draws={k: np.stack(v) for k, v in draws.items()},
        sweeps_per_sec=ran / dt if dt > 0 else 0.0,
    )
