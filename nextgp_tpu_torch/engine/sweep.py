"""One Gibbs sweep over all effect families, and the chain loop.

Stage order as in `nextgp_tpu/engine/sweep.py` (and NextGP.jl's
runSampler!, samplers.jl:29-53): residual variance -> fixed-effect blocks
-> marker sets. PyTorch runs eagerly, so a thinning interval is a Python
loop of sweeps; each sweep launches its kernels on the current CUDA stream
without waiting for them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..utils import replace
from .plan import SweepPlan
from .rng import STAGE_FIXED, STAGE_MARKER, STAGE_VAR_E, Site
from .samplers.fixed import sample_fixed_block
from .samplers.markers import sample_marker_set
from .samplers.residual import sample_var_e
from .state import ModelState


def make_sweep(plan: SweepPlan):
    """Build sweep(state, stream) -> state for the static plan. The draw
    sites are named by state.sweep_index, so a chain is a function of the
    stream's seed and the starting state."""

    def sweep(state: ModelState, stream) -> ModelState:
        s = state.sweep_index
        ycorr = state.ycorr
        var_e = sample_var_e(stream, Site(s, STAGE_VAR_E), state.e, ycorr, plan.n, plan.e_df)

        fixed = []
        for i, (fs, fp) in enumerate(zip(state.fixed, plan.fixed)):
            b, ycorr = sample_fixed_block(stream, Site(s, STAGE_FIXED, i), fs, ycorr, var_e,
                                          fp.single)
            fixed.append(replace(fs, b=b))

        markers = []
        for i, (ms, mp) in enumerate(zip(state.markers, plan.markers)):
            ms, ycorr = sample_marker_set(stream, Site(s, STAGE_MARKER, i), ms, mp, ycorr, var_e)
            markers.append(ms)

        return replace(state, ycorr=ycorr, e=replace(state.e, var_e=var_e), fixed=tuple(fixed),
                       markers=tuple(markers), sweep_index=s + 1)

    return sweep


def collect_sample(state: ModelState, plan: SweepPlan) -> Dict[str, Any]:
    """The tracked quantities the reference streams per kept iteration
    (samplers.jl:56-104): b, varE, and beta/delta/var/pi per marker set."""
    out: Dict[str, Any] = {"varE": state.e.var_e}
    if state.fixed:
        out["b"] = torch.cat([fs.b for fs in state.fixed])
    for ms, mp in zip(state.markers, plan.markers):
        out[f"beta{mp.name}"] = ms.beta[: mp.p]
        out[f"delta{mp.name}"] = ms.delta[: mp.p]
        out[f"var{mp.name}"] = ms.var_beta
        out[f"pi{mp.name}"] = ms.pi_hat
    return out


def make_chain_runner(plan: SweepPlan, thin: int):
    """run_thin(state, stream) -> (state, sample): `thin` sweeps, then the
    sample of the last one."""
    sweep = make_sweep(plan)

    def run_thin(state, stream):
        for _ in range(thin):
            state = sweep(state, stream)
        return state, collect_sample(state, plan)

    return run_thin
