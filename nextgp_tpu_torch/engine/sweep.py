"""One Gibbs sweep over all effect families, and the chain loop.

Stage order as in `nextgp_tpu/engine/sweep.py` (and NextGP.jl's
runSampler!, samplers.jl:29-53): residual variance -> fixed-effect blocks
-> marker sets. PyTorch runs eagerly, so a thinning interval is a Python
loop of sweeps; each sweep launches its kernels on the current CUDA stream
without waiting for them. The stages carry the JAX package's scope names
(`gibbs.var_e`, `gibbs.fixed.<i>`, `gibbs.marker.<set>`) as
`torch.profiler.record_function` scopes, so a trace (`diag.trace`)
attributes host and device time to them.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
from torch.profiler import record_function

from ..utils import replace
from .plan import (
    METHOD_B, METHOD_C, METHOD_LV, METHOD_R, METHOD_RCPI, METHOD_RCPLUS, SweepPlan,
)
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
        with record_function("gibbs.var_e"):
            var_e = sample_var_e(stream, Site(s, STAGE_VAR_E), state.e, ycorr, plan.n, plan.e_df)

        fixed = []
        for i, (fs, fp) in enumerate(zip(state.fixed, plan.fixed)):
            with record_function(f"gibbs.fixed.{i}"):
                b, ycorr = sample_fixed_block(stream, Site(s, STAGE_FIXED, i), fs, ycorr, var_e,
                                              fp.single)
            fixed.append(replace(fs, b=b))

        markers = []
        for i, (ms, mp) in enumerate(zip(state.markers, plan.markers)):
            with record_function(f"gibbs.marker.{mp.name}"):
                ms, ycorr = sample_marker_set(stream, Site(s, STAGE_MARKER, i), ms, mp, ycorr,
                                              var_e, state.e.d_inv)
            markers.append(ms)

        return replace(state, ycorr=ycorr, e=replace(state.e, var_e=var_e), fixed=tuple(fixed),
                       markers=tuple(markers), sweep_index=s + 1)

    return sweep


def collect_sample(state: ModelState, plan: SweepPlan) -> Dict[str, Any]:
    """The tracked quantities the reference streams per kept iteration
    (samplers.jl:56-104): b, varE, and beta/delta/var per marker set, with
    the per-locus variances cut to p (BayesB, BayesLV), pi where the method
    has one (BayesB/C/R; flattened (A, K) for BayesRCpi/RCplus, with the
    annotation categories), and c and varZeta for BayesLV."""
    out: Dict[str, Any] = {"varE": state.e.var_e}
    if state.fixed:
        out["b"] = torch.cat([fs.b for fs in state.fixed])
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
