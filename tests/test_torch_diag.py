"""`nextgp_tpu_torch.diag` against `nextgp_tpu.diag`: the roofline formula on
the same model assembled by both packages (both packed, both with the "cpu"
peaks, the one entry their tables share), the meter, the trace with the
sweep's stage scopes, and that the scopes change no draw.
"""
import json
import os
import time

import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu import diag as j_diag
from nextgp_tpu_torch import diag as t_diag
from nextgp_tpu_torch.engine.rng import HostStream

N, P = 120, 400


def _specs(prior_name, n_sets=1, block=64):
    rng = np.random.default_rng(5)
    g = rng.integers(0, 3, (N, P)).astype(np.int8)
    y = rng.normal(0, 1, N)
    out = []
    for mod in (ng, ngt):
        prior = {"BayesR": lambda: mod.BayesR([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0),
                 "BayesC": lambda: mod.BayesC(0.95, 0.05)}[prior_name]
        markers = [mod.MarkerTerm(f"M{i + 1}", mod.from_array(g[:, i::n_sets]), prior())
                   for i in range(n_sets)]
        out.append(mod.ModelSpec(y=y, fixed=[mod.FixedTerm("int", np.ones(N))], markers=markers,
                                 block_size=block))
    return out


@pytest.mark.parametrize("prior,n_sets,block,shards", [("BayesR", 1, 64, 1), ("BayesC", 2, 32, 1),
                                                       ("BayesR", 1, 128, 4)])
def test_roofline_matches_the_jax_package(prior, n_sets, block, shards):
    js, ts = _specs(prior, n_sets, block)
    jplan, _ = ng.assemble(js, use_pallas=False, pack2=True)
    tplan, _ = ngt.assemble(ts, device="cpu")
    assert all(mp.packed for mp in tplan.markers) and all(mp.packed for mp in jplan.markers)
    ref = j_diag.roofline(jplan, device="cpu", n_shards=shards)
    out = t_diag.roofline(tplan, device="cpu", n_shards=shards)
    assert out.bytes_per_sweep == ref.bytes_per_sweep
    assert out.flops_per_sweep == ref.flops_per_sweep
    assert out.bound == ref.bound
    assert out.sweeps_per_sec_roof == ref.sweeps_per_sec_roof
    assert out.intensity == ref.intensity
    assert str(out) == str(ref)


def test_roofline_devices():
    _, ts = _specs("BayesR")
    plan, _ = ngt.assemble(ts, device="cpu")
    h100 = t_diag.roofline(plan)  # the default device is the card the port is for
    assert h100 == t_diag.roofline(plan, device="h100")
    assert h100.t_bandwidth_s == h100.bytes_per_sweep / 3350e9  # the data sheet's 3.35 TB/s
    assert h100.t_compute_s == h100.flops_per_sweep / 67e12  # and its 67 TFLOP/s in f32
    assert h100.bound == "bandwidth"
    for tpu in ("v4", "v5e", "v5p", "v6e"):  # no TPU entry is carried over
        with pytest.raises(ValueError, match="unknown device"):
            t_diag.roofline(plan, device=tpu)


@pytest.mark.parametrize("iterations", [1, 120])
def test_roofline_counts_a_cg_term(iterations):
    """A CG term adds cg_work's bytes for the iterations given: a solve
    reads the padded A^-1's live entries (an int32 index and a float64 value
    each) and the rows' lengths once, and an iteration seven float64
    vectors; without the iterations the roofline of a plan with a CG term
    raises."""
    from nextgp_tpu_torch.data import pedigree as tped

    rng = np.random.default_rng(3)
    q = 80
    ids = [f"a{i}" for i in range(q)]
    sires, dams = [None] * q, [None] * q
    for i in range(16, q):
        s, d = rng.integers(0, i // 2, 2)
        sires[i], dams[i] = ids[s], ids[d] if s != d else None
    ped = tped.build_pedigree(ids, sires, dams)
    idx, val = tped.a_inverse_padded(ped)
    sire, dam, dsq = tped.a_inverse_factor(ped)
    y = rng.normal(size=N)
    base = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(N))])
    with_cg = ngt.ModelSpec(y=y, fixed=base.fixed, random=[ngt.RandomTerm(
        "A", None, prior=ngt.Random("A", 0.5, sampler="cg"), z_idx=rng.integers(0, q, N), n_levels=q,
        sparse_struct=dict(iv_idx=idx, iv_val=val, sire=sire, dam=dam, dinv_sqrt=dsq))])
    plans = [ngt.assemble(s, device="cpu", dtype=torch.float64)[0] for s in (base, with_cg)]
    got = (t_diag.roofline(plans[1], device="cpu", cg_iterations=iterations).bytes_per_sweep
           - t_diag.roofline(plans[0], device="cpu", cg_iterations=iterations).bytes_per_sweep)
    k = np.arange(idx.shape[1])
    live = int(((idx != 0) | (val != 0.0)).sum())
    assert live == int((k < plans[1].random[0].iv_len.numpy()[:, None]).sum())
    assert got == live * (4 + 8) + q * 4 + iterations * q * 7 * 8
    assert t_diag.cg_work(live, q, torch.float64, iterations)[0] == got
    with pytest.raises(ValueError, match="cg_iterations"):
        t_diag.roofline(plans[1], device="cpu")
    assert t_diag.roofline(plans[0], device="cpu").bytes_per_sweep > 0  # no CG term: none needed


def test_sweep_meter_counts():
    meter, ref = t_diag.SweepMeter(10), j_diag.SweepMeter(10)
    assert meter.eta_s is None and ref.eta_s is None
    meter.tick()
    meter.tick(3)
    ref.tick(4)
    time.sleep(0.01)
    assert meter.done == ref.done == 4
    assert meter.sweeps_per_sec > 0 and meter.eta_s > 0
    assert meter.status().startswith("4 sweeps @ ") and "ETA" in meter.status()
    assert "ETA" not in t_diag.SweepMeter().status()


def _run(spec, n_sweeps, traced_dir=None):
    plan, st = ngt.assemble(spec, device="cpu")
    sweep, stream = ngt.make_sweep(plan), HostStream(3, "cpu", plan.dtype)
    if traced_dir is None:
        for _ in range(n_sweeps):
            st = sweep(st, stream)
        return st, None
    with t_diag.trace(traced_dir) as prof:
        for _ in range(n_sweeps):
            st = sweep(st, stream)
    return st, prof


def test_trace_carries_the_stage_names_and_changes_no_draw(tmp_path):
    _, ts = _specs("BayesR")
    log_dir = str(tmp_path / "trace")
    st_traced, prof = _run(ts, 2, log_dir)
    st_plain, _ = _run(ts, 2)
    assert torch.equal(st_traced.markers[0].beta, st_plain.markers[0].beta)
    assert torch.equal(st_traced.ycorr, st_plain.ycorr)
    assert torch.equal(st_traced.e.var_e, st_plain.e.var_e)

    stages = {"gibbs.var_e", "gibbs.fixed.0", "gibbs.marker.M1"}
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith("gibbs.")}
    assert counts == dict.fromkeys(stages, 2)
    with open(os.path.join(log_dir, t_diag.TRACE_FILE)) as fh:
        events = json.load(fh)["traceEvents"]
    assert stages <= {e.get("name") for e in events}
