"""The port's whole-chain runner, `make_scan_sampler`, on the CPU.

Against the JAX package's `make_scan_sampler` (nextgp_tpu/engine/sweep.py,
jitted nested `lax.scan`s, run as its own tests run it: CPU, the plain
reference in place of the Pallas kernels) on the same assembled inputs, in
float64, with `JaxStream` answering the port's draw sites with the JAX
keys: n_keep = 3 intervals of thin = 2 sweeps, BayesR with a plain ("I")
and a weighted ("D") residual, BayesC and BayesPR, at V = 1 and 4. The
stacked draws agree at rtol 1e-9 where continuous and exactly where
discrete (delta, annotation), and so do the final states.

Then with the port's own `KeyedStream` (its plain version on the CPU): for
every method the scan sampler and a loop of `make_chain_runner` give the
same bits and the same sweep index, and `run_lmem` with a KeyedStream
(which runs through the scan sampler's chain) gives the draws of a loop of
eager sweeps.
"""
import jax
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu.engine.sweep import make_scan_sampler as jax_make_scan_sampler
from test_torch_sweep import (
    CHAIN_KEY, METHODS, JaxStream, _assert_chains_agree, _flatten, _specs,
)

N_KEEP, THIN = 3, 2
DISCRETE = ("delta", "annot")


@pytest.mark.parametrize("V", [1, 4], ids=["V1", "V4"])
@pytest.mark.parametrize("method,weighted", [("BayesR", False), ("BayesR", True), ("BayesC", False),
                                             ("BayesPR", False)],
                         ids=["BayesR-I", "BayesR-D", "BayesC-I", "BayesPR-I"])
def test_scan_sampler_matches_jax(method, weighted, V):
    js, ts = _specs(method, weighted)
    jplan, jst = ng.assemble(js, use_pallas=False, pack2=True, vshards=V)
    tplan, tst = ngt.assemble(ts, device="cpu", dtype=torch.float64, vshards=V)
    jst, jdraws = jax_make_scan_sampler(jplan, N_KEEP, THIN)(jst, jax.random.key(CHAIN_KEY))
    tst, tdraws = ngt.make_scan_sampler(tplan, N_KEEP, THIN)(tst, JaxStream(jax.random.key(CHAIN_KEY)))
    assert set(tdraws) == set(jdraws)
    for name, j in jdraws.items():
        t, j = tdraws[name].numpy(), np.asarray(j)
        assert t.shape == j.shape == (N_KEEP,) + j.shape[1:], name
        if name.startswith(DISCRETE):
            np.testing.assert_array_equal(t, j, err_msg=name)
        else:
            np.testing.assert_allclose(t, j, rtol=1e-9, atol=1e-12, err_msg=name)
    _assert_chains_agree(tst, jst, tplan)
    assert tst.sweep_index == int(tst.sweep_counter) == N_KEEP * THIN


@pytest.mark.parametrize("method", METHODS)
def test_scan_sampler_equals_chain_runner_loop(method):
    """With the plain KeyedStream: the scan sampler's stacked draws are the
    chain runner's samples bit for bit, and both end at the same sweep."""
    _, ts = _specs(method)
    plan, st0 = ngt.assemble(ts, device="cpu", dtype=torch.float64, vshards=4)
    stream = ngt.KeyedStream(13, "cpu", torch.float64)
    st, draws = ngt.make_scan_sampler(plan, N_KEEP, THIN)(st0, stream)
    run_thin, loop, kept = ngt.make_chain_runner(plan, THIN), st0, []
    for _ in range(N_KEEP):
        loop, sample = run_thin(loop, stream)
        kept.append(sample)
    assert set(draws) == set(kept[0])
    for name, d in draws.items():
        assert torch.equal(d, torch.stack([k[name] for k in kept])), name
        assert torch.isfinite(d.double()).all(), name
    assert st.sweep_index == loop.sweep_index == N_KEEP * THIN
    assert int(st.sweep_counter) == int(loop.sweep_counter) == N_KEEP * THIN
    assert torch.equal(st.ycorr, loop.ycorr)


@pytest.mark.parametrize("method", ["BayesR", "BayesRCpi", "BayesLV"])
def test_run_lmem_with_keyed_stream(method):
    """run_lmem with a KeyedStream on the CPU keeps the draws that a loop of
    eager sweeps from the same seed gives, at iterations (n_burn + n_thin)
    : n_thin : n_chain."""
    _, ts = _specs(method)
    res = ngt.run_lmem(ts, n_chain=9, n_burn=3, n_thin=2, out_folder=None, device="cpu", vshards=4,
                       stream=ngt.KeyedStream(5, "cpu", torch.float64))
    plan, st = ngt.assemble(ts, device="cpu", vshards=4)
    sweep, stream, kept = ngt.make_sweep(plan), ngt.KeyedStream(5, "cpu", torch.float64), []
    for i in range(1, 10):
        st = sweep(st, stream)
        if i >= 5 and (i - 5) % 2 == 0:
            kept.append(ngt.collect_sample(st, plan))
    assert len(kept) == 3 and set(res.draws) == set(kept[0])
    for name, d in res.draws.items():
        np.testing.assert_array_equal(d, torch.stack([k[name] for k in kept]).numpy(), err_msg=name)
    assert res.state.sweep_index == 9 and torch.equal(res.state.ycorr, st.ycorr)


def test_state_from_numpy_sets_the_counter():
    """A state continued from a flattened JAX state carries its sweep index
    on the device too, so a KeyedStream names the same sites."""
    js, ts = _specs("BayesC")
    jplan, jst = ng.assemble(js, use_pallas=False, pack2=True)
    jst = jax.jit(ng.make_sweep(jplan))(jst, jax.random.key(CHAIN_KEY))
    tplan, _ = ngt.assemble(ts, device="cpu", dtype=torch.float64)
    st = ngt.state_from_numpy(tplan, _flatten(jst))
    assert st.sweep_index == 1 and st.sweep_counter.dtype == torch.int64 and int(st.sweep_counter) == 1
