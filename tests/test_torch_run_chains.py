"""The port's run_chains (ROADMAP M10) against the JAX package's, on the CPU
in float64.

Two chains of an intercept and a BayesC set: the JAX package's over its
CPU mesh (n_shards = 1), the port's in turn on one device, chain c drawing
from JaxStream(jax.random.split(jax.random.key(seed), 2)[c]), the JAX
package's key of chain c. The draws, R-hat and ESS agree to 1e-9, and so
do the per-chain files. With the default streams, each chain equals
run_lmem with that chain's stream, an interrupted and resumed run equals
the unbroken one (files byte for byte), n_burn % n_thin != 0 keeps the
reference's set of sweeps, and `_collect_batched` of the batched state
gives each chain's last kept sample.
"""
import os

import jax
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu_torch import runtime as t_runtime
from test_torch_sweep import JaxStream

N, P, BLOCK = 48, 32, 8
SEED = 3
KW = dict(n_chain=30, n_burn=5, n_thin=3, track=("varE", "betaM"))  # kept sweeps 8, 11, ..., 29


def _specs():
    rng = np.random.default_rng(90)
    g = rng.integers(0, 3, (N, P)).astype(float)
    y = 1.0 + (g - g.mean(0)) @ rng.normal(0, 0.2, P) + rng.normal(0, 1, N)
    return tuple(mod.ModelSpec(
        y=y, fixed=[mod.FixedTerm("int", np.ones(N))],
        markers=[mod.MarkerTerm("M", mod.from_array(g), mod.BayesC(0.2, 0.05))],
        block_size=BLOCK) for mod in (ng, ngt))


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    root = tmp_path_factory.mktemp("chains")
    js, ts = _specs()
    jout = ng.run_chains(js, n_chains=2, seed=SEED, n_shards=1, out_folder=str(root / "jax"), **KW)
    keys = jax.random.split(jax.random.key(SEED), 2)
    tout = ngt.run_chains(ts, n_chains=2, seed=SEED, out_folder=str(root / "port"), device="cpu",
                          streams=[JaxStream(k) for k in keys], **KW)
    return dict(jout=jout, tout=tout, root=root)


def test_run_chains_matches(both):
    jout, tout, root = both["jout"], both["tout"], both["root"]
    assert set(tout["draws"]) == set(jout["draws"]) == {"varE", "betaM"}
    assert tout["draws"]["varE"].shape == (2, 8) and tout["draws"]["betaM"].shape == (2, 8, P)
    for what in ("draws", "rhat", "ess"):
        for name, v in jout[what].items():
            np.testing.assert_allclose(tout[what][name], v, rtol=1e-9, atol=1e-12,
                                       err_msg=f"{what} {name}")
    for c in (1, 2):
        for name in ("varE", "betaM"):
            path = os.path.join("chain{}".format(c), f"{name}Out")
            np.testing.assert_allclose(np.loadtxt(root / "port" / path, skiprows=1),
                                       np.loadtxt(root / "jax" / path, skiprows=1),
                                       rtol=1e-9, atol=1e-12, err_msg=path)
        assert sorted(os.listdir(root / "port" / f"chain{c}")) == ["betaMOut", "varEOut"]
    assert tout["state"].sweep_index.tolist() == np.asarray(jout["state"].sweep_index).tolist()


def test_batched_state_and_burn_in_remainder(both):
    """The state is batched on a leading chain axis at the last kept sweep
    (29 = 5 + 3 * 8: the remainder of the burn-in ran first), and
    _collect_batched gives each chain's last kept sample."""
    _, ts = _specs()
    plan, _ = ngt.prep(ts, device="cpu")
    st = both["tout"]["state"]
    assert st.sweep_index.tolist() == [29, 29] and st.sweep_counter.tolist() == [29, 29]
    assert st.ycorr.shape == (2, N) and st.markers[0].beta.shape[0] == 2
    assert st.markers[0].mt.shape == ngt.prep(ts, device="cpu")[1].markers[0].mt.shape
    sample = t_runtime._collect_batched(st, plan)
    for name in ("varE", "betaM"):
        np.testing.assert_array_equal(sample[name], both["tout"]["draws"][name][:, -1], err_msg=name)


def test_chains_equal_run_lmem_and_resume_exact(tmp_path):
    """Default streams: chain c is run_lmem with PhiloxStream(chain_seed(seed,
    c)), the chains differ, and a run stopped after a checkpoint and resumed
    leaves the unbroken run's files and draws."""
    _, ts = _specs()
    full = ngt.run_chains(ts, 2, seed=SEED, device="cpu", out_folder=str(tmp_path / "a"), **KW)
    for c in range(2):
        stream = ngt.PhiloxStream(t_runtime.chain_seed(SEED, c), "cpu", torch.float64)
        one = ngt.run_lmem(ts, KW["n_chain"], KW["n_burn"], KW["n_thin"], out_folder=None,
                           device="cpu", stream=stream)
        for name in ("varE", "betaM"):
            np.testing.assert_array_equal(full["draws"][name][c], one.draws[name], err_msg=name)
    assert not np.array_equal(full["draws"]["varE"][0], full["draws"]["varE"][1])
    out = str(tmp_path / "b")
    ngt.run_chains(ts, 2, seed=SEED, device="cpu", out_folder=out, checkpoint_every=3,
                   **{**KW, "n_chain": 20})  # 5 kept; the checkpoint at 3
    res = ngt.run_chains(ts, 2, seed=SEED, device="cpu", out_folder=out, checkpoint_every=3,
                         resume=True, **KW)
    for c in (1, 2):
        for name in ("varEOut", "betaMOut"):
            assert (tmp_path / "a" / f"chain{c}" / name).read_bytes() == \
                (tmp_path / "b" / f"chain{c}" / name).read_bytes()
    np.testing.assert_array_equal(res["draws"]["varE"], full["draws"]["varE"][:, 3:])
    assert torch.equal(res["state"].ycorr, full["state"].ycorr)


def test_run_chains_refusals():
    _, ts = _specs()
    # two shards a chain in a world of one rank: make_mesh's refusal, as the
    # JAX package's for a mesh larger than its devices
    with pytest.raises(ValueError, match=r"chains\*shards = 4 != 1 ranks"):
        ngt.run_chains(ts, 2, 4, 0, 1, n_shards=2, device="cpu")
    with pytest.raises(ValueError, match="streams"):
        ngt.run_chains(ts, 2, 4, 0, 1, device="cpu", streams=[None])
