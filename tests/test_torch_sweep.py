"""The port's BayesR slice against the JAX package, end to end, in float64.

Both packages assemble one spec (intercept + one packed BayesR set with
estimatePi); the port runs on the CPU through its plain versions and draws
from `JaxStream`, which reproduces the JAX package's keys with jax.random,
so the two chains see the same numbers. Continuous fields agree to rtol
1e-9 (the two evaluate the same algebra in another order: the JAX pure path
restores beta_old explicitly, the port folds it into the coefficients);
delta is exactly equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu.engine import rng as jrng
from nextgp_tpu.ops import dists as jdists
from nextgp_tpu_torch.engine.rng import Site
from nextgp_tpu_torch.ops import dists as tdists

N, P, BLOCK = 120, 256, 16
CHAIN_KEY = 9


class JaxStream:
    """The port's stream seam, answered with the JAX package's keys:
    site (sweep, stage, index, splits) -> stage_key(fold_in(chain, sweep),
    stage, index), then jax.random.split(key, n)[i] along the path."""

    def __init__(self, chain_key, dtype=torch.float64):
        self.chain_key = chain_key
        self.jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32

    def _key(self, site):
        key = jrng.stage_key(jrng.sweep_key(self.chain_key, site.sweep), site.stage, site.index)
        for n, i in site.path:
            key = jax.random.split(key, n)[i]
        return key

    def normal(self, site, shape):
        return torch.from_numpy(np.array(jax.random.normal(self._key(site), shape, self.jdtype)))

    def uniform(self, site, shape):
        return torch.from_numpy(np.array(jax.random.uniform(self._key(site), shape, self.jdtype)))

    def gamma(self, site, alpha):
        a = jnp.asarray(alpha.cpu().numpy())
        return torch.from_numpy(np.array(jax.random.gamma(self._key(site), a)))


def _data():
    rng = np.random.default_rng(20)
    g = rng.integers(0, 3, (N, P)).astype(float)
    bt = np.zeros(P)
    bt[rng.choice(P, 12, replace=False)] = rng.normal(0, 0.4, 12)
    y = 1.0 + (g - g.mean(0)) @ bt + rng.normal(0, 1, N)
    return g, y


def _specs():
    g, y = _data()
    pi, cls = [0.85, 0.08, 0.05, 0.02], [0.0, 1e-3, 1e-2, 1e-1]
    js = ng.ModelSpec(y=y, fixed=[ng.FixedTerm("int", np.ones(N))],
                      markers=[ng.MarkerTerm("M", ng.from_array(g), ng.BayesR(pi, cls, 1.0, estimatePi=True))],
                      block_size=BLOCK)
    ts = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(N))],
                       markers=[ngt.MarkerTerm("M", ngt.from_array(g), ngt.BayesR(pi, cls, 1.0, estimatePi=True))],
                       block_size=BLOCK)
    return js, ts


def _flatten(state):
    """JAX ModelState -> {"markers.0.gram": array, ...}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        key = ".".join(str(getattr(p, "name", getattr(p, "idx", p))) for p in path)
        out[key] = np.asarray(leaf)
    return out


def _port_layout(key, a, plan):
    """JAX storage for V=1 is (nb, B, ...); the port's is (T, V, B, ...)."""
    mp = plan.markers[0]
    T, V, B = mp.n_blocks // mp.vshards, mp.vshards, mp.block
    shapes = {"markers.0.mt": (T, V, B, -1), "markers.0.center": (T, V, B),
              "markers.0.gram": (T, B, V, B)}
    return a.reshape(shapes[key]) if key in shapes else a


def _port_flat(state):
    out = {"y": state.y, "ycorr": state.ycorr, "sweep_index": np.asarray(state.sweep_index)}
    for f in dataclasses.fields(state.e):
        out[f"e.{f.name}"] = getattr(state.e, f.name)
    for i, fs in enumerate(state.fixed):
        for f in dataclasses.fields(fs):
            out[f"fixed.{i}.{f.name}"] = getattr(fs, f.name)
    for i, ms in enumerate(state.markers):
        for f in dataclasses.fields(ms):
            out[f"markers.{i}.{f.name}"] = getattr(ms, f.name)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_chains_agree(port_state, jax_state, plan):
    jf = _flatten(jax_state)
    tf = _port_flat(port_state)
    for key in ("ycorr", "e.var_e", "fixed.0.b", "markers.0.beta", "markers.0.var_beta",
                "markers.0.pi_hat", "markers.0.log_pi"):
        np.testing.assert_allclose(tf[key], jf[key], rtol=1e-9, atol=1e-12, err_msg=key)
    np.testing.assert_array_equal(tf["markers.0.delta"], jf["markers.0.delta"])
    assert int(tf["sweep_index"]) == int(jf["sweep_index"])


@pytest.fixture(scope="module", params=[1, 4], ids=["V1", "V4"])
def both(request):
    """Both packages' assembled (plan, state) and 5 JAX sweeps for one V."""
    V = request.param
    js, ts = _specs()
    jplan, jstate0 = ng.assemble(js, use_pallas=False, pack2=True, vshards=V)
    tplan, tstate0 = ngt.assemble(ts, device="cpu", dtype=torch.float64, vshards=V)
    jsweep = jax.jit(ng.make_sweep(jplan))
    key = jax.random.key(CHAIN_KEY)
    jstates = [jstate0]
    for _ in range(5):
        jstates.append(jsweep(jstates[-1], key))
    return dict(V=V, jplan=jplan, tplan=tplan, tstate0=tstate0, jstates=jstates)


def test_assemble_matches(both):
    tplan, jstates = both["tplan"], both["jstates"]
    assert tplan.markers[0].vshards == both["V"]
    jf = {k: _port_layout(k, a, tplan) for k, a in _flatten(jstates[0]).items()}
    tf = _port_flat(both["tstate0"])
    assert set(tf) == set(jf)
    assert np.array_equal(tf["markers.0.mt"], jf["markers.0.mt"])
    for key in tf:
        if tf[key].dtype.kind == "f":
            scale = max(1.0, float(np.abs(jf[key]).max()))
            np.testing.assert_allclose(tf[key], jf[key], rtol=1e-12, atol=1e-12 * scale, err_msg=key)
        else:
            np.testing.assert_array_equal(tf[key], jf[key], err_msg=key)


def test_five_sweeps_match(both):
    sweep = ngt.make_sweep(both["tplan"])
    stream = JaxStream(jax.random.key(CHAIN_KEY))
    st = both["tstate0"]
    for _ in range(5):
        st = sweep(st, stream)
    _assert_chains_agree(st, both["jstates"][5], both["tplan"])


def test_continue_from_jax_state(both):
    """3 JAX sweeps, then the port continues from the flattened JAX state."""
    tplan = both["tplan"]
    st = ngt.state_from_numpy(tplan, _flatten(both["jstates"][3]))
    assert st.sweep_index == 3 and st.markers[0].mt.shape[1] == both["V"]
    sweep = ngt.make_sweep(tplan)
    stream = JaxStream(jax.random.key(CHAIN_KEY))
    for _ in range(2):
        st = sweep(st, stream)
    _assert_chains_agree(st, both["jstates"][5], tplan)


def test_state_from_numpy_is_strict(both):
    arrays = _flatten(both["jstates"][0])
    with pytest.raises(KeyError, match="unknown"):
        ngt.state_from_numpy(both["tplan"], {**arrays, "markers.0.gram_raw": arrays["y"]})
    del arrays["markers.0.pi_hat"]
    with pytest.raises(KeyError, match="missing"):
        ngt.state_from_numpy(both["tplan"], arrays)


def test_genomic_values_state_matches(both):
    jstate = both["jstates"][5]
    ref = np.asarray(ng.genomic_values_state(both["jplan"], jstate))
    st = ngt.state_from_numpy(both["tplan"], _flatten(jstate))
    out = ngt.genomic_values_state(both["tplan"], st).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    # and the residual identity ycorr = y - Xb - Mc beta holds on the carried state
    drift = st.ycorr - (st.y - st.fixed[0].b[0] - ngt.genomic_values_state(both["tplan"], st))
    assert drift.abs().max().item() < 1e-9


def test_run_lmem_matches():
    js, ts = _specs()
    jres = ng.run_lmem(js, n_chain=9, n_burn=3, n_thin=2, out_folder=None, seed=5)
    tres = ngt.run_lmem(ts, n_chain=9, n_burn=3, n_thin=2, seed=5, device="cpu",
                        stream=JaxStream(jax.random.key(5)))
    assert set(tres.draws) == set(jres.draws)
    for name in jres.draws:
        assert tres.draws[name].shape == jres.draws[name].shape, name
        np.testing.assert_allclose(tres.posterior_mean(name), jres.posterior_mean(name),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def test_philox_stream_reproducible():
    """The default stream gives the same chain from the same seed and
    another chain from another seed."""
    _, ts = _specs()
    a = ngt.run_lmem(ts, 4, 0, 1, seed=1, device="cpu")
    b = ngt.run_lmem(ts, 4, 0, 1, seed=1, device="cpu")
    c = ngt.run_lmem(ts, 4, 0, 1, seed=2, device="cpu")
    assert np.array_equal(a.draws["betaM"], b.draws["betaM"])
    assert not np.array_equal(a.draws["betaM"], c.draws["betaM"])


def test_unsupported_terms_raise():
    js, ts = _specs()
    g, _ = _data()
    with pytest.raises(ValueError, match="not been measured"):
        ngt.assemble(ts, device="cpu", vshards="auto")
    bad = dataclasses.replace(ts, residual=ngt.RandomEffect(np.ones(N), 1.0))
    with pytest.raises(NotImplementedError, match="residual"):
        ngt.assemble(bad, device="cpu")
    bad = dataclasses.replace(ts, markers=[ngt.MarkerTerm("M2", ngt.from_array(g), None)])
    with pytest.raises(NotImplementedError, match="M2"):
        ngt.assemble(bad, device="cpu")
    bad = dataclasses.replace(ts, random=[js.markers[0]])
    with pytest.raises(NotImplementedError, match="random term M"):
        ngt.assemble(bad, device="cpu")
    with pytest.raises(NotImplementedError, match="out_folder"):
        ngt.run_lmem(ts, 2, 0, 1, out_folder="outMCMC", device="cpu")


def test_fixed_block_multi_column_matches():
    """The multi-column Gauss-Seidel fixed block, from the same draws."""
    rng = np.random.default_rng(3)
    x = np.column_stack([np.ones(N), rng.normal(0, 1, (N, 2))])
    y = x @ np.array([1.0, 0.5, -0.3]) + rng.normal(0, 1, N)
    js = ng.ModelSpec(y=y, fixed=[ng.FixedTerm("a", x[:, 0]), ng.FixedTerm("b", x[:, 1:])],
                      blocks=[("a", "b")])
    ts = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("a", x[:, 0]), ngt.FixedTerm("b", x[:, 1:])],
                       blocks=[("a", "b")])
    jplan, jst = ng.assemble(js)
    tplan, tst = ngt.assemble(ts, device="cpu")
    assert not tplan.fixed[0].single and tplan.fixed[0].k == 3
    jsweep = jax.jit(ng.make_sweep(jplan))
    tsweep = ngt.make_sweep(tplan)
    stream = JaxStream(jax.random.key(2))
    for _ in range(3):
        jst = jsweep(jst, jax.random.key(2))
        tst = tsweep(tst, stream)
    np.testing.assert_allclose(tst.fixed[0].b.numpy(), np.asarray(jst.fixed[0].b), rtol=1e-9)
    np.testing.assert_allclose(tst.ycorr.numpy(), np.asarray(jst.ycorr), rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tst.e.var_e.numpy(), np.asarray(jst.e.var_e), rtol=1e-9)


def test_dists_match():
    """chi2, scaled-inv-chi2, Beta, Dirichlet and the clamped categorical
    against the JAX package's, from the same keys."""
    key = jax.random.key(4)
    stream = JaxStream(key)
    site = Site(7, 4, 2)
    jkey = stream._key(site)
    alpha = np.array([3.0, 1.5, 7.0])
    np.testing.assert_allclose(
        tdists.sample_chi2(stream, site, torch.tensor(5.0, dtype=torch.float64)).numpy(),
        np.asarray(jdists.sample_chi2(jkey, jnp.float64(5.0))), rtol=1e-12)
    np.testing.assert_allclose(
        tdists.sample_scaled_inv_chi2(stream, site, 4.0, torch.tensor(0.5, dtype=torch.float64),
                                      torch.tensor(30.0, dtype=torch.float64), 20.0).numpy(),
        np.asarray(jdists.sample_scaled_inv_chi2(jkey, 4.0, jnp.float64(0.5), jnp.float64(30.0), 20.0)),
        rtol=1e-12)
    np.testing.assert_allclose(
        tdists.sample_beta_dist(stream, site, torch.tensor(2.0, dtype=torch.float64),
                                torch.tensor(3.0, dtype=torch.float64)).numpy(),
        np.asarray(jdists.sample_beta_dist(jkey, jnp.float64(2.0), jnp.float64(3.0))), rtol=1e-12)
    np.testing.assert_allclose(
        tdists.sample_dirichlet(stream, site, torch.from_numpy(alpha)).numpy(),
        np.asarray(jdists.sample_dirichlet(jkey, jnp.asarray(alpha))), rtol=1e-12)
    probs = np.array([[0.2, 0.3, 0.5], [0.1, 0.1, 0.8], [0.5, 0.25, 0.25]])
    u = np.array([0.25, 0.1, 1.0])  # the last sits on the top edge: clamped to K-1
    np.testing.assert_array_equal(
        tdists.categorical_from_probs(torch.from_numpy(u), torch.from_numpy(probs)).numpy(),
        np.asarray(jdists.categorical_from_probs(jnp.asarray(u), jnp.asarray(probs))))
