"""The port's marker methods against the JAX package, end to end, in float64.

Both packages assemble one spec (intercept + one packed marker set) for
each of BayesPR (windows of 20 SNPs on an interleaved two-chromosome map),
BayesB, BayesC, BayesR, BayesRCpi, BayesRCplus (all with estimatePi; three
annotations, one of them on every locus) and BayesLV (a three-column
covariate matrix; estimateVarZeta False, True and 0.5), each with a plain
("I") and a weighted ("D") residual, at V = 1 and V = 4. The port runs
on the CPU through its plain versions and draws from `JaxStream`, which
reproduces the JAX package's keys with jax.random, so the two chains see
the same numbers. Continuous fields agree to rtol 1e-9 (the two evaluate
the same algebra in another order: the JAX pure path restores beta_old
explicitly, the port folds it into the coefficients); delta and the
annotation categories are exactly equal. Summary statistics (a fixed column
and a marker set, with a v = 0 entry) and panels with padded loci are held
to the JAX package the same way.
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
from nextgp_tpu_torch.engine.rng import Site, SplitByLoop
from nextgp_tpu_torch.ops import dists as tdists

N, P, BLOCK = 120, 256, 16
CHAIN_KEY = 9


class JaxStream(SplitByLoop):
    """The port's stream seam, answered with the JAX package's keys:
    site (sweep, stage, index, splits) -> stage_key(fold_in(chain, sweep),
    stage, index), then jax.random.split(key, n)[i] along the path. Split
    draws are one draw per row."""

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


METHODS = ("BayesPR", "BayesB", "BayesC", "BayesR", "BayesRCpi", "BayesRCplus", "BayesLV",
           "BayesLV-est", "BayesLV-0.5")
RC_PI, RC_CLASSES = [0.85, 0.1, 0.05], [0.0, 1e-3, 1e-2]
CASES = [(m, w) for m in METHODS for w in (False, True)]


def _case_id(case):
    return f"{case[0]}-{'D' if case[1] else 'I'}"


def _data(p=P):
    rng = np.random.default_rng(20)
    g = rng.integers(0, 3, (N, p)).astype(float)
    bt = np.zeros(p)
    bt[rng.choice(p, 12, replace=False)] = rng.normal(0, 0.4, 12)
    y = 1.0 + (g - g.mean(0)) @ bt + rng.normal(0, 1, N)
    return g, y


def _prior(mod, method, p=P):
    if method == "BayesPR":
        return mod.BayesPR(20, 0.05)
    if method in ("BayesB", "BayesC"):
        return getattr(mod, method)(0.3, 0.05, estimatePi=True)
    if method in ("BayesRCpi", "BayesRCplus"):
        # the first annotation on every locus, the others on about half of them
        annot = np.random.default_rng(22).integers(0, 2, (p, 3)) | np.array([1, 0, 0])
        return getattr(mod, method)(RC_PI, RC_CLASSES, 1.0, annot, estimatePi=True)
    if method.startswith("BayesLV"):
        cov = np.random.default_rng(23).normal(0, 1, (p, 3))
        est = {"BayesLV": False, "BayesLV-est": True, "BayesLV-0.5": 0.5}[method]
        return mod.BayesLV(0.01, cov, 0.01, estimateVarZeta=est)
    return mod.BayesR([0.85, 0.08, 0.05, 0.02], [0.0, 1e-3, 1e-2, 1e-1], 1.0, estimatePi=True)


def _specs(method="BayesR", weighted=False, p=P, summary_stats=None):
    g, y = _data(p)
    chr_ids = (np.arange(p) // 48) % 2 + 1  # chromosomes 1 and 2, interleaved
    weights = np.random.default_rng(21).uniform(0.5, 2.0, N) if weighted else None
    out = []
    for mod in (ng, ngt):
        out.append(mod.ModelSpec(
            y=y, fixed=[mod.FixedTerm("int", np.ones(N))],
            markers=[mod.MarkerTerm("M", mod.from_array(g, chr_ids=chr_ids),
                                    _prior(mod, method, p))],
            residual=None if weights is None else mod.RandomEffect(weights, 1.0),
            summary_stats={k: mod.SummaryStatistics(*mv) for k, mv in (summary_stats or {}).items()},
            block_size=BLOCK))
    return tuple(out)


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
              "markers.0.gram": (T, B, V, B), "markers.0.gram_raw": (T, B, V, B)}
    return a.reshape(shapes[key]) if key in shapes else a


def _port_flat(state):
    """Port ModelState -> the same keys, leaving out None fields as JAX's
    tree flatten does."""
    out = {"y": state.y, "ycorr": state.ycorr, "sweep_index": np.asarray(state.sweep_index)}
    for f in dataclasses.fields(state.e):
        out[f"e.{f.name}"] = getattr(state.e, f.name)
    for i, fs in enumerate(state.fixed):
        for f in dataclasses.fields(fs):
            out[f"fixed.{i}.{f.name}"] = getattr(fs, f.name)
    for i, ms in enumerate(state.markers):
        for f in dataclasses.fields(ms):
            out[f"markers.{i}.{f.name}"] = getattr(ms, f.name)
    return {k: np.asarray(v) for k, v in out.items() if v is not None}


def _assert_chains_agree(port_state, jax_state, plan):
    jf = _flatten(jax_state)
    tf = _port_flat(port_state)
    mp = plan.markers[0]
    keys = ["ycorr", "e.var_e", "fixed.0.b", "markers.0.beta", "markers.0.var_beta"]
    exact = ["markers.0.delta"]
    if mp.n_classes:
        keys += ["markers.0.pi_hat", "markers.0.log_pi"]
    if mp.n_annot:
        keys += ["markers.0.annot_prob"]
        exact += ["markers.0.annot_cat"]
    if mp.n_lv_cov:
        keys += [f"markers.0.{f}" for f in ("log_var", "lv_c", "lv_resid", "var_zeta")]
    for key in keys:
        np.testing.assert_allclose(tf[key], jf[key], rtol=1e-9, atol=1e-12, err_msg=key)
    for key in exact:
        np.testing.assert_array_equal(tf[key], jf[key], err_msg=key)
    assert int(tf["sweep_index"]) == int(jf["sweep_index"])


@pytest.fixture(scope="module", params=[(m, w, V) for m, w in CASES for V in (1, 4)],
                ids=lambda c: f"{_case_id(c[:2])}-V{c[2]}")
def both(request):
    """Both packages' assembled (plan, state) and 5 JAX sweeps for one
    method, residual and V."""
    method, weighted, V = request.param
    js, ts = _specs(method, weighted)
    jplan, jstate0 = ng.assemble(js, use_pallas=False, pack2=True, vshards=V)
    tplan, tstate0 = ngt.assemble(ts, device="cpu", dtype=torch.float64, vshards=V)
    jsweep = jax.jit(ng.make_sweep(jplan))
    key = jax.random.key(CHAIN_KEY)
    jstates = [jstate0]
    for _ in range(5):
        jstates.append(jsweep(jstates[-1], key))
    return dict(V=V, method=method, weighted=weighted, jplan=jplan, tplan=tplan, tstate0=tstate0,
                jstates=jstates)


def test_assemble_matches(both):
    tplan, jstates = both["tplan"], both["jstates"]
    mp, jmp = tplan.markers[0], both["jplan"].markers[0]
    assert mp.vshards == both["V"] and mp.method == jmp.method == both["method"].split("-")[0]
    assert (mp.n_var, mp.n_regions, mp.n_classes, mp.est_pi, mp.df, mp.weighted, mp.n_annot,
            mp.n_lv_cov, mp.est_var_zeta) == (
        jmp.n_var, jmp.n_regions, jmp.n_classes, jmp.est_pi, jmp.df, jmp.weighted, jmp.n_annot,
        jmp.n_lv_cov, jmp.est_var_zeta)
    assert tplan.weighted == both["jplan"].weighted == both["weighted"]
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
    """Every field the plan carries must be given, and no other: a field
    the plan leaves None (JAX's flatten drops it) is unknown when given."""
    arrays = _flatten(both["jstates"][0])
    with pytest.raises(KeyError, match="unknown"):
        ngt.state_from_numpy(both["tplan"], {**arrays, "markers.0.no_such_field": arrays["y"]})
    absent = "lv_c" if both["tplan"].markers[0].n_lv_cov == 0 else "annot_cat"
    with pytest.raises(KeyError, match="unknown"):
        ngt.state_from_numpy(both["tplan"], {**arrays, f"markers.0.{absent}": arrays["y"]})
    if not both["weighted"]:
        with pytest.raises(KeyError, match="unknown"):
            ngt.state_from_numpy(both["tplan"], {**arrays, "e.d_inv": arrays["y"]})
    del arrays["markers.0.beta"]
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


@pytest.mark.parametrize("V", [1, 4], ids=["V1", "V4"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_run_lmem_matches(case, V):
    js, ts = _specs(*case)
    jres = ng.run_lmem(js, n_chain=9, n_burn=3, n_thin=2, out_folder=None, seed=5, vshards=V)
    tres = ngt.run_lmem(ts, n_chain=9, n_burn=3, n_thin=2, out_folder=None, seed=5, device="cpu",
                        vshards=V,
                        stream=JaxStream(jax.random.key(5)))
    assert set(tres.draws) == set(jres.draws)
    for name in jres.draws:
        assert tres.draws[name].shape == jres.draws[name].shape, name
        np.testing.assert_allclose(tres.posterior_mean(name), jres.posterior_mean(name),
                                   rtol=1e-9, atol=1e-12, err_msg=name)


def _three_sweeps_agree(js, ts):
    jplan, jst = ng.assemble(js, use_pallas=False, pack2=True)
    tplan, tst = ngt.assemble(ts, device="cpu", dtype=torch.float64)
    jf, tf = _flatten(jst), _port_flat(tst)
    for key in ("fixed.0.lhs_ss", "fixed.0.rhs_ss", "markers.0.lhs_ss", "markers.0.rhs_ss",
                "markers.0.mask"):
        np.testing.assert_allclose(tf[key], jf[key], rtol=1e-12, err_msg=key)
    jsweep, tsweep = jax.jit(ng.make_sweep(jplan)), ngt.make_sweep(tplan)
    stream = JaxStream(jax.random.key(CHAIN_KEY))
    for _ in range(3):
        jst = jsweep(jst, jax.random.key(CHAIN_KEY))
        tst = tsweep(tst, stream)
    _assert_chains_agree(tst, jst, tplan)
    return tplan, tst


R20_PI = [0.62] + [0.02] * 19
R20_CLASSES = [0.0] + list(np.geomspace(1e-4, 1e-1, 19))


@pytest.mark.parametrize("V", [1, 4], ids=["V1", "V4"])
def test_bayesr_20_classes_matches(V):
    """A 20-class BayesR, which the port's K3 kernel refused on the card while
    it took at most 16 classes, on the CPU against the JAX package: five
    sweeps from the same draws, continuous fields at rtol 1e-9, delta exact."""
    g, y = _data()
    js, ts = (mod.ModelSpec(y=y, fixed=[mod.FixedTerm("int", np.ones(N))],
                            markers=[mod.MarkerTerm("M", mod.from_array(g),
                                                    mod.BayesR(R20_PI, R20_CLASSES, 1.0, estimatePi=True))],
                            block_size=BLOCK) for mod in (ng, ngt))
    jplan, jst = ng.assemble(js, use_pallas=False, pack2=True, vshards=V)
    tplan, tst = ngt.assemble(ts, device="cpu", dtype=torch.float64, vshards=V)
    assert tplan.markers[0].n_classes == jplan.markers[0].n_classes == 20
    jsweep, tsweep = jax.jit(ng.make_sweep(jplan)), ngt.make_sweep(tplan)
    stream = JaxStream(jax.random.key(CHAIN_KEY))
    for _ in range(5):
        jst = jsweep(jst, jax.random.key(CHAIN_KEY))
        tst = tsweep(tst, stream)
    _assert_chains_agree(tst, jst, tplan)
    assert tst.markers[0].delta.max().item() > 16  # classes past the old cap were drawn


def test_summary_statistics_match():
    """Offsets 1/v and m/v on a single fixed column and on a marker set; two
    entries with v = 0 and m = 0 (lhs = inf and rhs = nan, both guarded to
    0) reach the marker guards."""
    rng = np.random.default_rng(24)
    v = rng.uniform(0.5, 2.0, P)
    m = rng.normal(0, 0.05, P)
    v[3] = v[7] = m[3] = m[7] = 0.0
    ss = {"int": (np.array([0.8]), np.array([0.25])), "M": (m, v)}
    tplan, tst = _three_sweeps_agree(*_specs("BayesR", summary_stats=ss))
    lhs = tst.markers[0].lhs_ss.reshape(-1)
    rhs = tst.markers[0].rhs_ss.reshape(-1)
    assert lhs[3] == 0 and lhs[7] == 0 and rhs[3] == 0 and rhs[7] == 0 and (lhs > 0).sum() == P - 2
    assert torch.isfinite(tst.markers[0].rhs_ss).all() and tst.fixed[0].lhs_ss[0] == 4.0


def test_unconsumed_summary_statistics_warn():
    """Offsets on a multi-column block are read by no sampler, in the
    reference too; both packages say so."""
    x = np.random.default_rng(3).normal(0, 1, (N, 2))
    y = np.random.default_rng(4).normal(0, 1, N)
    for mod in (ng, ngt):
        spec = mod.ModelSpec(y=y, fixed=[mod.FixedTerm("a", x[:, 0]), mod.FixedTerm("b", x[:, 1])],
                             blocks=[("a", "b")],
                             summary_stats={("a", "b"): mod.SummaryStatistics(np.zeros(2), np.ones(2))})
        with pytest.warns(UserWarning, match="not consumed"):
            mod.assemble(spec, **({"device": "cpu"} if mod is ngt else {}))


@pytest.mark.parametrize("method", ["BayesRCpi", "BayesRCplus", "BayesLV-est"])
def test_padded_loci_match(method):
    """250 loci in blocks of 16: six padded loci, whose annotation rows are
    empty (the scans' NaN probabilities there must stay out of the state)."""
    tplan, tst = _three_sweeps_agree(*_specs(method, p=250))
    ms = tst.markers[0]
    assert tplan.markers[0].p_pad == 256 and not ms.mask.reshape(-1)[250:].any()
    assert (ms.beta[250:] == 0).all() and torch.isfinite(ms.beta).all()
    if tplan.markers[0].n_annot:
        assert (ms.annot_prob[250:] == 0).all() and (ms.annot_cat[250:] == 0).all()


def test_bayeslv_formula_string_raises():
    """What BayesLV's covariates refuse, as in the JAX package: a formula
    string without its covariate_table, and a design without nSNP rows. (A
    formula string with its table runs: tests/test_torch_formula.py.)"""
    _, ts = _specs()
    g, _ = _data()
    bad = dataclasses.replace(ts, markers=[ngt.MarkerTerm(
        "M", ngt.from_array(g), ngt.BayesLV(0.01, "1 + x1", 0.01))])
    with pytest.raises(ValueError, match="needs covariate_table="):
        ngt.assemble(bad, device="cpu")
    bad = dataclasses.replace(ts, markers=[ngt.MarkerTerm(
        "M", ngt.from_array(g), ngt.BayesLV(0.01, np.ones((P - 1, 2)), 0.01))])
    with pytest.raises(ValueError, match="nSNP rows"):
        ngt.assemble(bad, device="cpu")


@pytest.mark.parametrize("V", [1, 4], ids=["V1", "V4"])
@pytest.mark.parametrize("ones", [False, True], ids=["covariates", "ones+covariates"])
def test_bayeslv_float32_follows_float64(ones, V):
    """The variance draw's powers, exponentials and logarithms in float32:
    30 sweeps from the same host draws stay on the float64 chain. Without a
    column of ones the design cannot carry the mean log-variance, so the
    variances are drawn around exp(0) = 1 whatever they started from; with
    one they stay near their start."""
    from nextgp_tpu_torch.engine.rng import HostStream

    g, y = _data()
    cov = np.random.default_rng(23).normal(0, 1, (P, 3))
    if ones:
        cov = np.column_stack([np.ones(P), cov])
    spec = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(N))],
                         markers=[ngt.MarkerTerm("M", ngt.from_array(g), ngt.BayesLV(0.01, cov, 0.01))],
                         block_size=BLOCK)
    out = {}
    for dtype in (torch.float32, torch.float64):
        plan, st = ngt.assemble(spec, device="cpu", dtype=dtype, vshards=V)
        sweep, draws = ngt.make_sweep(plan), HostStream(5, "cpu", dtype)
        for _ in range(30):
            st = sweep(st, draws)
        out[dtype] = st
    m32, m64 = out[torch.float32].markers[0], out[torch.float64].markers[0]
    assert m32.var_beta.dtype == torch.float32 and torch.isfinite(m32.var_beta).all()
    np.testing.assert_allclose(m32.log_var.numpy(), m64.log_var.numpy(), atol=1e-3)
    np.testing.assert_allclose(m32.beta.numpy(), m64.beta.numpy(), atol=1e-3 * m64.beta.abs().max().item())
    np.testing.assert_allclose(out[torch.float32].e.var_e.item(), out[torch.float64].e.var_e.item(),
                               rtol=1e-3)
    median = m64.var_beta[:P].median().item()
    assert (median < 0.05) if ones else (0.5 < median < 2.0)


def test_philox_stream_reproducible():
    """The default stream gives the same chain from the same seed and
    another chain from another seed."""
    _, ts = _specs()
    a = ngt.run_lmem(ts, 4, 0, 1, out_folder=None, seed=1, device="cpu")
    b = ngt.run_lmem(ts, 4, 0, 1, out_folder=None, seed=1, device="cpu")
    c = ngt.run_lmem(ts, 4, 0, 1, out_folder=None, seed=2, device="cpu")
    assert np.array_equal(a.draws["betaM"], b.draws["betaM"])
    assert not np.array_equal(a.draws["betaM"], c.draws["betaM"])


def test_unsupported_terms_raise():
    js, ts = _specs()
    g, _ = _data()
    bad = dataclasses.replace(ts, residual=ngt.RandomEffect("A", 1.0))
    with pytest.raises(NotImplementedError, match="residual"):
        ngt.assemble(bad, device="cpu")
    bad = dataclasses.replace(ts, markers=[ngt.MarkerTerm("M2", ngt.from_array(g),
                                                          ngt.RandomEffect("I", 1.0))])
    with pytest.raises(NotImplementedError, match="M2"):
        ngt.assemble(bad, device="cpu")
    # a matrix v on a single marker set: the JAX planner takes it and its
    # sweep raises a TypeError; the port raises the TypeError up front
    bad_j = dataclasses.replace(js, markers=[ng.MarkerTerm("M3", ng.from_array(g),
                                                           ng.BayesPR(9999, np.eye(2)))])
    with pytest.raises(TypeError):
        ng.run_lmem(bad_j, 1, 0, 1, out_folder=None)
    bad = dataclasses.replace(ts, markers=[ngt.MarkerTerm("M3", ngt.from_array(g),
                                                          ngt.BayesPR(9999, np.eye(2)))])
    with pytest.raises(TypeError, match="M3.*CorrMarkerTerm"):
        ngt.assemble(bad, device="cpu")
    # a correlated group by CG raises as in the JAX package
    z = np.eye(N)
    bad = dataclasses.replace(ts, random=[ngt.RandomTerm(("u1", "u2"), (z, z),
                                                         prior=ngt.Random("I", np.eye(2), sampler="cg"))])
    with pytest.raises(ValueError, match="correlated groups"):
        ngt.assemble(bad, device="cpu")


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
