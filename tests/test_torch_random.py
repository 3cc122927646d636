"""The port's random effects against the JAX package, in float64 on the CPU.

Both packages assemble one spec: an intercept, one random term and a BayesR
marker set (the panel of test_torch_sweep), at V = 1 and V = 4, for each of
  * "I" scan: a 12-level group factor with the identity structure,
  * "A" scan: an animal effect over a 150-animal pedigree (A^-1 dense),
  * "G" scan: a genomic effect with G^-1 of the panel (make_g_inverse),
  * "A" cg:   the same animal effect by perturbed CG (padded sparse A^-1 and
              the Henderson factor),
  * "A" scan with a weighted ("D") residual.
The port draws from `JaxStream` (the JAX package's keys), so the two chains
see the same numbers: after 5 sweeps the continuous fields agree at rtol
1e-9 (the level scan sums in its blocked order, the JAX scan in its own),
delta exactly. CG stops where ||r|| <= 1e-8 ||b||, and two solvers whose
sums round differently stop on iterates that differ at about that level
(~1e-7 relative on small entries of u after ~50 iterations), so the CG
chains are compared with both plans' cg_tol set to 1e-14 (CG_TIGHT), where
the solves agree to rounding; at the default tolerance one draw is held to
the JAX iteration count on the same system. The assembled states agree at 1e-12, and a port chain
continued from a flattened JAX state after 3 sweeps meets the JAX chain
after 5.

Then single stages (one `sample_random_uni` call; one `sample_random_cg`
call with its CG iteration count), `solve_mme` against the JAX `solve_mme`,
RE1's plain version against a per-level loop, the CG draw against the
analytic conditional and a CG chain against the scan chain's posterior (as
tests/test_random_cg.py holds the JAX package) and, with the plain
KeyedStream, that `make_scan_sampler` and `run_lmem` keep the draws of a
loop of `make_sweep` with a scan random term and with a CG term.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu.data import grm as jgrm
from nextgp_tpu.data import pedigree as jped
from nextgp_tpu.engine.samplers import random_effects as jre
from nextgp_tpu.ops import cg as jcg
from nextgp_tpu_torch.data import pedigree as tped
from nextgp_tpu_torch.engine import sweep as tsweep
from nextgp_tpu_torch.engine.rng import STAGE_RANDOM, Site
from nextgp_tpu_torch.engine.samplers import random_effects as tre
from nextgp_tpu_torch.ops import cg as tcg
from nextgp_tpu_torch.ops import random_scan
from nextgp_tpu_torch.utils import replace as treplace
from test_torch_sweep import (
    BLOCK, CHAIN_KEY, N, JaxStream, _data, _flatten, _port_layout, _prior,
)

Q_ANIMALS, N_FOUNDERS = 150, 30
CG_TIGHT = 1e-14
KINDS = ("I-scan", "A-scan", "G-scan", "A-cg", "A-scan-D")


def _pedigree_labels(q=Q_ANIMALS, founders=N_FOUNDERS, seed=31):
    """ids, sire and dam labels of a random pedigree: `founders` without
    parents, then animals whose parents are earlier animals (None when
    unknown), listed in a shuffled order so that the builders must sort."""
    rng = np.random.default_rng(seed)
    ids = [f"a{i}" for i in range(q)]
    sires, dams = [None] * q, [None] * q
    for i in range(founders, q):
        s, d = rng.integers(0, i, 2)
        sires[i] = ids[s] if rng.uniform() > 0.1 else None
        dams[i] = ids[d] if s != d and rng.uniform() > 0.1 else None
    perm = rng.permutation(q)
    return [ids[i] for i in perm], [sires[i] for i in perm], [dams[i] for i in perm]


def _sparse_struct(mod_ped, ped):
    idx, val = mod_ped.a_inverse_padded(ped)
    sire, dam, dsq = mod_ped.a_inverse_factor(ped)
    return dict(iv_idx=idx, iv_val=val, sire=sire, dam=dam, dinv_sqrt=dsq)


def _random_term(mod, kind, g):
    """The random term of `kind` for package `mod` (ng or ngt), built with
    that package's own pedigree and GRM functions."""
    mod_ped = jped if mod is ng else tped
    if kind == "I-scan":
        lvl = np.random.default_rng(32).integers(0, 12, N)
        _, z = mod_ped.incidence_matrix(lvl + 1)
        return mod.RandomTerm("grp", z, prior=mod.Random("I", 0.3))
    if kind == "G-scan":
        gi = jgrm.make_g_inverse(g) if mod is ng else ngt.make_g_inverse(g, device="cpu").numpy()
        return mod.RandomTerm("gen", np.eye(N), prior=mod.Random("G", 0.4), ivstr=gi)
    ped = mod.build_pedigree(*_pedigree_labels())
    rows = ped.index_of([f"a{i}" for i in range(Q_ANIMALS - N, Q_ANIMALS)])  # the last N animals
    z = np.zeros((N, Q_ANIMALS))
    z[np.arange(N), rows] = 1.0
    if kind == "A-cg":
        return mod.RandomTerm("ani", z, prior=mod.Random("A", 0.5, sampler="cg"),
                              sparse_struct=_sparse_struct(mod_ped, ped))
    return mod.RandomTerm("ani", z, prior=mod.Random("A", 0.5), ivstr=mod_ped.a_inverse(ped))


def _specs(kind):
    g, y = _data()
    weights = np.random.default_rng(21).uniform(0.5, 2.0, N) if kind.endswith("-D") else None
    out = []
    for mod in (ng, ngt):
        out.append(mod.ModelSpec(
            y=y, fixed=[mod.FixedTerm("int", np.ones(N))], random=[_random_term(mod, kind, g)],
            markers=[mod.MarkerTerm("M", mod.from_array(g), _prior(mod, "BayesR"))],
            residual=None if weights is None else mod.RandomEffect(weights, 1.0),
            block_size=BLOCK))
    return tuple(out)


def _port_flat(state):
    """Port ModelState -> {"random.0.u": array, ...}, the keys of the JAX
    tree's flatten (None fields left out)."""
    out = {k.rstrip("."): v.numpy() for k, v in tsweep._leaves(state).items()}
    out["sweep_index"] = np.asarray(state.sweep_index)
    out.pop("sweep_counter")
    return out


CONTINUOUS = ("ycorr", "e.var_e", "fixed.0.b", "random.0.u", "random.0.var_u", "markers.0.beta",
              "markers.0.var_beta", "markers.0.pi_hat")


def _assert_chains_agree(tstate, jstate):
    tf, jf = _port_flat(tstate), _flatten(jstate)
    for key in CONTINUOUS:
        np.testing.assert_allclose(tf[key], jf[key], rtol=1e-9, atol=1e-12, err_msg=key)
    np.testing.assert_array_equal(tf["markers.0.delta"], jf["markers.0.delta"])
    assert int(tf["sweep_index"]) == int(jf["sweep_index"])


def _tight(plan):
    """The plan with its CG terms solved to CG_TIGHT."""
    return dataclasses.replace(plan, random=tuple(
        dataclasses.replace(rp, cg_tol=CG_TIGHT) if rp.sampler == "cg" else rp for rp in plan.random))


@pytest.fixture(scope="module", params=[(k, V) for k in KINDS for V in (1, 4)],
                ids=lambda c: f"{c[0]}-V{c[1]}")
def both(request):
    """Both packages' assembled (plan, state) and 5 JAX sweeps."""
    kind, V = request.param
    js, ts = _specs(kind)
    jplan, jstate0 = ng.assemble(js, use_pallas=False, pack2=True, vshards=V)
    tplan, tstate0 = ngt.assemble(ts, device="cpu", dtype=torch.float64, vshards=V)
    jplan, tplan = _tight(jplan), _tight(tplan)
    jsweep = jax.jit(ng.make_sweep(jplan))
    key = jax.random.key(CHAIN_KEY)
    jstates = [jstate0]
    for _ in range(5):
        jstates.append(jsweep(jstates[-1], key))
    return dict(kind=kind, V=V, jplan=jplan, tplan=tplan, tstate0=tstate0, jstates=jstates)


def test_assemble_matches(both):
    tplan, jplan = both["tplan"], both["jplan"]
    rp, jrp = tplan.random[0], jplan.random[0]
    assert (rp.name, rp.q, rp.df, rp.correlated, rp.n_t, rp.sampler, rp.cg_tol, rp.cg_iters) == (
        jrp.name, jrp.q, jrp.df, jrp.correlated, jrp.n_t, jrp.sampler, jrp.cg_tol, jrp.cg_iters)
    jf = {k: _port_layout(k, a, tplan) for k, a in _flatten(both["jstates"][0]).items()}
    tf = _port_flat(both["tstate0"])
    assert set(tf) == set(jf)
    for key in tf:
        if tf[key].dtype.kind == "f":
            scale = max(1.0, float(np.abs(jf[key]).max()))
            np.testing.assert_allclose(tf[key], jf[key], rtol=1e-12, atol=1e-12 * scale, err_msg=key)
        else:
            np.testing.assert_array_equal(tf[key], jf[key], err_msg=key)
            assert key == "sweep_index" or tf[key].dtype == jf[key].dtype, key


def test_five_sweeps_match(both):
    sweep = ngt.make_sweep(both["tplan"])
    stream = JaxStream(jax.random.key(CHAIN_KEY))
    st = both["tstate0"]
    for _ in range(5):
        st = sweep(st, stream)
    _assert_chains_agree(st, both["jstates"][5])
    assert (both["kind"] == "A-cg") == bool(sweep.cg_iterations)


def test_continue_from_jax_state(both):
    """3 JAX sweeps, then the port continues from the flattened JAX state,
    whose random-term fields it reads at the JAX paths."""
    tplan = both["tplan"]
    arrays = _flatten(both["jstates"][3])
    st = ngt.state_from_numpy(tplan, arrays)
    assert st.sweep_index == 3 and torch.equal(st.random[0].u, torch.tensor(arrays["random.0.u"]))
    sweep = ngt.make_sweep(tplan)
    stream = JaxStream(jax.random.key(CHAIN_KEY))
    for _ in range(2):
        st = sweep(st, stream)
    _assert_chains_agree(st, both["jstates"][5])
    with pytest.raises(KeyError, match="missing"):
        ngt.state_from_numpy(tplan, {k: v for k, v in arrays.items() if k != "random.0.var_u"})


@pytest.mark.parametrize("kind", ["I-scan", "A-scan"])
def test_run_lmem_matches(kind):
    """run_lmem keeps u<name> and varU<name> with the JAX package's values."""
    js, ts = _specs(kind)
    jres = ng.run_lmem(js, n_chain=7, n_burn=3, n_thin=2, out_folder=None, seed=5)
    tres = ngt.run_lmem(ts, n_chain=7, n_burn=3, n_thin=2, out_folder=None, seed=5, device="cpu",
                        stream=JaxStream(jax.random.key(5)))
    name = ts.random[0].name
    assert set(tres.draws) == set(jres.draws) >= {f"u{name}", f"varU{name}"}
    for name in jres.draws:
        assert tres.draws[name].shape == jres.draws[name].shape, name
        np.testing.assert_allclose(tres.draws[name], jres.draws[name], rtol=1e-9, atol=1e-12,
                                   err_msg=name)


# ------------------------------------------------------------------ single stages


def _stage_inputs(kind):
    """A JAX state after one sweep and the port's copy of it."""
    js, ts = _specs(kind)
    jplan, jst = ng.assemble(js, use_pallas=False, pack2=True)
    jst = jax.jit(ng.make_sweep(jplan))(jst, jax.random.key(CHAIN_KEY))
    tplan, _ = ngt.assemble(ts, device="cpu", dtype=torch.float64)
    return jplan, jst, tplan, ngt.state_from_numpy(tplan, _flatten(jst))


def test_sample_random_uni_matches():
    jplan, jst, tplan, tst = _stage_inputs("A-scan-D")
    key = jax.random.key(3)
    ju, jv, jy = jre.sample_random_uni(key, jst.random[0], jst.ycorr, jst.e.var_e, jplan.random[0].df)
    site = Site(0, STAGE_RANDOM, 0)
    tu, tv, ty = tre.sample_random_uni(_one_key(key), site, tst.random[0], tst.ycorr, tst.e.var_e,
                                       tplan.random[0].df)
    for out, ref in ((tu, ju), (tv, jv), (ty, jy)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)


def _one_key(key):
    class OneKey(JaxStream):  # a site's split path taken below `key`
        def _key(self, s):
            k = key
            for n, i in s.path:
                k = jax.random.split(k, n)[i]
            return k

    return OneKey(None)


def _jax_cg_iterations(key, rs, ycorr, var_e, rp):
    """The iterations of the JAX sampler's own solve: its system rebuilt as
    sample_random_cg builds it (random_effects.py:45-104), solved by the
    JAX cg_solve."""
    q = rs.u.shape[0]
    k1, k2, _ = jax.random.split(key, 3)
    idx = jnp.where(rs.z_idx >= 0, rs.z_idx, q)
    ive, ivu = 1.0 / var_e, 1.0 / rs.var_u

    def zt(v):
        return jax.ops.segment_sum(v, idx, num_segments=q + 1)[:q]

    def z(v):
        return jnp.concatenate([v, jnp.zeros((1,), v.dtype)])[idx]

    def ivmul(v):
        return jnp.sum(rs.iv_val * v[rs.iv_idx], axis=1)

    def factor_t(x):
        si = jnp.where(rs.fac_sire >= 0, rs.fac_sire, q)
        di = jnp.where(rs.fac_dam >= 0, rs.fac_dam, q)
        half = 0.5 * x
        return (x - jax.ops.segment_sum(half, si, num_segments=q + 1)[:q]
                - jax.ops.segment_sum(half, di, num_segments=q + 1)[:q])

    ycorr = ycorr + z(rs.u)
    e1 = jax.random.normal(k1, ycorr.shape, ycorr.dtype) * jnp.sqrt(var_e)
    s = factor_t(rs.fac_dsqrt * jax.random.normal(k2, (q,), ycorr.dtype)) * jnp.sqrt(ivu)
    rhs = zt(ycorr + e1) * ive + s
    _, it, _ = jcg.cg_solve(lambda v: zt(z(v)) * ive + ivmul(v) * ivu, rhs, x0=rs.u, tol=rp.cg_tol,
                            max_iter=rp.cg_iters)
    return int(it)


def test_sample_random_cg_matches():
    """One CG draw from the same keys. At the default tolerance the port's
    solve stops within one iteration of the JAX solve on the same system
    (the same right-hand side to the bit) and u agrees to what the stopping
    rule leaves open: on this system the last iterations sit at the edge of
    float64, and sums rounded in another order move the residual curve by up
    to a quarter near the stop (0.82 against 1.07 of the threshold at
    iteration 46), so the stop can come one iteration apart; test_cg_solve_
    iteration_count_matches holds the count exactly where the crossing is
    clear. Solved to CG_TIGHT, u, varU and ycorr agree at rtol 1e-9."""
    jplan, jst, tplan, tst = _stage_inputs("A-cg")
    key = jax.random.key(4)
    site = Site(0, STAGE_RANDOM, 0)
    jrp, trp = jplan.random[0], tplan.random[0]
    args = (tst.random[0], tst.ycorr, tst.e.var_e, trp.df)
    tu, _, _, iters = tre.sample_random_cg(_one_key(key), site, *args, trp)
    ju, _, _ = jre.sample_random_cg(key, jst.random[0], jst.ycorr, jst.e.var_e, jrp.df, jrp)
    jax_iters = _jax_cg_iterations(key, jst.random[0], jst.ycorr, jst.e.var_e, jrp)
    assert 0 < iters < trp.cg_iters and abs(iters - jax_iters) <= 1
    np.testing.assert_allclose(tu.numpy(), np.asarray(ju), atol=1e-7 * np.abs(np.asarray(ju)).max())
    jrp, trp = (dataclasses.replace(rp, cg_tol=CG_TIGHT) for rp in (jrp, trp))
    tu, tv, ty, _ = tre.sample_random_cg(_one_key(key), site, *args, trp)
    ju, jv, jy = jre.sample_random_cg(key, jst.random[0], jst.ycorr, jst.e.var_e, jrp.df, jrp)
    for out, ref in ((tu, ju), (tv, jv), (ty, jy)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("tol", [1e-8, 1e-12])
def test_cg_solve_iteration_count_matches(tol):
    """The JAX stopping rule on a system whose residual falls by orders of
    magnitude per iteration near the end (six distinct eigenvalues: CG is
    exact after six), from x0 = 0 and from a start: the same count."""
    rng = np.random.default_rng(6)
    basis, _ = np.linalg.qr(rng.normal(size=(48, 48)))
    a = basis @ np.diag(np.repeat([1.0, 2.0, 4.0, 7.0, 11.0, 16.0], 8)) @ basis.T
    b, x0 = rng.normal(size=48), rng.normal(size=48)
    for start in (None, x0):
        _, jit_, _ = jcg.cg_solve(lambda v: jnp.asarray(a) @ v, jnp.asarray(b),
                                  x0=None if start is None else jnp.asarray(start), tol=tol)
        x, it, _ = tcg.cg_solve(lambda v: torch.from_numpy(a) @ v, torch.from_numpy(b),
                                x0=None if start is None else torch.from_numpy(start), tol=tol)
        assert it == int(jit_) <= 7
        np.testing.assert_allclose(torch.from_numpy(a).matmul(x).numpy(), b, atol=1e-6)


def test_cg_solve_stops_at_max_iter():
    a = torch.diag(torch.arange(1.0, 51.0, dtype=torch.float64))
    b = torch.ones(50, dtype=torch.float64)
    x, it, res = tcg.cg_solve(lambda v: a @ v, b, tol=1e-30, max_iter=7)
    jx, jit_, jres = jcg.cg_solve(lambda v: jnp.asarray(a.numpy()) @ v, jnp.asarray(b.numpy()),
                                  tol=1e-30, max_iter=7)
    assert it == int(jit_) == 7
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=1e-12)
    np.testing.assert_allclose(float(res), float(jres), rtol=1e-9)


def test_solve_mme_matches():
    """The BLUP/ridge solution of a small BayesPR model with a random term,
    at V = 4 (the port unpacks its own layout), against the JAX solve_mme."""
    g, y = _data()
    specs = []
    for mod in (ng, ngt):
        specs.append(mod.ModelSpec(
            y=y, fixed=[mod.FixedTerm("int", np.ones(N))], random=[_random_term(mod, "I-scan", g)],
            markers=[mod.MarkerTerm("M", mod.from_array(g), mod.BayesPR(9999, 0.05))],
            block_size=BLOCK))
    jplan, jst = ng.assemble(specs[0], use_pallas=False, pack2=True, vshards=4)
    tplan, tst = ngt.assemble(specs[1], device="cpu", dtype=torch.float64, vshards=4)
    jout, jit_, jres = jcg.solve_mme(jplan, jst, jnp.asarray(1.3))
    tout, tit, tres = tcg.solve_mme(tplan, tst, torch.tensor(1.3, dtype=torch.float64))
    assert set(tout) == set(jout) == {"b:int", "u:grp", "beta:M"}
    assert abs(tit - jit_) <= 2 and tres < 1e-6
    for k in jout:
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-6,
                                   atol=1e-8 * np.abs(np.asarray(jout[k])).max(), err_msg=k)


# ------------------------------------------------------------------ RE1's plain version


def _loop_scan(ivstr, yi, zpz, z, u, ive, ivu):
    """The JAX scan's body as a per-level loop (random_effects.py:29-37)."""
    u = u.copy()
    for i in range(len(u)):
        u[i] = 0.0
        rhs = yi[i] - ivu * np.dot(ivstr[i], u)
        lhs = zpz[i] * ive + ivstr[i, i] * ivu
        u[i] = rhs / lhs + z[i] * np.sqrt(1.0 / lhs)
    return u


@pytest.mark.parametrize("q,tile", [(1, 1024), (37, 1024), (37, 8), (64, 32), (65, 32), (100, 7),
                                    (300, random_scan.GROUP)])
def test_level_scan_plain_matches_loop(q, tile):
    """One tile and several, q a multiple of the tile or not, q = 1; at the
    kernel's group of 32, q = 300 has row blocks past the look-ahead (far
    sums, a window and the last group each)."""
    rng = np.random.default_rng(q + tile)
    m = rng.normal(size=(q, q))
    ivstr = m @ m.T / q + np.eye(q)
    yi, zpz, z, u = rng.normal(size=q), rng.uniform(0, 3, q), rng.normal(size=q), rng.normal(size=q)
    ive, ivu = 1.7, 0.6
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    out = random_scan.level_scan_plain(t(ivstr), t(yi), t(zpz), t(z), t(u), t(ive), t(ivu), tile=tile)
    np.testing.assert_allclose(out.numpy(), _loop_scan(ivstr, yi, zpz, z, u, ive, ivu),
                               rtol=1e-9, atol=1e-12)
    # and the wrapper takes the plain version for CPU tensors
    assert torch.equal(random_scan.level_scan(t(ivstr), t(yi), t(zpz), t(z), t(u), t(ive), t(ivu)),
                       random_scan.level_scan_plain(t(ivstr), t(yi), t(zpz), t(z), t(u), t(ive),
                                                    t(ivu)))


@pytest.mark.parametrize("q", [1, 37, 300])
def test_level_scan_trisolve_matches_plain(q):
    """The level scan as one unit lower-triangular solve (level_scan_system
    and the library call chip_smoke.py times beside RE1) equals the plain
    version in float64."""
    rng = np.random.default_rng(q)
    m = rng.normal(size=(q, q))
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    args = (t(m @ m.T / q + np.eye(q)), t(rng.normal(size=q)), t(rng.uniform(0, 3, q)),
            t(rng.normal(size=q)), t(rng.normal(size=q)), t(1.7), t(0.6))
    ref = random_scan.level_scan_plain(*args)
    mat, rhs = random_scan.level_scan_system(*args)
    out = torch.linalg.solve_triangular(mat, rhs, upper=False, unitriangular=True)[:, 0]
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-9, atol=1e-9 * ref.abs().max().item())


# ------------------------------------------------------------------ CG, statistically

Q_CG = 30


@pytest.fixture
def small_ped():
    """The 30-animal pedigree of tests/test_random_cg.py, in the port."""
    rng = np.random.default_rng(42)
    n = Q_CG
    sire = np.full(n, -1, np.int64)
    dam = np.full(n, -1, np.int64)
    for i in range(8, n):
        s, d = rng.integers(0, i, 2)
        if s != d:
            sire[i], dam[i] = s, d
    f = tped.inbreeding_meuwissen_luo(sire, dam)
    return tped.Pedigree(ids=[f"A{i}" for i in range(n)], sire=sire, dam=dam, inbreeding=f), rng


def _cg_term(ped, lvl, v=0.8):
    return ngt.RandomTerm("a", None, prior=ngt.Random("A", v, sampler="cg"), z_idx=lvl,
                          n_levels=ped.n, sparse_struct=_sparse_struct(tped, ped))


def test_cg_draw_matches_analytic_conditional(small_ped):
    ped, rng = small_ped
    q, n = ped.n, 60
    lvl = rng.integers(0, q, n)
    y = rng.normal(0, 1, n)
    spec = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))], random=[_cg_term(ped, lvl)])
    plan, state = ngt.assemble(spec, device="cpu")
    var_e, var_u = 1.3, 0.8
    rp = plan.random[0]
    rs = treplace(state.random[0], var_u=torch.tensor(var_u, dtype=torch.float64))
    z = np.zeros((n, q))
    z[np.arange(n), lvl] = 1.0
    cov = np.linalg.inv(z.T @ z / var_e + tped.a_inverse(ped) / var_u)
    mean = cov @ (z.T @ y) / var_e
    stream = ngt.PhiloxStream(0, "cpu", torch.float64)
    draws = np.asarray([tre.sample_random_cg(stream, Site(i, STAGE_RANDOM, 0), rs,
                                             torch.as_tensor(y), torch.tensor(var_e, dtype=torch.float64),
                                             rp.df, rp)[0].numpy() for i in range(600)])
    se = np.sqrt(np.diag(cov) / len(draws))
    assert np.all(np.abs(draws.mean(0) - mean) < 5 * se)
    np.testing.assert_allclose(np.cov(draws.T), cov, atol=6 * np.abs(cov).max() / np.sqrt(len(draws)))


def test_cg_chain_matches_scan_posterior(small_ped):
    ped, rng = small_ped
    q, n = ped.n, 80
    lvl = rng.integers(0, q, n)
    u_true = rng.normal(0, 0.8, q)
    y = 1.0 + u_true[lvl] + rng.normal(0, 0.5, n)
    z = np.zeros((n, q))
    z[np.arange(n), lvl] = 1.0
    scan = ngt.RandomTerm("a", z, prior=ngt.Random("A", 0.8), ivstr=tped.a_inverse(ped))

    def run(term):
        spec = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))], random=[term])
        plan, st = ngt.assemble(spec, device="cpu")
        sweep, stream = ngt.make_sweep(plan), ngt.PhiloxStream(11, "cpu", torch.float64)
        us, vs = [], []
        for i in range(1600):
            st = sweep(st, stream)
            if i >= 200:
                us.append(st.random[0].u.numpy())
                vs.append(float(st.random[0].var_u))
        return np.mean(us, axis=0), np.mean(vs)

    u_scan, v_scan = run(scan)
    u_cg, v_cg = run(_cg_term(ped, lvl))
    # both chains carry MC error (the scan sampler is autocorrelated); the
    # analytic-conditional test above pins the CG draw
    assert np.corrcoef(u_scan, u_cg)[0, 1] > 0.95
    assert abs(v_scan - v_cg) < 0.35 * max(v_scan, v_cg)


# ------------------------------------------------------------------ runners


N_KEEP, THIN = 3, 2


def _runners_keep_the_loop_draws(kind):
    """With the plain KeyedStream, make_scan_sampler and run_lmem keep the
    draws of a loop of make_sweep from the same stream, bit for bit."""
    _, ts = _specs(kind)
    plan, st0 = ngt.assemble(ts, device="cpu", dtype=torch.float64, vshards=4)
    stream = ngt.KeyedStream(13, "cpu", torch.float64)
    st, draws = ngt.make_scan_sampler(plan, N_KEEP, THIN)(st0, stream)
    sweep, loop, kept = ngt.make_sweep(plan), st0, []
    for _ in range(N_KEEP):
        for _ in range(THIN):
            loop = sweep(loop, stream)
        kept.append(ngt.collect_sample(loop, plan))
    name = plan.random[0].name
    assert {f"u{name}", f"varU{name}"} <= set(draws) == set(kept[0])
    for k, d in draws.items():
        assert torch.equal(d, torch.stack([x[k] for x in kept])), k
    assert torch.equal(st.ycorr, loop.ycorr) and torch.equal(st.random[0].u, loop.random[0].u)
    res = ngt.run_lmem(ts, n_chain=9, n_burn=3, n_thin=2, out_folder=None, device="cpu", vshards=4,
                       stream=ngt.KeyedStream(5, "cpu", torch.float64))
    loop, kept = ngt.assemble(ts, device="cpu", vshards=4)[1], []
    stream = ngt.KeyedStream(5, "cpu", torch.float64)
    for i in range(1, 10):
        loop = sweep(loop, stream)
        if i >= 5 and (i - 5) % 2 == 0:
            kept.append(ngt.collect_sample(loop, plan))
    for k, d in res.draws.items():
        np.testing.assert_array_equal(d, torch.stack([x[k] for x in kept]).numpy(), err_msg=k)
    return sweep


@pytest.mark.parametrize("kind", ["A-scan", "G-scan"])
def test_runners_keep_the_loop_draws(kind):
    """With the plain KeyedStream and a scan random term, the runners keep
    the draws of a loop of make_sweep (_runners_keep_the_loop_draws)."""
    _runners_keep_the_loop_draws(kind)


def test_replayed_runners_take_a_cg_term():
    """The runners that replay on the card take a CG term too: on the CPU,
    with a KeyedStream, make_scan_sampler and run_lmem run the A-cg plan
    and keep the draws of a loop of make_sweep, bit for bit, and each sweep
    leaves its CG iteration count as a 0-d int32 tensor; run_lmem with the
    default stream runs it as well."""
    sweep = _runners_keep_the_loop_draws("A-cg")
    it = sweep.cg_iterations[0]
    assert isinstance(it, torch.Tensor) and it.dtype == torch.int32 and it.shape == ()
    assert 0 < int(it) < 1000
    _, ts = _specs("A-cg")
    res = ngt.run_lmem(ts, 3, 1, 1, out_folder=None, device="cpu", seed=2)
    assert res.draws["uani"].shape == (2, Q_ANIMALS) and np.isfinite(res.draws["varUani"]).all()


def test_correlated_group_raises():
    """A correlated group is ported (tests/test_torch_corr.py); what the JAX
    planner refuses for one, the port refuses too: a prior v that is not
    nT x nT, and the CG sampler."""
    js, ts = _specs("I-scan")
    z = ts.random[0].z
    for v, sampler, match in ((np.eye(3), "scan", "nT x nT prior v"), (0.5, "scan", "nT x nT prior v"),
                              (np.eye(2), "cg", "correlated groups")):
        for mod, spec in ((ng, js), (ngt, ts)):
            bad = dataclasses.replace(spec, random=[mod.RandomTerm(
                ("m1", "m2"), (z, z), prior=mod.Random("I", v, sampler=sampler))])
            with pytest.raises(ValueError, match=match):
                if mod is ng:
                    ng.assemble(bad, use_pallas=False)
                else:
                    ngt.assemble(bad, device="cpu")


def test_trace_and_roofline_see_the_random_stage(tmp_path):
    """The random stage runs under its `gibbs.random.<i>` scope, between the
    fixed blocks and the markers, and the roofline adds its bytes: Z twice,
    Z' once, the structure twice; a CG term the bytes of the iterations it
    is given (diag.cg_work over the live entries of K; its iterations
    depend on the data, so the roofline takes them from the caller)."""
    from nextgp_tpu_torch import diag

    _, ts = _specs("A-scan")
    plan, st = ngt.assemble(ts, device="cpu")
    sweep, stream = ngt.make_sweep(plan), ngt.PhiloxStream(3, "cpu", torch.float64)
    with diag.trace(str(tmp_path / "trace")) as prof:
        for _ in range(2):
            st = sweep(st, stream)
    counts = {e.key: e.count for e in prof.key_averages() if e.key.startswith("gibbs.")}
    assert counts == dict.fromkeys(("gibbs.var_e", "gibbs.fixed.0", "gibbs.random.0",
                                    "gibbs.marker.M"), 2)
    bare = dataclasses.replace(plan, random=())
    q = plan.random[0].q
    extra = diag.roofline(plan).bytes_per_sweep - diag.roofline(bare).bytes_per_sweep
    assert extra == 8 * (3.0 * N * q + 2.0 * q * q)
    cg_plan, _ = ngt.assemble(_specs("A-cg")[1], device="cpu")
    rp = cg_plan.random[0]
    for iters in (1, 50):
        extra = diag.roofline(cg_plan, cg_iterations=iters).bytes_per_sweep - diag.roofline(
            dataclasses.replace(cg_plan, random=()), cg_iterations=iters).bytes_per_sweep
        assert extra == diag.cg_work(int(rp.iv_len.sum()), rp.q, cg_plan.dtype, iters)[0] > 0
