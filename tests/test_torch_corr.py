"""The port's correlated terms against the JAX package, in float64 on the CPU.

Correlated marker sets (nT panels of one set of loci under BayesPR with an
nT x nT v) at V in {1, 2} and nT in {2, 3}, and a correlated random group
(an intercept and a slope on one incidence) on the identity and on a small
pedigree's A^-1, each beside an intercept, on the golden suite's sizes
(n = 60, p = 32, B = 16, q = 8 levels; int8 dosages, so that both packages
pack them). The port draws from `JaxStream` (the JAX package's keys), so the
two chains see the same numbers: after 3-4 sweeps beta, var_beta (n_regions,
nT, nT), u, var_u, varE and ycorr agree at rtol 1e-9 (the port evaluates the
same algebra in another order: the rule of every locus or level first, the
chain's sums right-looking). The assembled states agree at 1e-12, and a
port chain continued from a flattened JAX state meets the JAX chain.

Then the draws (Wishart and inverse-Wishart key for key; every stream's
split draws row for row against its plain draws; the keyed split draw's
plain version against a loop of the single-site one; the inverse-Wishart's
mean), the plain versions of RE2 and CM1 against transcriptions of the JAX
scans' bodies, one stage of each path against the JAX stage, and the
planner's warning on distinct incidences.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu.api.spec import CorrMarkerTerm as JCorrMarkerTerm
from nextgp_tpu.data import pedigree as jped
from nextgp_tpu.engine.samplers import markers as jmarkers
from nextgp_tpu.engine.samplers import random_effects as jre
from nextgp_tpu.ops import dists as jdists
from nextgp_tpu_torch.data import pedigree as tped
from nextgp_tpu_torch.engine import rng as trng
from nextgp_tpu_torch.engine.rng import STAGE_MARKER, STAGE_RANDOM, Site
from nextgp_tpu_torch.engine.samplers import markers as tmarkers
from nextgp_tpu_torch.engine.samplers import random_effects as tre
from nextgp_tpu_torch.ops import corr_scan, random_scan
from nextgp_tpu_torch.ops import dists as tdists
from test_torch_random import _port_flat, _pedigree_labels
from test_torch_sweep import JaxStream, _flatten

N, P, BLOCK, Q = 60, 32, 16, 8
CHAIN_KEY = 13
V_PRIORS = {2: np.array([[0.02, 0.005], [0.005, 0.015]]),
            3: np.array([[0.02, 0.005, 0.002], [0.005, 0.015, 0.003], [0.002, 0.003, 0.01]])}


def _marker_specs(n_t):
    """Both packages' specs: an intercept and nT correlated panels; with
    nT = 2 one region per locus (r = 1), with nT = 3 one whole-genome region."""
    rng = np.random.default_rng(40 + n_t)
    gs = [rng.integers(0, 3, (N, P)).astype(np.int8) for _ in range(n_t)]
    y = 1.0 + sum((g - g.mean(0)) @ rng.normal(0, 0.12, P) for g in gs) + rng.normal(0, 1, N)
    names = tuple(f"M{t + 1}" for t in range(n_t))
    r = 1 if n_t == 2 else 9999
    out = []
    for mod, term in ((ng, JCorrMarkerTerm), (ngt, ngt.CorrMarkerTerm)):
        out.append(mod.ModelSpec(
            y=y, fixed=[mod.FixedTerm("int", np.ones(N))],
            corr_markers=[term(names, tuple(mod.from_array(g) for g in gs),
                               mod.BayesPR(r, V_PRIORS[n_t]))],
            block_size=BLOCK))
    return tuple(out)


def _incidence(kind):
    """(z1, z2, the JAX and the port's inverse structure) of an (intercept,
    slope) group on one incidence: kind "I" a Q-level factor with the
    identity, "A" the records of N animals drawn among a 30-animal
    pedigree, with its A^-1 from each package's builder."""
    rng = np.random.default_rng(41)
    x = rng.normal(size=N)
    if kind == "I":
        lvl = rng.integers(0, Q, N)
        z = (lvl[:, None] == np.arange(Q)[None, :]).astype(float)
        return z, z * x[:, None], None, None
    labels = _pedigree_labels(q=30, founders=8, seed=42)
    ped_j, ped_t = jped.build_pedigree(*labels), tped.build_pedigree(*labels)
    animal = rng.integers(0, 30, N)
    z = (animal[:, None] == np.arange(30)[None, :]).astype(float)
    return z, z * x[:, None], jped.a_inverse(ped_j), tped.a_inverse(ped_t)


def _random_specs(kind):
    z1, z2, iv_j, iv_t = _incidence(kind)
    rng = np.random.default_rng(43)
    y = 1.0 + z1 @ rng.normal(0, 0.7, z1.shape[1]) + z2 @ rng.normal(0, 0.5, z1.shape[1]) \
        + rng.normal(0, 1, N)
    v = np.array([[0.5, 0.1], [0.1, 0.3]])
    st = "I" if kind == "I" else "A"
    return tuple(mod.ModelSpec(
        y=y, fixed=[mod.FixedTerm("int", np.ones(N))],
        random=[mod.RandomTerm(("a", "b"), (z1, z2), prior=mod.Random(st, v), ivstr=iv)],
        block_size=BLOCK) for mod, iv in ((ng, iv_j), (ngt, iv_t)))


CASES = [("corr", V, n_t) for V in (1, 2) for n_t in (2, 3)] + [("rand", 1, k) for k in ("I", "A")]


def _case_id(c):
    return f"markers-V{c[1]}-nT{c[2]}" if c[0] == "corr" else f"random-{c[2]}"


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def both(request):
    """Both packages' assembled (plan, state) and 4 JAX sweeps."""
    what, V, arg = request.param
    js, ts = _marker_specs(arg) if what == "corr" else _random_specs(arg)
    jplan, jstate0 = ng.assemble(js, use_pallas=False, pack2=True, vshards=V)
    tplan, tstate0 = ngt.assemble(ts, device="cpu", dtype=torch.float64, vshards=V)
    jsweep = jax.jit(ng.make_sweep(jplan))
    key = jax.random.key(CHAIN_KEY)
    jstates = [jstate0]
    for _ in range(4):
        jstates.append(jsweep(jstates[-1], key))
    return dict(what=what, jplan=jplan, tplan=tplan, tstate0=tstate0, jstates=jstates)


def _continuous(what):
    if what == "corr":
        return ("ycorr", "e.var_e", "fixed.0.b", "corr_markers.0.beta", "corr_markers.0.var_beta")
    return ("ycorr", "e.var_e", "fixed.0.b", "random.0.u", "random.0.var_u")


def _assert_chains_agree(tstate, jstate, what):
    tf, jf = _port_flat(tstate), _flatten(jstate)
    for key in _continuous(what):
        assert tf[key].shape == jf[key].shape, key
        np.testing.assert_allclose(tf[key], jf[key], rtol=1e-9, atol=1e-12, err_msg=key)
    assert int(tf["sweep_index"]) == int(jf["sweep_index"])


def test_assemble_matches(both):
    """The port's assembled state equals the JAX state laid out by
    state_from_numpy (the layouts the kernels read), field for field."""
    tplan, jplan = both["tplan"], both["jplan"]
    if both["what"] == "corr":
        cp, jcp = tplan.corr_markers[0], jplan.corr_markers[0]
        assert (cp.names, cp.n_t, cp.p, cp.p_pad, cp.block, cp.n_blocks, cp.n_regions, cp.df,
                cp.vshards) == (jcp.names, jcp.n_t, jcp.p, jcp.p_pad, jcp.block, jcp.n_blocks,
                                jcp.n_regions, jcp.df, jcp.vshards)
    else:
        rp, jrp = tplan.random[0], jplan.random[0]
        assert (rp.name, rp.q, rp.df, rp.correlated, rp.n_t) == (
            jrp.name, jrp.q, jrp.df, jrp.correlated, jrp.n_t)
    tf = _port_flat(both["tstate0"])
    jf = _port_flat(ngt.state_from_numpy(tplan, _flatten(both["jstates"][0])))
    assert set(tf) == set(jf)
    for key in tf:
        if tf[key].dtype.kind == "f":
            scale = max(1.0, float(np.abs(jf[key]).max()))
            np.testing.assert_allclose(tf[key], jf[key], rtol=1e-12, atol=1e-12 * scale, err_msg=key)
        else:
            np.testing.assert_array_equal(tf[key], jf[key], err_msg=key)


def test_four_sweeps_match(both):
    sweep = ngt.make_sweep(both["tplan"])
    stream = JaxStream(jax.random.key(CHAIN_KEY))
    st = both["tstate0"]
    for _ in range(4):
        st = sweep(st, stream)
    _assert_chains_agree(st, both["jstates"][4], both["what"])


def test_continue_from_jax_state(both):
    """2 JAX sweeps, then the port continues from the flattened JAX state."""
    st = ngt.state_from_numpy(both["tplan"], _flatten(both["jstates"][2]))
    assert st.sweep_index == 2
    sweep = ngt.make_sweep(both["tplan"])
    stream = JaxStream(jax.random.key(CHAIN_KEY))
    for _ in range(2):
        st = sweep(st, stream)
    _assert_chains_agree(st, both["jstates"][4], both["what"])


def test_run_lmem_keys_match():
    """run_lmem keeps beta<set>, var<sets> (n_regions, nT^2), u<a_b> and
    varU<a_b> with the JAX package's values and shapes."""
    for js, ts in (_marker_specs(2), _random_specs("I")):
        jres = ng.run_lmem(js, n_chain=4, n_burn=2, n_thin=1, out_folder=None, seed=5, vshards=1)
        tres = ngt.run_lmem(ts, n_chain=4, n_burn=2, n_thin=1, out_folder=None, seed=5, device="cpu",
                            stream=JaxStream(jax.random.key(5)))
        assert set(tres.draws) == set(jres.draws)
        for name in jres.draws:
            assert tres.draws[name].shape == jres.draws[name].shape, name
            np.testing.assert_allclose(tres.draws[name], jres.draws[name], rtol=1e-9, atol=1e-12,
                                       err_msg=name)
    assert {"betaM1", "betaM2", "varM1_M2"} <= set(ngt.run_lmem(
        _marker_specs(2)[1], 1, 0, 1, out_folder=None, device="cpu").draws)


# ------------------------------------------------------------------ draws


def _site(index=3):
    return Site(2, STAGE_MARKER, index)


def test_wishart_draws_match_jax():
    """sample_normal, sample_wishart and sample_inv_wishart take the JAX
    package's splits, so from the same keys they give its values."""
    stream = JaxStream(jax.random.key(CHAIN_KEY))
    site = _site()
    key = stream._key(site)
    S = np.array([[2.0, 0.3, 0.1], [0.3, 1.0, 0.2], [0.1, 0.2, 0.8]])
    chol = np.linalg.cholesky(S)
    mean = np.array([0.5, -1.0, 2.0])
    np.testing.assert_allclose(
        tdists.sample_normal(stream, site, torch.tensor(mean), 0.3).numpy(),
        np.asarray(jdists.sample_normal(key, jnp.asarray(mean), 0.3)), rtol=1e-12)
    np.testing.assert_allclose(
        tdists.sample_wishart(stream, site, 7.5, torch.tensor(chol)).numpy(),
        np.asarray(jdists.sample_wishart(key, 7.5, jnp.asarray(chol), 3)), rtol=1e-12)
    np.testing.assert_allclose(
        tdists.sample_inv_wishart(stream, site, 9.0, torch.tensor(S)).numpy(),
        np.asarray(jdists.sample_inv_wishart(key, 9.0, jnp.asarray(S))), rtol=1e-10)
    # the split-batched form: row r at site.split(R)[r], as the JAX marker stage draws regions
    R = 5
    dfs = 6.0 + np.arange(R)
    Ss = np.stack([S * (1 + 0.1 * r) for r in range(R)])
    keys = jax.random.split(key, R)
    ref = np.stack([np.asarray(jdists.sample_inv_wishart(keys[r], dfs[r], jnp.asarray(Ss[r])))
                    for r in range(R)])
    got = tdists.sample_inv_wishart_split(stream, site, torch.tensor(dfs), torch.tensor(Ss))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10)


def _streams():
    return {"jax": JaxStream(jax.random.key(CHAIN_KEY)),
            "philox": trng.PhiloxStream(3, "cpu", torch.float64),
            "host": trng.HostStream(3, "cpu", torch.float64),
            "keyed": trng.KeyedStream(3, "cpu", torch.float64)}


@pytest.mark.parametrize("name", ["jax", "philox", "host", "keyed"])
def test_split_draws_match_rows(name):
    """Row r of normal_split / gamma_split is the plain draw at
    site.split(n)[r] (then the splits `then`), for every stream."""
    stream = _streams()[name]
    site = _site(5)._replace(path=((2, 1),))
    n, then = 4, ((2, 0),)
    nrm = stream.normal_split(site, n, (3, 3), then=then)
    alpha = torch.tensor([[0.4, 1.5, 7.0], [2.0, 0.8, 30.0], [1.0, 1.0, 1.0], [5.0, 0.3, 12.5]],
                         dtype=torch.float64)
    gam = stream.gamma_split(site, n, alpha, then=((2, 1),))
    assert nrm.shape == (n, 3, 3) and gam.shape == alpha.shape
    for r in range(n):
        np.testing.assert_array_equal(
            nrm[r].numpy(), stream.normal(trng.split_site(site, n, r, then), (3, 3)).numpy())
        np.testing.assert_array_equal(
            gam[r].numpy(), stream.gamma(trng.split_site(site, n, r, ((2, 1),)), alpha[r]).numpy())
    plain = stream.normal(trng.split_site(site, n, 0), (2,))
    np.testing.assert_array_equal(stream.normal_split(site, n, (2,))[0].numpy(), plain.numpy())


@pytest.mark.parametrize("kind", [trng.UNIFORM, trng.NORMAL, trng.GAMMA])
def test_keyed_split_plain_matches_loop(kind):
    """keyed_draw_plain with rows = (count, slot) equals a loop of the
    single-site draw with tail[slot] = r, bit for bit (and each gamma's
    accepting attempt)."""
    h0 = trng._splitmix64(11)
    sweep = torch.tensor(7, dtype=torch.int64)
    tail, slot = trng.split_tail(Site(0, STAGE_MARKER, 2, ((2, 1),)), 6, ((2, 1),))
    n = 5
    alpha = torch.linspace(0.2, 40.0, 6 * n, dtype=torch.float64)
    a = alpha if kind == trng.GAMMA else None
    got, att = trng.keyed_draw_plain(kind, h0, sweep, tail, n, torch.float64, a, iters=True,
                                     rows=(6, slot))
    for r in range(6):
        t = list(tail)
        t[slot] = r
        ref, ref_att = trng.keyed_draw_plain(
            kind, h0, sweep, tuple(t), n, torch.float64,
            None if a is None else a[r * n:(r + 1) * n], iters=True)
        np.testing.assert_array_equal(got[r * n:(r + 1) * n].numpy(), ref.numpy())
        if kind == trng.GAMMA:
            np.testing.assert_array_equal(att[r * n:(r + 1) * n].numpy(), ref_att.numpy())


def test_inv_wishart_mean():
    """E[IW(df, S)] = S / (df - p - 1), as tests/test_dists.py holds the JAX
    draw: 4,000 rows of one split draw of the keyed stream."""
    stream = trng.KeyedStream(3, "cpu", torch.float64)
    S = torch.tensor([[2.0, 0.3], [0.3, 1.0]], dtype=torch.float64)
    R, df = 4000, 8.0
    draws = tdists.sample_inv_wishart_split(stream, _site(), torch.full((R,), df, dtype=torch.float64),
                                            S.expand(R, 2, 2))
    np.testing.assert_allclose(draws.mean(0).numpy(), S.numpy() / (df - 3.0), rtol=0.08, atol=0.02)


# ------------------------------------------------------------------ plain versions and stages


def test_re2_plain_matches_jax_loop():
    """corr_level_scan_plain against the JAX package's per-level body,
    transcribed, on a random structure (nT = 3, q = 9)."""
    rng = np.random.default_rng(44)
    n_t, q = 3, 9
    m = rng.normal(size=(q, q))
    A = m @ m.T / q + np.eye(q)
    yi, z, u0 = rng.normal(size=(n_t, q)), rng.normal(size=(q, n_t)), rng.normal(size=(n_t, q))
    x = rng.normal(size=(q, 4, n_t))
    zpz = np.einsum("lkt,lku->ltu", x, x)
    var_e, ivu = 1.3, np.linalg.inv(V_PRIORS[3] * 10)
    u = u0.copy()
    for i in range(q):  # random_effects.py:122-131
        u[:, i] = 0.0
        rhs = yi[:, i] / var_e - ivu @ (u @ A[i])
        cov = np.linalg.inv(zpz[i] / var_e + A[i, i] * ivu)
        cov = (cov + cov.T) / 2.0
        u[:, i] = cov @ rhs + np.linalg.cholesky(cov) @ z[i]
    got = random_scan.corr_level_scan(*(torch.tensor(np.asarray(a, np.float64))
                                        for a in (A, yi, zpz, z, u0, var_e, ivu)))
    np.testing.assert_allclose(got.numpy(), u, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("V", [1, 3])
def test_cm1_plain_matches_jax_loop(V):
    """corr_block_scan_v_plain (with corr_block_pack's rows) against the JAX
    package's per-locus body, transcribed, on V random chains (nT = 2,
    B = 12, the last two loci padded)."""
    rng = np.random.default_rng(45)
    n_t, B = 2, 12
    X = rng.normal(size=(V, B, n_t, 20))
    G = np.einsum("vjtn,vkwn->vjktw", X, X)  # (V, B, B, nT, nT), the JAX block layout
    mpm = np.einsum("vjjtw->vjtw", G)
    r0, bold, z = rng.normal(size=(V, B, n_t)), rng.normal(size=(V, B, n_t)), rng.normal(size=(V, B, n_t))
    ivb = np.linalg.inv(V_PRIORS[2] * 5)
    mask = np.arange(B) < B - 2
    ive = 0.7
    beta_ref = np.zeros((V, B, n_t))
    for v in range(V):  # markers.py:898-909
        u = np.zeros((B, n_t))
        for j in range(B):
            u[j] = bold[v, j]
            pre = r0[v, j] + np.einsum("buv,bv->u", G[v, j], u)
            cov = np.linalg.inv(mpm[v, j] * ive + ivb)
            cov = (cov + cov.T) / 2.0
            bnew = cov @ (pre * ive) + np.linalg.cholesky(cov) @ z[v, j]
            bnew = bnew if mask[j] else 0.0 * bnew
            beta_ref[v, j] = bnew
            u[j] = bold[v, j] - bnew
    def t(a):
        return torch.tensor(a, dtype=torch.float64) if np.ndim(a) == 0 else torch.tensor(a)

    pk = corr_scan.corr_block_pack(t(bold.reshape(-1, n_t)), t(z.reshape(-1, n_t)),
                                   t(ivb).expand(V * B, n_t, n_t), t(mpm.reshape(-1, n_t, n_t)),
                                   t(np.tile(mask, V)), t(ive)).view(V, B, -1).clone()
    pk[..., :n_t] += t(r0)
    gram = t(G).permute(1, 3, 0, 2, 4).contiguous()  # (B, nT, V, B, nT), the port's step layout
    beta, u = corr_scan.corr_block_scan_v_plain(gram, pk, n_t)
    np.testing.assert_allclose(beta.numpy(), beta_ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(u.numpy(), bold - beta_ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("V,n_t", [(1, 2), (3, 3)])
def test_cm1_step_plain_matches_composition(V, n_t):
    """The block-step's plain route (corr_block_step on CPU tensors) and the
    rule's (corr_rule) against the sampler's former composition, in float64
    bit for bit: the regions' inverses gathered and packed by
    corr_block_pack; then per step the step's rows cloned, r0 - cb * sum(y)
    added, the scan, beta_t copied into the (V, T, B, nT) buffer."""
    rng = np.random.default_rng(46 + V)
    T, B, R = 3, 12, 4
    p = V * T * B
    X = rng.normal(size=(T, V, B, n_t, 20))
    gram = torch.tensor(np.einsum("svjtn,svkwn->sjtvkw", X, X))  # (T, B, nT, V, B, nT)
    mpm = torch.tensor(np.einsum("svjtn,svjwn->vsjtw", X, X).reshape(p, n_t, n_t))
    bold, z = (torch.tensor(rng.normal(size=(p, n_t))) for _ in range(2))
    m = rng.normal(size=(R, n_t, n_t))
    var_beta = torch.tensor(m @ m.transpose(0, 2, 1) + np.eye(n_t))
    region = torch.tensor(np.r_[rng.integers(0, R, p - 2), [R, R]], dtype=torch.int32)
    mask = torch.arange(p) < p - 2
    var_e = torch.tensor(1.7, dtype=torch.float64)
    pk = corr_scan.corr_rule(bold, z, var_beta, region, mpm, mask, var_e)
    ivr = torch.linalg.inv_ex(var_beta, check_errors=False)[0]
    ivb = ivr[torch.clamp(region, 0, R - 1).long()]
    assert torch.equal(pk, corr_scan.corr_block_pack(bold, z, ivb, mpm, mask, 1.0 / var_e))
    pk_g = pk.view(V, T, B, -1)
    y = torch.tensor(rng.normal(size=50))
    beta, old = (torch.zeros((V, T, B, n_t), dtype=torch.float64) for _ in range(2))
    for t in range(T):
        r0, cb = (torch.tensor(rng.normal(size=(V, B, n_t))) for _ in range(2))
        u = corr_scan.corr_block_step((gram, t), pk_g, r0, cb, y.sum(), beta)
        pk_t = pk_g[:, t].clone()
        pk_t[..., :n_t] += r0 - cb * y.sum()
        beta_t, u_old = corr_scan.corr_block_scan_v_plain(gram[t], pk_t, n_t)
        old[:, t] = beta_t
        assert torch.equal(u, u_old)
    assert torch.equal(beta, old)


def test_single_stages_match():
    """One sample_random_corr and one sample_corr_marker_set call against
    the JAX stage on a JAX state after one sweep, from the same keys."""
    for what, (js, ts) in (("rand", _random_specs("A")), ("corr", _marker_specs(3))):
        jplan, jst = ng.assemble(js, use_pallas=False, pack2=True)
        jst = jax.jit(ng.make_sweep(jplan))(jst, jax.random.key(CHAIN_KEY))
        tplan, _ = ngt.assemble(ts, device="cpu", dtype=torch.float64)
        tst = ngt.state_from_numpy(tplan, _flatten(jst))
        stream = JaxStream(jax.random.key(CHAIN_KEY))
        var_e = 1.1
        if what == "rand":
            site = Site(1, STAGE_RANDOM, 0)
            ref = jre.sample_random_corr(stream._key(site), jst.random[0], jst.ycorr, var_e,
                                         jplan.random[0].df)
            got = tre.sample_random_corr(stream, site, tst.random[0], tst.ycorr,
                                         torch.tensor(var_e, dtype=torch.float64), tplan.random[0].df)
            for a, b in zip(got, ref):
                np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-12)
        else:
            site = Site(1, STAGE_MARKER, 0)
            jcs, jy = jmarkers.sample_corr_marker_set(stream._key(site), jst.corr_markers[0],
                                                      jplan.corr_markers[0], jst.ycorr, var_e)
            tcs, ty = tmarkers.sample_corr_marker_set(stream, site, tst.corr_markers[0],
                                                      tplan.corr_markers[0], tst.ycorr,
                                                      torch.tensor(var_e, dtype=torch.float64))
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(tcs.beta.numpy(), np.asarray(jcs.beta), rtol=1e-9, atol=1e-12)
            np.testing.assert_allclose(tcs.var_beta.numpy(), np.asarray(jcs.var_beta), rtol=1e-9)


def test_distinct_incidence_warns():
    """Components with different incidence patterns: both planners warn
    with the same words (the reference's tuple sampler is no valid Gibbs
    step then), and the port's text is the JAX package's."""
    z1, _, _, _ = _incidence("I")
    z2 = np.roll(z1, 1, axis=1)
    y = np.random.default_rng(46).normal(size=N)
    msgs = []
    for mod in (ng, ngt):
        spec = mod.ModelSpec(y=y, random=[mod.RandomTerm(("a", "b"), (z1, z2),
                                                         prior=mod.Random("I", np.eye(2)))])
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            if mod is ng:
                ng.assemble(spec, use_pallas=False)
            else:
                ngt.assemble(spec, device="cpu")
        msgs.append([str(w.message) for w in rec if "incidence patterns" in str(w.message)])
    assert len(msgs[0]) == 1 and msgs[0] == msgs[1]


def test_corr_refusals_match():
    """What stays refused, as in the JAX package: a prior other than BayesPR
    and pre-packed panels (ValueError). Dosages that cannot be packed are
    not refused: they are stored int8, as the JAX package stores them."""
    js, ts = _marker_specs(2)
    ct = ts.corr_markers[0]
    bad = ngt.ModelSpec(y=ts.y, corr_markers=[ngt.CorrMarkerTerm(ct.names, ct.datas,
                                                                 ngt.BayesC(0.9, 0.1))])
    with pytest.raises(ValueError, match="only the BayesPR prior"):
        ngt.assemble(bad, device="cpu")
    g = np.random.default_rng(47).integers(0, 3, (N, P)).astype(np.int8)
    packed = ngt.from_packed(*_packed(g))
    bad = ngt.ModelSpec(y=ts.y, corr_markers=[ngt.CorrMarkerTerm(ct.names, (packed, packed),
                                                                 ct.prior)])
    with pytest.raises(ValueError, match="pre-packed"):
        ngt.assemble(bad, device="cpu")
    wide = ngt.from_array(g + 2)  # dosages up to 4: not 2-bit packable
    ok = ngt.ModelSpec(y=ts.y, corr_markers=[ngt.CorrMarkerTerm(ct.names, (wide, wide), ct.prior)])
    plan, st = ngt.assemble(ok, device="cpu")
    assert st.corr_markers[0].mt.dtype == torch.int8 and plan.corr_markers[0].dosage_bytes == 1


def _packed(g):
    from nextgp_tpu_torch.ops import pack2

    return pack2.pack2_np(g), g.shape[0], g.mean(axis=0)
