"""Unpacked marker storage (int8 and float rows) against the JAX package, in
float64 on the CPU.

Both packages assemble one spec with two marker sets of one method stored
unpacked: int8 dosages under pack2=False ("M8"), and an imputed panel (5 %
of its entries fractional dosages in [0, 2]) through `from_float_array`
("Mf"), which no 2-bit pack can hold. BayesPR, BayesB, BayesC and
BayesC with a weighted residual ("BayesC+D") here, BayesR and BayesLV in
test_torch_storage_rlv.py, the annotation methods in
test_torch_storage_annot.py and MultiBreed in
test_torch_storage_multibreed.py (four files, so that the JAX compiles of
their models run on four workers), run 3 sweeps at V = 1 and V = 4 from
the JAX package's keys (`JaxStream`): continuous fields agree at rtol
1e-9, delta and the annotation categories exactly. The port's gather and
scatter on such rows
are a cast and a matrix product, as in the JAX package; the scans are the
same as on packed storage.

Then the storage rule (`pack2=`): which panels are packed, int8 or float,
and the JAX package's refusals word for word; `genomic_values_state` on
unpacked storage against the JAX function at 1e-9; and the roofline's
bytes for each storage.
"""
import jax
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu import diag as j_diag
from nextgp_tpu.api.spec import CorrMarkerTerm as JCorrMarkerTerm
from nextgp_tpu_torch import diag as t_diag
from test_torch_random import _port_flat
from test_torch_sweep import JaxStream, RC_CLASSES, RC_PI, _flatten

N, P, BLOCK = 100, 128, 16
CHAIN_KEY = 17
SETS = (("M8", "int8"), ("Mf", "float"))


def _panel(kind, seed=30):
    """(N, P) dosages: integers 0..2; for "float" 5 % of the entries are
    fractional dosages in [0, 2]; for "wide" every seventh locus is raised
    by 2 (dosages up to 4: int8, but not 2-bit packable)."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, (N, P)).astype(np.float64)
    if kind == "float":
        hit = rng.random(g.shape) < 0.05
        g[hit] = rng.uniform(0.0, 2.0, int(hit.sum()))
    if kind == "wide":
        g += 2 * (np.arange(P) % 7 == 0)
    return g


def _data(mod, kind, seed=30, chr_ids=None):
    g = _panel(kind, seed)
    return mod.from_float_array(g, chr_ids=chr_ids) if kind == "float" else \
        mod.from_array(g, chr_ids=chr_ids)


def _prior(mod, method):
    if method == "BayesPR":
        return mod.BayesPR(20, 0.05)
    if method in ("BayesB", "BayesC", "BayesC+D"):
        return getattr(mod, method[:6])(0.3, 0.05, estimatePi=True)
    if method in ("BayesRCpi", "BayesRCplus"):
        annot = np.random.default_rng(32).integers(0, 2, (P, 3)) | np.array([1, 0, 0])
        return getattr(mod, method)(RC_PI, RC_CLASSES, 1.0, annot, estimatePi=True)
    if method == "BayesLV":
        cov = np.random.default_rng(33).normal(0, 1, (P, 3))
        return mod.BayesLV(0.01, cov, 0.01, estimateVarZeta=True)
    return mod.BayesR([0.85, 0.08, 0.05, 0.02], [0.0, 1e-3, 1e-2, 1e-1], 1.0, estimatePi=True)


def _specs(method):
    """Both packages' specs for one method: an intercept and an int8 and a
    float marker set (two correlated pairs for MultiBreed)."""
    rng = np.random.default_rng(31)
    g8, gf = _panel("int8", 38), _panel("float", 39)
    y = 1.0 + rng.normal(0, 1, N)
    for g in (g8, gf):
        hit = rng.choice(P, 5, replace=False)
        y += (g[:, hit] - g[:, hit].mean(0)) @ rng.normal(0, 0.4, 5)
    chr_ids = (np.arange(P) // 48) % 2 + 1  # chromosomes 1 and 2, interleaved
    weights = np.random.default_rng(34).uniform(0.5, 2.0, N) if method.endswith("+D") else None
    v = np.array([[0.02, 0.005], [0.005, 0.015]])
    out = []
    for mod, corr_term in ((ng, JCorrMarkerTerm), (ngt, ngt.CorrMarkerTerm)):
        markers, corr = [], []
        if method == "MultiBreed":
            corr = [corr_term((f"{k}a", f"{k}b"), tuple(_data(mod, k, seed=s) for s in seeds),
                              mod.BayesPR(9999, v))
                    for k, seeds in (("wide", (35, 36)), ("float", (37, 38)))]
        else:
            markers = [mod.MarkerTerm(name, _data(mod, kind, 38 if kind == "int8" else 39, chr_ids),
                                      _prior(mod, method)) for name, kind in SETS]
        out.append(mod.ModelSpec(
            y=y, fixed=[mod.FixedTerm("int", np.ones(N))], markers=markers, corr_markers=corr,
            residual=None if weights is None else mod.RandomEffect(weights, 1.0),
            block_size=BLOCK))
    return tuple(out)


CASES = [(m, V) for m in ("BayesPR", "BayesB", "BayesC", "BayesC+D") for V in (1, 4)]


def case_id(case):
    return f"{case[0]}-V{case[1]}"


def build_both(method, V):
    """Both packages' unpacked (plan, state) and 3 JAX sweeps."""
    js, ts = _specs(method)
    jplan, jstate0 = ng.assemble(js, use_pallas=False, vshards=V, pack2=False)
    tplan, tstate0 = ngt.assemble(ts, dtype=torch.float64, vshards=V, pack2=False, device="cpu")
    jsweep = jax.jit(ng.make_sweep(jplan))
    key = jax.random.key(CHAIN_KEY)
    jstates = [jstate0]
    for _ in range(3):
        jstates.append(jsweep(jstates[-1], key))
    return dict(method=method, V=V, jplan=jplan, tplan=tplan, tstate0=tstate0, jstates=jstates)


@pytest.fixture(scope="module", params=CASES, ids=case_id)
def both(request):
    return build_both(*request.param)


def _sets(plan, state):
    """(prefix, plan entry, state entry, storage kind) of every marker set."""
    out = [(f"markers.{i}.", mp, ms, SETS[i][1])
           for i, (mp, ms) in enumerate(zip(plan.markers, state.markers))]
    return out + [(f"corr_markers.{i}.", cp, cs, ("int8", "float")[i])
                  for i, (cp, cs) in enumerate(zip(plan.corr_markers, state.corr_markers))]


def check_layout(both):
    """int8 panels stay int8 and float panels take the engine dtype, in the
    (T, V, B, n) layout: the JAX package's rows, block for block, with the
    Grams, centres and mpm at 1e-12."""
    tplan = both["tplan"]
    laid = ngt.state_from_numpy(tplan, _flatten(both["jstates"][0]))
    for (prefix, plan, ms, kind), (_, _, jms, _) in zip(_sets(tplan, both["tstate0"]),
                                                        _sets(tplan, laid)):
        want = torch.int8 if kind == "int8" else torch.float64
        assert ms.mt.dtype == want and ms.mt.shape[-1] == N, prefix
        assert plan.dosage_bytes == (1 if kind == "int8" else 8), prefix
        assert not getattr(plan, "packed", False)
        assert jms.mt.dtype == ms.mt.dtype and torch.equal(jms.mt, ms.mt), prefix
        for name in ("center", "gram", "mpm"):
            ref = getattr(jms, name)
            np.testing.assert_allclose(getattr(ms, name).numpy(), ref.numpy(), rtol=1e-12,
                                       atol=1e-12 * max(1.0, ref.abs().max().item()),
                                       err_msg=prefix + name)


def _assert_chains_agree(tstate, jstate, plan):
    tf, jf = _port_flat(tstate), _flatten(jstate)
    keys, exact = ["ycorr", "e.var_e", "fixed.0.b"], []
    for i, mp in enumerate(plan.markers):
        keys += [f"markers.{i}.beta", f"markers.{i}.var_beta"]
        exact += [f"markers.{i}.delta"]
        if mp.n_classes:
            keys += [f"markers.{i}.pi_hat", f"markers.{i}.log_pi"]
        if mp.n_annot:
            keys += [f"markers.{i}.annot_prob"]
            exact += [f"markers.{i}.annot_cat"]
        if mp.n_lv_cov:
            keys += [f"markers.{i}.{f}" for f in ("log_var", "lv_c", "lv_resid", "var_zeta")]
    for i, _ in enumerate(plan.corr_markers):
        keys += [f"corr_markers.{i}.beta", f"corr_markers.{i}.var_beta"]
    for key in keys:
        assert tf[key].shape == jf[key].shape, key
        np.testing.assert_allclose(tf[key], jf[key], rtol=1e-9, atol=1e-12, err_msg=key)
    for key in exact:
        np.testing.assert_array_equal(tf[key], jf[key], err_msg=key)
    assert int(tf["sweep_index"]) == int(jf["sweep_index"])


def check_three_sweeps(both):
    sweep = ngt.make_sweep(both["tplan"])
    stream = JaxStream(jax.random.key(CHAIN_KEY))
    st = both["tstate0"]
    for _ in range(3):
        st = sweep(st, stream)
    _assert_chains_agree(st, both["jstates"][3], both["tplan"])


def check_genomic_values(both, marker):
    """On int8 and float storage the port serves Mc @ beta as one product in
    the state's dtype, as the JAX package does: float64 here, so 1e-9."""
    jstate = both["jstates"][3]
    ref = np.asarray(ng.genomic_values_state(both["jplan"], jstate, marker=marker))
    st = ngt.state_from_numpy(both["tplan"], _flatten(jstate))
    out = ngt.genomic_values_state(both["tplan"], st, marker=marker)
    assert out.dtype == torch.float64
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-9, atol=1e-9 * np.abs(ref).max())
    beta = np.random.default_rng(37).normal(0, 0.1, P)
    np.testing.assert_allclose(
        ngt.genomic_values_state(both["tplan"], st, marker=marker, beta=beta).numpy(),
        np.asarray(ng.genomic_values_state(both["jplan"], jstate, marker=marker, beta=beta)),
        rtol=1e-9, atol=1e-9)


def test_unpacked_storage_is_laid_out_as_the_jax_rows(both):
    check_layout(both)


def test_three_sweeps_match(both):
    check_three_sweeps(both)


@pytest.mark.parametrize("marker", [0, 1], ids=["int8", "float"])
def test_genomic_values_state_matches(both, marker):
    check_genomic_values(both, marker)


def _one_set(mod, md):
    return mod.ModelSpec(y=np.zeros(md.n_ind), markers=[mod.MarkerTerm("M", md, mod.BayesC(0.9, 0.05))],
                         block_size=BLOCK)


@pytest.mark.parametrize("kind,pack,want", [
    ("int8", None, "packed"), ("int8", True, "packed"), ("int8", False, "int8"),
    ("float", None, "float"), ("float", False, "float"), ("wide", None, "int8"),
    ("wide", False, "int8")])
def test_storage_rule(kind, pack, want):
    """The table of the JAX planner's rule: 0..3 int8 dosages are packed
    unless pack2=False; other int8 panels stay int8, float panels take the
    engine dtype; the JAX package reaches the same storage (under pack2=None
    it packs only on its TPU path, so its None is compared as True)."""
    g = _panel(kind)
    mk = {"float": lambda m: m.from_float_array(g)}.get(kind, lambda m: m.from_array(g))
    plan, st = ngt.assemble(_one_set(ngt, mk(ngt)), pack2=pack, device="cpu")
    mt = st.markers[0].mt
    got = "packed" if mt.dtype == torch.uint8 else "int8" if mt.dtype == torch.int8 else "float"
    assert got == want and plan.markers[0].packed == (want == "packed")
    assert plan.markers[0].dosage_bytes == {"packed": 0.25, "int8": 1, "float": 8}[want]
    _, jst = ng.assemble(_one_set(ng, mk(ng)), use_pallas=False,
                         pack2=(kind == "int8") if pack is None else pack)
    assert np.asarray(jst.markers[0].mt).dtype == {"packed": np.uint8, "int8": np.int8,
                                                   "float": np.float64}[want]


def test_float_storage_takes_the_engine_dtype():
    """A float panel assembled in float32 is stored in float32."""
    _, st = ngt.assemble(_one_set(ngt, ngt.from_float_array(_panel("float"))), device="cpu",
                         dtype=torch.float32)
    assert st.markers[0].mt.dtype == torch.float32


def _refusal(mod, kind, pack):
    g = _panel("float" if kind == "float" else "int8")
    if kind == "packed":
        from nextgp_tpu_torch.ops import pack2

        md = mod.from_packed(pack2.pack2_np(g.astype(np.int8)), N, g.mean(axis=0))
    else:
        md = mod.from_float_array(g)
    with pytest.raises(ValueError) as err:
        if mod is ng:
            ng.assemble(_one_set(ng, md), use_pallas=False, pack2=pack)
        else:
            ngt.assemble(_one_set(ngt, md), pack2=pack, device="cpu")
    return str(err.value)


@pytest.mark.parametrize("kind,pack", [("float", True), ("packed", False)],
                         ids=["pack2-on-fractional", "unpacked-on-from_packed"])
def test_refusals_match(kind, pack):
    """pack2=True on fractional dosages and pack2=False on rows that arrived
    packed raise the JAX package's ValueError, word for word."""
    msg = _refusal(ngt, kind, pack)
    assert msg == _refusal(ng, kind, pack)
    assert ("cannot be packed" if kind == "float" else "would need the unpacked panel") in msg


def test_device_tensor_is_laid_out_on_its_device():
    """A tensor panel (from_device_array) is packed where eligible and
    otherwise kept int8 or cast, without a trip through numpy."""
    g = torch.from_numpy(_panel("int8").astype(np.int8))
    for pack, want in ((None, torch.uint8), (False, torch.int8)):
        plan, st = ngt.assemble(_one_set(ngt, ngt.from_device_array(g)), pack2=pack, device="cpu")
        assert st.markers[0].mt.dtype == want
        _, ref = ngt.assemble(_one_set(ngt, ngt.from_array(g.numpy())), pack2=pack, device="cpu")
        assert torch.equal(st.markers[0].mt, ref.markers[0].mt)
        np.testing.assert_allclose(st.markers[0].gram.numpy(), ref.markers[0].gram.numpy(),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("kind", ["packed", "int8", "float"])
def test_roofline_counts_the_stored_bytes(kind):
    """The roofline reads each pass over the panel at the bytes the plan
    stores a dosage in: the JAX package's figures for packed and int8
    storage, and for a float panel its figure with 8 bytes a dosage in
    place of the 1 it counts."""
    g = _panel("float" if kind == "float" else "int8")
    mk = (lambda m: m.from_float_array(g)) if kind == "float" else (lambda m: m.from_array(g))
    pack = kind == "packed"
    tplan, _ = ngt.assemble(_one_set(ngt, mk(ngt)), pack2=pack, device="cpu")
    jplan, _ = ng.assemble(_one_set(ng, mk(ng)), use_pallas=False, pack2=pack)
    out, ref = t_diag.roofline(tplan, device="cpu"), j_diag.roofline(jplan, device="cpu")
    extra = 2 * tplan.markers[0].p_pad * N * (7 if kind == "float" else 0)
    assert out.bytes_per_sweep == ref.bytes_per_sweep + extra
    assert out.flops_per_sweep == ref.flops_per_sweep
