"""The port's runtime (ROADMAP M10) against the JAX package, and its exact
resume, on the CPU in float64.

* `run_lmem`'s output files: an intercept, a 2-bit packed BayesC set
  (`from_packed`), a BayesPR set on a chromosome map (r = 99) and an "A"
  random term; both packages with their defaults (vshards "auto", which is
  1 in both on the CPU), the port drawing from `JaxStream`. Every
  `<q>Out` file of the JAX run is in the port's folder with the same
  header; values agree to 1e-9 relative (delta exactly); groupInfo's text
  is the same.
* Exact resume: a BayesR set, a CG "A" term on a small pedigree and a
  correlated marker set, with PhiloxStream and the plain KeyedStream, and
  n_burn % n_thin != 0: a run stopped after a checkpoint and resumed
  leaves the unbroken run's files byte for byte and its final state bit for
  bit. The checkpoint's guards (another model, other data, other shapes
  or dtypes, a counter that is not the sweep index) raise ValueError, and a
  checkpoint holds every leaf that one sweep of a model with every term
  kind changes.
* The writer (ports of the JAX package's two writer tests), `_headers`
  and `model_card` on a spec with every term kind, the summaries.
"""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu import runtime as j_runtime
from nextgp_tpu.api.spec import CorrMarkerTerm as JCorrMarkerTerm
from nextgp_tpu.data import pedigree as jped
from nextgp_tpu.io import summary as j_summary
from nextgp_tpu.ops import pack2 as j_pack2
from nextgp_tpu_torch import runtime as t_runtime
from nextgp_tpu_torch.data import pedigree as tped
from nextgp_tpu_torch.engine import sweep as t_sweep
from nextgp_tpu_torch.engine.state import chain_leaves
from nextgp_tpu_torch.io import checkpoint as t_ckpt
from nextgp_tpu_torch.io import summary as t_summary
from nextgp_tpu_torch.io import writer as t_writer
from test_torch_random import _pedigree_labels, _sparse_struct
from test_torch_sweep import JaxStream

N, P, BLOCK = 60, 32, 16
Q_PED = 80  # animals in the pedigree; the last N have records
SEED = 5


def _panel(seed, n=N, p=P):
    return np.random.default_rng(seed).integers(0, 3, (n, p)).astype(np.int8)


def _animal_z(mod, labels):
    ped = mod.build_pedigree(*labels)
    rows = ped.index_of([f"a{i}" for i in range(Q_PED - N, Q_PED)])
    z = np.zeros((N, Q_PED))
    z[np.arange(N), rows] = 1.0
    return ped, z


def _files_specs():
    """Both packages' specs: intercept, packed BayesC, mapped BayesPR, "A"."""
    g1, g2 = _panel(50), _panel(51)
    rng = np.random.default_rng(52)
    y = 1.0 + (g1 - g1.mean(0)) @ rng.normal(0, 0.2, P) + (g2 - g2.mean(0)) @ rng.normal(0, 0.1, P) \
        + rng.normal(0, 1, N)
    chr_ids = np.repeat([3, 7], P // 2)
    labels = _pedigree_labels(q=Q_PED, founders=20, seed=53)
    out = []
    for mod, mod_ped, pk in ((ng, jped, j_pack2), (ngt, tped, j_pack2)):
        ped, z = _animal_z(mod, labels)
        packed = mod.from_packed(pk.pack2_np(g1), N, g1.mean(0).astype(np.float64))
        out.append(mod.ModelSpec(
            y=y, fixed=[mod.FixedTerm("int", np.ones(N))],
            random=[mod.RandomTerm("ani", z, prior=mod.Random("A", 0.5), ivstr=mod_ped.a_inverse(ped))],
            markers=[mod.MarkerTerm("M1", packed, mod.BayesC(0.3, 0.05, estimatePi=True)),
                     mod.MarkerTerm("M2", mod.from_array(g2, chr_ids=chr_ids), mod.BayesPR(99, 0.05))],
            block_size=BLOCK))
    return tuple(out)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Both packages' run_lmem with output files, at their defaults."""
    root = tmp_path_factory.mktemp("files")
    js, ts = _files_specs()
    kw = dict(n_chain=9, n_burn=3, n_thin=2, seed=SEED)
    jres = ng.run_lmem(js, out_folder=str(root / "jax"), **kw)
    tres = ngt.run_lmem(ts, out_folder=str(root / "port"), device="cpu",
                        stream=JaxStream(jax.random.key(SEED)), **kw)
    return dict(jres=jres, tres=tres, jdir=root / "jax", tdir=root / "port")


def _read(path):
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = np.array([[float(v) for v in line.split("\t")] for line in fh.read().splitlines()])
    return header, rows


def test_run_lmem_files_match(files):
    jdir, tdir = files["jdir"], files["tdir"]
    jouts = sorted(f for f in os.listdir(jdir) if f.endswith("Out"))
    assert jouts and jouts == sorted(f for f in os.listdir(tdir) if f.endswith("Out"))
    for fn in jouts:
        jh, jrows = _read(jdir / fn)
        th, trows = _read(tdir / fn)
        assert th == jh, fn
        assert trows.shape == jrows.shape == (3, len(jh)), fn
        if fn.startswith(("delta", "annot")):
            np.testing.assert_array_equal(trows, jrows, err_msg=fn)
        else:
            np.testing.assert_allclose(trows, jrows, rtol=1e-9, atol=1e-12, err_msg=fn)
    assert (tdir / "groupInfo_M2.txt").read_text() == (jdir / "groupInfo_M2.txt").read_text()
    assert not (tdir / "groupInfo_M1.txt").exists()  # written for mapped BayesPR sets only
    assert files["tres"].out_folder == str(tdir)


def test_auto_vshards_is_one(files):
    """vshards="auto" (both run_lmem defaults): V = 1 on the CPU in both
    packages, and the chains agree (their draws, as the files do)."""
    jplan, tplan = files["jres"].plan, files["tres"].plan
    assert [mp.vshards for mp in tplan.markers] == [mp.vshards for mp in jplan.markers] == [1, 1]
    for name, d in files["jres"].draws.items():
        np.testing.assert_allclose(files["tres"].draws[name], d, rtol=1e-9, atol=1e-12, err_msg=name)


def test_summaries_match(files):
    """read_samples and summary_mcmc on the JAX run's files, posterior_stats,
    split_rhat and ess_bulk on the same arrays: the same numbers."""
    jdir = str(files["jdir"])
    for name in ("varE", "betaM1", "deltaM1", "uani"):
        np.testing.assert_array_equal(t_summary.read_samples(name, jdir),
                                      j_summary.read_samples(name, jdir))
        np.testing.assert_array_equal(ngt.summary_mcmc(name, jdir), ng.summary_mcmc(name, jdir))
    chains = np.random.default_rng(54).normal(size=(3, 40, 5)).cumsum(axis=1)
    for fn in ("split_rhat", "ess_bulk"):
        np.testing.assert_array_equal(getattr(ngt, fn)(chains), getattr(ng, fn)(chains))
    np.testing.assert_array_equal(ngt.split_rhat(chains[:, :3]), ng.split_rhat(chains[:, :3]))
    np.testing.assert_array_equal(ngt.ess_bulk(chains[:, :1]), ng.ess_bulk(chains[:, :1]))
    for key, v in ng.posterior_stats(chains[0]).items():
        np.testing.assert_array_equal(ngt.posterior_stats(chains[0])[key], v)


# ---------------------------------------------------------------- exact resume


def _resume_spec(g_seed=60, prior="BayesR", p=P):
    """The port's spec: a BayesR set, a CG "A" term and two correlated sets."""
    g, c1, c2 = _panel(g_seed, p=p), _panel(g_seed + 1), _panel(g_seed + 2)
    rng = np.random.default_rng(63)
    y = 1.0 + (g - g.mean(0)) @ rng.normal(0, 0.2, p) + rng.normal(0, 1, N)
    ped, z = _animal_z(ngt, _pedigree_labels(q=Q_PED, founders=20, seed=53))
    marker_prior = (ngt.BayesR([0.85, 0.08, 0.05, 0.02], [0.0, 1e-3, 1e-2, 1e-1], 1.0, estimatePi=True)
                    if prior == "BayesR" else ngt.BayesC(0.3, 0.05))
    return ngt.ModelSpec(
        y=y, fixed=[ngt.FixedTerm("int", np.ones(N))],
        random=[ngt.RandomTerm("ani", z, prior=ngt.Random("A", 0.5, sampler="cg"),
                               sparse_struct=_sparse_struct(tped, ped))],
        markers=[ngt.MarkerTerm("M", ngt.from_array(g), marker_prior)],
        corr_markers=[ngt.CorrMarkerTerm(("C1", "C2"), (ngt.from_array(c1), ngt.from_array(c2)),
                                         ngt.BayesPR(1, np.array([[0.02, 0.005], [0.005, 0.015]])))],
        block_size=BLOCK)


RESUME = dict(n_chain=13, n_burn=3, n_thin=2)  # 5 kept; 3 % 2 burn-in sweeps left over


def _stream(kind):
    return None if kind == "philox" else ngt.KeyedStream(SEED, "cpu", torch.float64)


def _outs(folder):
    return {f: (folder / f).read_bytes() for f in sorted(os.listdir(folder)) if f.endswith("Out")}


@pytest.mark.parametrize("kind", ["philox", "keyed"])
def test_run_lmem_resume_exact(tmp_path, kind):
    spec = _resume_spec()
    full = ngt.run_lmem(spec, out_folder=str(tmp_path / "a"), seed=SEED, device="cpu",
                        stream=_stream(kind), **RESUME)
    # stopped after 3 kept samples (a checkpoint at 2), then resumed to 5
    out_b = tmp_path / "b"
    ngt.run_lmem(spec, out_folder=str(out_b), seed=SEED, device="cpu", stream=_stream(kind),
                 checkpoint_every=2, **{**RESUME, "n_chain": 9})
    assert t_ckpt.read_meta(str(out_b / "chain.ckpt"))["kept_rows"] == 2
    resumed = ngt.run_lmem(spec, out_folder=str(out_b), seed=SEED, device="cpu",
                           stream=_stream(kind), checkpoint_every=2, resume=True, **RESUME)
    assert _outs(tmp_path / "a") == _outs(out_b)
    assert len(_outs(out_b)) == 11  # varE b uani varUani betaM deltaM varM piM betaC1 betaC2 varC1_C2
    a, b = t_sweep._leaves(full.state), t_sweep._leaves(resumed.state)
    assert a.keys() == b.keys()
    for key in a:
        assert torch.equal(a[key], b[key]), key
    assert full.state.sweep_index == resumed.state.sweep_index == 13
    for name, d in resumed.draws.items():
        np.testing.assert_array_equal(d, full.draws[name][2:], err_msg=name)


def test_checkpoint_guards(tmp_path):
    spec = _resume_spec()
    out = tmp_path / "c"
    ngt.run_lmem(spec, out_folder=str(out), seed=SEED, device="cpu", checkpoint_every=1,
                 **{**RESUME, "n_chain": 5})
    ckpt = str(out / "chain.ckpt")
    with pytest.raises(ValueError, match="different model"):  # another method: another plan
        ngt.run_lmem(_resume_spec(prior="BayesC"), out_folder=str(out), device="cpu",
                     checkpoint_every=1, resume=True, **RESUME)
    with pytest.raises(ValueError, match="different data"):  # the same shapes, another panel
        ngt.run_lmem(_resume_spec(g_seed=70), out_folder=str(out), device="cpu",
                     checkpoint_every=1, resume=True, **RESUME)
    _, st = ngt.prep(_resume_spec(p=48), device="cpu")  # other shapes of the same leaves
    with pytest.raises(ValueError, match="shape"):
        t_ckpt.load_checkpoint(ckpt, st)
    _, st = ngt.prep(spec, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        t_ckpt.load_checkpoint(ckpt, st)
    plan, st = ngt.prep(spec, device="cpu")
    t_ckpt.save_checkpoint(ckpt, dataclasses.replace(st, sweep_index=4))  # counter still 0
    with pytest.raises(ValueError, match="sweep_counter"):
        t_ckpt.load_checkpoint(ckpt, st)
    t_ckpt.save_checkpoint(ckpt, dataclasses.replace(st, sweep_index=4,
                                                     sweep_counter=torch.tensor(4)))
    assert t_ckpt.load_checkpoint(ckpt, st, t_ckpt.plan_fingerprint(plan)).sweep_index == 4


def _every_kind_specs():
    """Both packages' specs with every term kind: a weighted residual, a
    single and a blocked fixed term with summary statistics, random terms
    by scan (with levels), by CG and as a correlated group, marker sets of
    BayesB, BayesR, BayesRCpi, BayesLV and a mapped BayesPR without a prior,
    and two correlated marker sets."""
    rng = np.random.default_rng(80)
    gs = [_panel(81 + i) for i in range(7)]
    y = 1.0 + rng.normal(0, 1, N)
    x = rng.normal(0, 1, (N, 2))
    lvl = rng.integers(0, 5, N)
    zg = (lvl[:, None] == np.arange(5)).astype(float)
    zx = zg * rng.normal(size=N)[:, None]
    annot = rng.integers(0, 2, (P, 3)) | np.array([1, 0, 0])
    cov = rng.normal(0, 1, (P, 2))
    chr_ids = np.repeat([1, 2], P // 2)
    labels = _pedigree_labels(q=Q_PED, founders=20, seed=53)
    weights = rng.uniform(0.5, 2.0, N)
    out = []
    for mod, mod_ped, corr_term in ((ng, jped, JCorrMarkerTerm), (ngt, tped, ngt.CorrMarkerTerm)):
        ped, z = _animal_z(mod, labels)
        out.append(mod.ModelSpec(
            y=y, fixed=[mod.FixedTerm("int", np.ones(N)), mod.FixedTerm("x1", x[:, 0]),
                        mod.FixedTerm("x2", x[:, 1], levels=["slope"])],
            blocks=[("x1", "x2")],
            random=[mod.RandomTerm("grp", zg, prior=mod.Random("I", 0.3),
                                   levels=[f"g{i}" for i in range(5)]),
                    mod.RandomTerm("ani", z, prior=mod.Random("A", 0.5, sampler="cg"),
                                   sparse_struct=_sparse_struct(mod_ped, ped), structure_label="A"),
                    mod.RandomTerm(("ia", "sl"), (zg, zx),
                                   prior=mod.Random("I", np.array([[0.5, 0.1], [0.1, 0.3]])))],
            markers=[mod.MarkerTerm("MB", mod.from_array(gs[0]), mod.BayesB(0.3, 0.05)),
                     mod.MarkerTerm("MR", mod.from_array(gs[1]),
                                    mod.BayesR([0.85, 0.1, 0.05], [0.0, 1e-3, 1e-2], 1.0,
                                               estimatePi=True)),
                     mod.MarkerTerm("MA", mod.from_array(gs[2]),
                                    mod.BayesRCpi([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, annot)),
                     mod.MarkerTerm("ML", mod.from_array(gs[3]), mod.BayesLV(0.01, cov, 0.01)),
                     mod.MarkerTerm("MP", mod.from_array(gs[4], chr_ids=chr_ids), None)],
            corr_markers=[corr_term(("C1", "C2"), (mod.from_array(gs[5]), mod.from_array(gs[6])),
                                    mod.BayesPR(9999, np.array([[0.02, 0.005], [0.005, 0.015]])))],
            residual=mod.RandomEffect(weights, 1.0),
            summary_stats={"int": mod.SummaryStatistics(np.array([0.8]), np.array([0.25]))},
            block_size=BLOCK))
    return tuple(out)


@pytest.fixture(scope="module")
def every_kind():
    js, ts = _every_kind_specs()
    jplan, jstate = ng.assemble(js, use_pallas=False, pack2=True)
    tplan, tstate = ngt.prep(ts, device="cpu")
    return dict(js=js, ts=ts, jplan=jplan, jstate=jstate, tplan=tplan, tstate=tstate)


def test_checkpoint_holds_what_a_sweep_changes(every_kind):
    """One sweep of a model with every term kind: every leaf whose tensor it
    replaced, and every leaf whose values it changed, is among the leaves a
    checkpoint holds (chain_leaves); the others are the constants it
    digests."""
    plan, st = every_kind["tplan"], every_kind["tstate"]
    after = ngt.make_sweep(plan)(st, ngt.PhiloxStream(SEED, "cpu", torch.float64))
    before, new = t_sweep._leaves(st), t_sweep._leaves(after)
    saved = set(chain_leaves(st))
    replaced = {k for k in before if new[k] is not before[k]}
    changed = {k for k in before if not torch.equal(new[k], before[k])}
    assert changed <= replaced <= saved, (changed - saved, replaced - saved)
    assert {"random.1.u.", "corr_markers.0.beta.", "markers.3.lv_c.", "sweep_counter."} <= changed
    assert t_ckpt.constants_digest(after) == t_ckpt.constants_digest(st)


def test_headers_and_model_card_match(every_kind):
    js, ts = every_kind["js"], every_kind["ts"]
    jplan, tplan = every_kind["jplan"], every_kind["tplan"]
    assert t_runtime._headers(ts, tplan) == j_runtime._headers(js, jplan)
    for state in (None, "state"):
        tcard = ngt.model_card(ts, tplan, state and every_kind["tstate"])
        jcard = ng.model_card(js, jplan, state and every_kind["jstate"])
        assert tcard.splitlines() == jcard.splitlines()
    assert "2-bit packed" in tcard and "sampler cg" in tcard


def test_run_lmem_progress_prints_the_card(capsys):
    spec = _resume_spec()
    ngt.run_lmem(spec, 5, 1, 2, out_folder=None, device="cpu", progress=True)
    printed = capsys.readouterr().out
    plan, state = ngt.prep(spec, device="cpu")
    assert printed.startswith(ngt.model_card(spec, plan, state)) and "kept 2/2" in printed


# ---------------------------------------------------------------- the writer


def test_writer_failed_block_not_retried(tmp_path):
    """A failed block write must neither re-append already-written rows on
    the next attempt (double-weighted draws) nor drop sibling quantities of
    the same sample; the error surfaces at close()."""
    w = t_writer.MCMCWriter(str(tmp_path), headers={"a": ["a1"], "b": ["b1"]}, block_rows=2)
    orig = w._write_block
    fails = {"n": 0}

    def flaky(name, rows):
        if name == "a" and fails["n"] == 0:
            fails["n"] += 1
            raise OSError("disk full")
        return orig(name, rows)

    w._write_block = flaky
    for i in range(6):
        w.put({"a": np.array([float(i)]), "b": np.array([10.0 + i])})
    with pytest.raises(OSError):
        w.close()
    b = np.loadtxt(tmp_path / "bOut", skiprows=1)
    np.testing.assert_allclose(b, 10.0 + np.arange(6.0))
    a = np.atleast_1d(np.loadtxt(tmp_path / "aOut", skiprows=1))
    assert a.tolist() == [2.0, 3.0, 4.0, 5.0]


def test_writer_flush_after_close_is_noop(tmp_path):
    w = t_writer.MCMCWriter(str(tmp_path), headers={"a": ["a1"]})
    w.put({"a": np.array([1.0])})
    w.close()
    w.flush()
    w.close()
    assert (tmp_path / "aOut").read_text() == "a1\n1.0\n"


def test_writer_refuses_tensors(tmp_path):
    """Rows reach the writer as host arrays: the caller copies a chunk off
    the card once, not a sample at a time."""
    w = t_writer.MCMCWriter(str(tmp_path))
    with pytest.raises(TypeError, match="host"):
        w.put({"a": torch.ones(2)})
    w.close()
