"""The port's GRN sampler (ROADMAP M13) against the JAX package, on the CPU
in float64.

Data: test_grn.py's `_simulate` (G = 4 genes, S = 12 SNPs, N = 200
individuals). The port runs on the CPU through its plain versions (GRN1's
is `grn_scan_plain`, the JAX scan's loop) and draws from `JaxStream`, which
reproduces the JAX package's keys, so both chains see the same numbers.

* `_pairs` and `_lam1_matrix` equal the JAX ones.
* `grn_scan_plain` equals the closed form, one triangular solve with G
  right-hand sides (`grn_scan_system`), at 1e-10.
* `make_grn_step` follows the JAX step for 25 iterations from one state
  (`grn_state_from_numpy` of the JAX initial state), from the zero start
  and from start_lam1 = 0.1: every field within rtol 1e-9 after every
  iteration (the two evaluate the same algebra with other summation orders
  and another LU), and the same accept count, with accepts and rejects both.
* A negative det(I - Lambda1): G = 2 from start_lam1 = [2, 2] (det = -3).
  The JAX log-target takes log|det| (slogdet without its sign), where the
  reference's oracle rejects; the port follows the JAX package, decision for
  decision.
* `est_grn(device="cpu", stream=JaxStream(...))` equals the JAX `est_grn`:
  the accept count, every draw at 1e-9, the same `*Out` files (header, row
  count, values); `out_folder=None` writes nothing.
* The port's `est_grn` with its default stream (PhiloxStream) recovers the
  planted structure with test_grn.py's thresholds.
* `diag.grn_work` counts a GRN1 call's bytes, operations and steps.
* `grn_layout` (GRN1's packed triangle, made once a chain) holds exactly
  tril(gram)'s entries where GRN1 reads them, zeros elsewhere, and the
  diagonal's reciprocals and their square roots; `grn_scan` on CPU tensors
  with a layout still runs the plain version.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgp_tpu.grn import sampler as jgrn
from nextgp_tpu_torch.grn import sampler as tgrn
from nextgp_tpu_torch.ops import grn_scan as tscan
from test_grn import _simulate
from test_torch_sweep import JaxStream

FIELDS = ("mu", "lam1", "lam2", "var_lam1", "var_beta", "var_e", "ycorr")


@pytest.mark.parametrize("G", [2, 3, 5])
def test_pairs_and_lam1_matrix_match(G):
    assert tgrn._pairs(G) == jgrn._pairs(G)
    lam = np.arange(1.0, G * G - G + 1.0)
    ref = np.asarray(jgrn._lam1_matrix(jnp.asarray(lam), G))
    np.testing.assert_array_equal(tgrn._lam1_matrix(torch.as_tensor(lam), G).numpy(), ref)
    np.testing.assert_array_equal(tgrn._lam1_matrix(lam, G), ref)


def test_grn_scan_plain_matches_the_triangular_solve():
    rng = np.random.default_rng(3)
    G, S = 3, 17
    m = rng.normal(size=(S, 40))
    gram = torch.as_tensor(m @ m.T)
    r0, z, bold = (torch.as_tensor(rng.normal(size=(G, S))) for _ in range(3))
    var_e = torch.tensor(0.7, dtype=torch.float64)
    bnew, d = tscan.grn_scan_plain(gram, r0, z, bold, var_e)
    bs, ds = tscan.grn_scan_system(gram, r0, z, bold, var_e)
    scale = d.abs().max().item()
    assert torch.allclose(d, ds, rtol=0, atol=1e-10 * scale)
    assert torch.allclose(bnew, bs, rtol=0, atol=1e-10 * bnew.abs().max().item())
    assert torch.equal(bnew, tscan.grn_scan(gram, r0, z, bold, var_e)[0])  # the CPU takes the plain version


def _start(x, y, G, start_lam1):
    """The JAX est_grn's plan, xc, ytil and initial state."""
    S, N = x.shape
    xc = x - x.mean(axis=1, keepdims=True)
    n_l = G * G - G
    lam1_0 = np.zeros(n_l) if start_lam1 is None else np.broadcast_to(np.asarray(start_lam1, float), (n_l,))
    mu0 = y.mean(axis=1)
    ycorr0 = y - mu0[:, None] - np.asarray(jgrn._lam1_matrix(jnp.asarray(lam1_0), G)) @ y
    plan = jgrn.GRNPlan(n_genes=G, n_snps=S, n_ind=N, mean_lam1=0.0, nu_s_l1=1e-3, df_l1=4.0,
                        nu_s_beta=1e-3, df_beta=4.0, nu_s_e=2.0, df_e=4.0)
    state = jgrn.GRNState(
        mu=jnp.asarray(mu0), lam1=jnp.asarray(lam1_0), lam2=jnp.zeros((G, S)),
        var_lam1=jnp.asarray(5e-4), var_beta=jnp.full((G,), 5e-4), var_e=jnp.asarray(1.0),
        ycorr=jnp.asarray(ycorr0), accept=jnp.asarray(0, jnp.int32), it=jnp.asarray(0, jnp.int32))
    return plan, xc, ycorr0, state


def _chains(x, y, G, start_lam1, n_iter, seed):
    """The JAX step and the port's from one state with one key: yields
    (jax state, port state) after each iteration."""
    plan, xc, ytil, jstate = _start(x, y, G, start_lam1)
    jstep = jax.jit(jgrn.make_grn_step(plan, jnp.asarray(xc), jnp.asarray(ytil)))
    tplan = tgrn.GRNPlan(**vars(plan))
    tstate = tgrn.grn_state_from_numpy(
        tplan, {f: np.asarray(getattr(jstate, f)) for f in FIELDS + ("accept", "it")}, device="cpu")
    tstep = tgrn.make_grn_step(tplan, torch.as_tensor(xc), torch.as_tensor(ytil))
    key = jax.random.key(seed)
    stream = JaxStream(key)
    for _ in range(n_iter):
        jstate, tstate = jstep(jstate, key), tstep(tstate, stream)
        yield jstate, tstate


@pytest.mark.parametrize("start_lam1", [None, 0.1], ids=["zero", "0.1"])
def test_grn_step_follows_jax(start_lam1):
    x, y, _, _ = _simulate(np.random.default_rng(42))
    accepts = []
    for i, (js, ts) in enumerate(_chains(x, y, 4, start_lam1, 25, seed=5)):
        for f in FIELDS:
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=1e-9,
                                       atol=1e-12, err_msg=f"{f} at iteration {i + 1}")
        assert int(ts.accept) == int(js.accept) and ts.it == int(js.it) == i + 1
        assert int(ts.it_counter) == ts.it
        accepts.append(int(ts.accept))
    assert 0 < accepts[-1] < 25  # both accepts and rejects occurred


def _two_genes(seed=7, N=200, S=6):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 3, (S, N)).astype(float)
    xc = x - x.mean(axis=1, keepdims=True)
    lam1 = np.array([[0.0, 0.3], [0.4, 0.0]])
    lam2 = rng.normal(0, 0.4, (2, S))
    y = np.linalg.solve(np.eye(2) - lam1, rng.normal(0, 1, (2, 1)) + lam2 @ xc + rng.normal(0, 0.3, (2, N)))
    return x, y


def test_negative_determinant_follows_jax():
    """det(I - Lambda1) = 1 - 2 * 2 = -3 at the start: the JAX log-target
    (log|det|) is finite there, where log det would be NaN and reject every
    move away from it. The port's decisions are the JAX package's."""
    x, y = _two_genes()
    assert np.linalg.det(np.eye(2) - np.array([[0.0, 2.0], [2.0, 0.0]])) == pytest.approx(-3.0)
    decisions, prev = [], 0
    for i, (js, ts) in enumerate(_chains(x, y, 2, [2.0, 2.0], 10, seed=11)):
        assert int(ts.accept) == int(js.accept), f"iteration {i + 1}"
        for f in FIELDS:
            np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=1e-9,
                                       atol=1e-12, err_msg=f"{f} at iteration {i + 1}")
        decisions.append(int(ts.accept) - prev)
        prev = int(ts.accept)
    assert decisions[0] == 1  # the first move leaves the negative determinant: accepted


def _read(path):
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        rows = np.array([[float(v) for v in line.split("\t")] for line in fh.read().splitlines()])
    return header, rows


def test_est_grn_matches_jax(tmp_path, monkeypatch):
    from nextgp_tpu_torch import est_grn

    x, y, _, _ = _simulate(np.random.default_rng(42))
    kw = dict(chain_length=30, burn_in=10, output_freq=5, start_lam1=np.full(12, 0.1), seed=2)
    jacc, jdraws, jstate = jgrn.est_grn(x, y, 4, 3, out_folder=str(tmp_path / "jax"), **kw)
    tacc, tdraws, tstate = est_grn(x, y, 4, 3, out_folder=str(tmp_path / "port"), device="cpu",
                                   stream=JaxStream(jax.random.key(2)), **kw)
    assert tacc == jacc and 0 < tacc < 30
    assert sorted(tdraws) == sorted(jdraws) == sorted(
        ["Lambda1", "varLambda1", "Lambda2", "varBeta", "varE", "means"])
    for name, d in jdraws.items():
        assert tdraws[name].shape == d.shape == (4,) + d.shape[1:], name
        np.testing.assert_allclose(tdraws[name], d, rtol=1e-9, atol=1e-12, err_msg=name)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(tstate, f).numpy(), np.asarray(getattr(jstate, f)), rtol=1e-9,
                                   atol=1e-12, err_msg=f)
    jouts = sorted(f for f in os.listdir(tmp_path / "jax") if f.endswith("Out"))
    assert len(jouts) == 6 and jouts == sorted(os.listdir(tmp_path / "port"))
    for fn in jouts:
        jh, jrows = _read(tmp_path / "jax" / fn)
        th, trows = _read(tmp_path / "port" / fn)
        assert th == jh, fn
        assert trows.shape == jrows.shape == (4, len(jh)), fn
        np.testing.assert_allclose(trows, jrows, rtol=1e-9, atol=1e-12, err_msg=fn)
        np.testing.assert_array_equal(trows, tdraws[fn[:-3]], err_msg=fn)  # the files hold the draws
    monkeypatch.chdir(tmp_path / "port")
    est_grn(x, y, 4, 3, out_folder=None, device="cpu", **kw)
    assert sorted(os.listdir(tmp_path / "port")) == jouts


def test_est_grn_recovers_structure():
    """test_grn.py's test_grn_recovers_structure, on the port's default
    stream."""
    from nextgp_tpu_torch import est_grn

    x, y, lam1_true, lam2_true = _simulate(np.random.default_rng(42), noise=0.2)
    acc, draws, state = est_grn(x, y, 4, 3, chain_length=800, burn_in=300, output_freq=2,
                                out_folder=None, seed=3, device="cpu")
    G = 4
    lam1_mean = draws["Lambda1"].mean(axis=0).reshape(G, G).T  # column-major dump
    assert lam1_mean[1, 0] > 0.2
    assert lam1_mean[3, 2] < -0.15
    lam2_mean = draws["Lambda2"].mean(axis=0).reshape(-1, G).T
    assert np.corrcoef(lam2_mean.ravel(), lam2_true.ravel())[0, 1] > 0.7
    assert 0.01 < draws["varE"].mean() < 1.0
    assert acc > 0
    assert state.it == 800 and int(state.it_counter) == 800


def test_grn_work_counts_the_call():
    """diag.grn_work: gram's lower triangle, the three (G, S) inputs and two
    outputs and var_e, in bytes of the type; a multiply-add a gene and pair
    j < q and seven operations a gene and SNP; S dependent steps."""
    from nextgp_tpu_torch import diag

    G, S = 7, 13
    gram, r0 = torch.ones(S, S, dtype=torch.float32), torch.ones(G, S, dtype=torch.float32)
    words = int(torch.tril(gram).count_nonzero()) + 3 * r0.numel() + 2 * r0.numel() + 1
    pairs = int(torch.tril(gram, diagonal=-1).count_nonzero())
    assert diag.grn_work(G, S, 4) == (4 * words, G * (2 * pairs + 7 * S), S)
    assert diag.grn_work(G, S, 8)[0] == 8 * words


def _unpack(buf, S, word):
    """grn_layout's buffer read back entry by entry as GRN1 walks it:
    (tril(gram) from the row blocks and the diagonal tiles, the tiles below
    the diagonal from the chain area, rinv, srinv)."""
    T = tscan.TILE
    nt = -(-S // T)
    sp, v = T * nt, 16 // word
    low, below = np.zeros((sp, sp)), np.zeros((sp, sp))
    at = 0
    for i in range(1, nt):
        for k in range(i):
            for m in range(T // v):
                for r in range(T):
                    low[T * i + r, T * k + v * m:T * k + v * m + v] = buf[at:at + v]
                    at += v
    for i in range(nt):
        for s in range(T):
            low[T * i:T * i + T, T * i + s] = buf[at:at + T]
            at += T
        for s in range(T):
            if i + 1 < nt:
                below[T * (i + 1):T * (i + 2), T * i + s] = buf[at:at + T]
            else:
                assert not buf[at:at + T].any()  # no tile below the last
            at += T
    rinv, srinv = buf[at:at + sp], buf[at + sp:at + 2 * sp]
    assert at + 2 * sp == len(buf)
    return low, below, rinv, srinv


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("S", [1, 31, 32, 33, 65, 70])
def test_grn_layout_holds_the_triangle_and_reciprocals(S, dtype):
    rng = np.random.default_rng(S)
    m = rng.integers(0, 3, (S, 50)).astype(float)
    m -= m.mean(1, keepdims=True)
    gram = torch.as_tensor(m @ m.T, dtype=dtype)
    lay = tscan.grn_layout(gram)
    assert lay.n_snps == S and lay.buf.dtype == dtype and lay.buf.numel() == tscan.layout_words(S)
    low, below, rinv, srinv = _unpack(lay.buf.numpy().astype(np.float64), S, gram.element_size())
    sp = low.shape[0]
    want = np.zeros((sp, sp))
    want[:S, :S] = np.tril(gram.numpy().astype(np.float64))
    np.testing.assert_array_equal(low, want)
    T = tscan.TILE
    band = np.zeros((sp, sp), bool)
    for i in range(sp // T - 1):
        band[T * (i + 1):T * (i + 2), T * i:T * (i + 1)] = True
    np.testing.assert_array_equal(below, np.where(band, want, 0.0))
    diag = torch.diagonal(gram)
    np.testing.assert_array_equal(rinv[:S], (1.0 / diag).numpy())
    np.testing.assert_array_equal(srinv[:S], torch.sqrt(1.0 / diag).numpy())
    assert not rinv[S:].any() and not srinv[S:].any()


def test_grn_scan_takes_the_plain_version_on_the_cpu_with_a_layout():
    rng = np.random.default_rng(9)
    G, S = 3, 40
    m = rng.normal(size=(S, 60))
    gram = torch.as_tensor(m @ m.T)
    r0, z, bold = (torch.as_tensor(rng.normal(size=(G, S))) for _ in range(3))
    var_e = torch.tensor(0.3, dtype=torch.float64)
    ref = tscan.grn_scan_plain(gram, r0, z, bold, var_e)
    got = tscan.grn_scan(gram, r0, z, bold, var_e, tscan.grn_layout(gram))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))


def test_make_grn_step_makes_no_layout_on_the_cpu(monkeypatch):
    """The layout is GRN1's: a chain on the CPU runs the plain scan and
    packs nothing (on the card make_grn_step packs it once, not a step)."""
    calls = []
    monkeypatch.setattr(tgrn, "grn_layout", lambda gram: calls.append(gram))
    x, y, _, _ = _simulate(np.random.default_rng(42))
    _, state, step = tgrn.prepare_grn(x, y, 4, device="cpu")
    step(step(state, JaxStream(jax.random.key(1))), JaxStream(jax.random.key(2)))
    assert calls == []
