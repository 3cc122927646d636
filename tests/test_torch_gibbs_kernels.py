"""The port's in-block scans and their coefficients against the JAX package.

Packs (`r_block_pack`, `gauss_block_pack`, `bc_block_pack`): the JAX
functions always emit float32 (their `_pack` casts), so their arithmetic is
evaluated in float64 by running the unjitted functions with the module's
F32 name pointed at float64; the port's float64 result must agree to
1e-12 (q0 is +inf on padded loci in both). The plain scans
(`r_block_scan_v`, `gauss_block_scan_v`, `bc_block_scan_v`,
`bc_block_scan_wv`) must match the Pallas kernels in interpret mode
(float32, atol 1e-5 on beta and u; delta exact), sliced and step-indexed,
and at V=1 also the single-chain kernels. The CUDA kernels are checked
against these plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgp_tpu.ops import gibbs_kernels as jgk
from nextgp_tpu_torch.ops import gibbs_kernels as tgk


def _pack_inputs(rng, p, K):
    mask = np.ones(p, bool)
    mask[-3:] = False
    varc = np.concatenate([[0.0], rng.uniform(1e-3, 1e-1, K - 1)])
    pi = rng.dirichlet(np.ones(K))
    return dict(
        beta_old=rng.normal(0, 0.1, p), z=rng.normal(0, 1, p), unif=rng.uniform(0, 1, p),
        mpm=rng.uniform(10, 50, p) * mask, lss=np.zeros(p), rss=np.zeros(p), mask=mask,
        varc=varc, logpi=np.log(pi), ive=np.float64(0.7), var_e=np.float64(1 / 0.7))


def test_r_block_pack_f64(monkeypatch):
    rng = np.random.default_rng(0)
    args = _pack_inputs(rng, 40, 4)
    monkeypatch.setattr(jgk, "F32", jnp.float64)
    ref = np.asarray(jgk.r_block_pack.__wrapped__(**{k: jnp.asarray(v) for k, v in args.items()}))
    assert ref.dtype == np.float64
    out = tgk.r_block_pack(**{k: torch.as_tensor(v) for k, v in args.items()})
    assert out.dtype == torch.float64 and out.shape == ref.shape == (40, 8 + 16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)


def _scan_inputs(rng, T, V, B, K):
    """A Gram with a dominant diagonal and coefficient rows shaped like
    r_block_pack's (q1 > 0 on the non-zero classes, zero for class 0)."""
    a = rng.normal(0, 1, (T, V, B, 3 * B))
    gram = np.einsum("tvbn,tvcn->tbvc", a, a) / (3 * B)  # locus-major (T, B, V, B)
    pk = np.zeros((V, B, 8 + 4 * K))
    pk[..., 0] = rng.normal(0, 2, (V, B))
    pk[..., 1] = rng.normal(0, 0.1, (V, B))
    pk[..., 2] = rng.uniform(0, 1, (V, B))
    pk[..., 3] = rng.uniform(0, 1, (V, B)) > 0.1
    pk[..., 8:8 + K] = rng.normal(0, 1, (V, B, K))
    pk[..., 8 + K + 1:8 + 2 * K] = rng.uniform(0, 0.5, (V, B, K - 1))
    pk[..., 8 + 2 * K + 1:8 + 3 * K] = rng.uniform(0, 0.5, (V, B, K - 1))
    pk[..., 8 + 3 * K + 1:8 + 4 * K] = rng.normal(0, 0.1, (V, B, K - 1))
    return gram.astype(np.float32), pk.astype(np.float32)


def _same(port, ref):
    beta, u, delta = (x.numpy() for x in port)
    rb, ru, rd = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(beta, rb, atol=1e-5)
    np.testing.assert_allclose(u, ru, atol=1e-5)
    np.testing.assert_array_equal(delta, rd)


@pytest.mark.parametrize("V,B,K", [(1, 8, 3), (4, 8, 4)])
def test_r_block_scan_v_matches_interpret(V, B, K):
    T = 2
    gram, pk = _scan_inputs(np.random.default_rng(V * 10 + K), T, V, B, K)
    gram_t, pk_t = torch.from_numpy(gram), torch.from_numpy(pk)
    for t in range(T):
        ref = jgk.r_block_scan_v(jnp.asarray(gram[t]), jnp.asarray(pk), K, interpret=True)
        _same(tgk.r_block_scan_v(gram_t[t], pk_t, K), ref)
        ref = jgk.r_block_scan_v((jnp.asarray(gram), t), jnp.asarray(pk), K, interpret=True)
        _same(tgk.r_block_scan_v((gram_t, t), pk_t, K), ref)
        if V == 1:  # the single-chain kernel is the V=1 case
            ref = jgk.r_block_scan(jnp.asarray(gram[t][:, 0]), jnp.asarray(pk[0]), K,
                                   interpret=True)
            _same([x[0] for x in tgk.r_block_scan_v(gram_t[t], pk_t, K)], ref)


def test_scan_clamps_class_at_cdf_edge():
    """A uniform above the float CDF's last entry must select the last class
    (the min(cls, K-1) clamp), not index past it."""
    K, B = 3, 4
    gram, pk = _scan_inputs(np.random.default_rng(5), 1, 1, B, K)
    pk[..., 2] = 1.0  # every uniform at the top edge
    pk[..., 3] = 1.0
    _, _, delta = tgk.r_block_scan_v(torch.from_numpy(gram[0]), torch.from_numpy(pk), K)
    assert (delta.numpy() == K).all()


def _bc_pack_inputs(rng, p, common):
    mask = np.ones(p, bool)
    mask[-3:] = False
    vb = rng.uniform(1e-3, 1e-1, p) * mask
    vb[5] = 0.0  # an excluded BayesB locus: ivb = inf
    if common:
        vb = np.full(p, 0.02)
    ivb = np.where(vb > 0, 1.0 / np.where(vb > 0, vb, 1.0), np.inf)
    return dict(
        beta_old=rng.normal(0, 0.1, p), z=rng.normal(0, 1, p), unif=rng.uniform(0, 1, p),
        vb=vb, ivb=ivb, mpm=rng.uniform(10, 50, p) * mask, lss=np.zeros(p),
        rss=rng.normal(0, 0.1, p), mask=mask, ive=np.float64(0.7), var_e=np.float64(1 / 0.7),
        lp0=np.log(0.7), lp1=np.log(0.3))


def test_gauss_block_pack_f64(monkeypatch):
    rng = np.random.default_rng(1)
    p = 40
    args = _bc_pack_inputs(rng, p, False)
    args = dict(r0_extra=rng.normal(0, 1, p), beta_old=args["beta_old"], z=args["z"],
                ivb=rng.uniform(10, 100, p), mpm=args["mpm"], lss=args["lss"], rss=args["rss"],
                mask=args["mask"], ive=args["ive"])
    monkeypatch.setattr(jgk, "F32", jnp.float64)
    ref = np.asarray(jgk.gauss_block_pack.__wrapped__(**{k: jnp.asarray(v) for k, v in args.items()}))
    out = tgk.gauss_block_pack(**{k: torch.as_tensor(v) for k, v in args.items()})
    assert ref.dtype == np.float64 and out.dtype == torch.float64 and out.shape == ref.shape == (p, 8)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("common", [True, False], ids=["BayesC", "BayesB"])
@pytest.mark.parametrize("weighted", [False, True], ids=["I", "D"])
def test_bc_block_pack_f64(monkeypatch, common, weighted):
    rng = np.random.default_rng(2)
    p = 40
    args = _bc_pack_inputs(rng, p, common)
    if weighted:
        args["mpm_raw"] = rng.uniform(10, 50, p)
    monkeypatch.setattr(jgk, "F32", jnp.float64)
    ref = np.asarray(jgk.bc_block_pack.__wrapped__(
        **{k: jnp.asarray(v) for k, v in args.items()}, common=common))
    out = tgk.bc_block_pack(**{k: torch.as_tensor(v) for k, v in args.items()}, common=common)
    assert ref.dtype == np.float64 and out.dtype == torch.float64 and out.shape == ref.shape == (p, 8)
    assert np.isposinf(ref[-3:, 2]).all() and np.isposinf(out.numpy()[-3:, 2]).all()
    if not common:  # vb = 0: b = c = 0, not NaN
        assert out[5, 5].item() == 0.0 and out[5, 6].item() == 0.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)


def _scan8_inputs(rng, T, V, B, kind):
    """Gram blocks (weighted and raw) and (V, B, 8) rows shaped like the
    packs: for B/C a threshold w around q0 + q1*pre^2, some loci padded
    (q0 = +inf) and some uniforms at 0 (w = +inf)."""
    a = rng.normal(0, 1, (T, V, B, 3 * B))
    d = rng.uniform(0.5, 2.0, 3 * B)
    gram = np.einsum("tvbn,tvcn->tbvc", a * d, a) / (3 * B)
    graw = np.einsum("tvbn,tvcn->tbvc", a, a) / (3 * B)
    pk = np.zeros((V, B, 8))
    pk[..., 0] = rng.normal(0, 2, (V, B))
    pk[..., 1] = rng.normal(0, 0.1, (V, B))
    if kind == "gauss":
        pk[..., 2] = rng.uniform(0, 0.5, (V, B))
        pk[..., 3] = rng.normal(0, 0.1, (V, B))
    else:
        pk[..., 2] = rng.normal(0, 1, (V, B))
        pk[..., 3] = -rng.uniform(0, 0.5, (V, B))
        pk[..., 4] = rng.normal(0, 1, (V, B))
        pk[..., 5] = rng.uniform(0, 0.5, (V, B))
        pk[..., 6] = rng.normal(0, 0.1, (V, B))
        pk[..., 7] = rng.normal(0, 2, (V, B))
        pk[:, -1, 2] = np.inf  # a padded locus: never included
        pk[:, 0, 4] = np.inf  # a uniform at 0: always included
    return gram.astype(np.float32), graw.astype(np.float32), pk.astype(np.float32)


SCAN8_CASES = [(V, B) for V in (1, 3) for B in (8, 16)]


def _same2(port, ref):
    for x, r in zip(port, ref):
        np.testing.assert_allclose(x.numpy(), np.asarray(r), atol=1e-5)


@pytest.mark.parametrize("V,B", SCAN8_CASES)
def test_gauss_block_scan_v_matches_interpret(V, B):
    T = 2
    gram, _, pk = _scan8_inputs(np.random.default_rng(V * 100 + B), T, V, B, "gauss")
    gram_t, pk_t = torch.from_numpy(gram), torch.from_numpy(pk)
    for t in range(T):
        _same2(tgk.gauss_block_scan_v(gram_t[t], pk_t),
               jgk.gauss_block_scan_v(jnp.asarray(gram[t]), jnp.asarray(pk), interpret=True))
        _same2(tgk.gauss_block_scan_v((gram_t, t), pk_t),
               jgk.gauss_block_scan_v((jnp.asarray(gram), t), jnp.asarray(pk), interpret=True))
        if V == 1:
            ref = jgk.gauss_block_scan(jnp.asarray(gram[t][:, 0]), jnp.asarray(pk[0]), interpret=True)
            _same2([x[0] for x in tgk.gauss_block_scan_v(gram_t[t], pk_t)], ref)


@pytest.mark.parametrize("V,B", SCAN8_CASES)
def test_bc_block_scan_v_matches_interpret(V, B):
    T = 2
    gram, _, pk = _scan8_inputs(np.random.default_rng(V * 100 + B + 1), T, V, B, "bc")
    gram_t, pk_t = torch.from_numpy(gram), torch.from_numpy(pk)
    for t in range(T):
        out = tgk.bc_block_scan_v(gram_t[t], pk_t)
        _same(out, jgk.bc_block_scan_v(jnp.asarray(gram[t]), jnp.asarray(pk), interpret=True))
        _same(tgk.bc_block_scan_v((gram_t, t), pk_t),
              jgk.bc_block_scan_v((jnp.asarray(gram), t), jnp.asarray(pk), interpret=True))
        delta = out[2].numpy()
        assert (delta[:, -1] == 0).all() and (delta[:, 0] == 1).all()
        assert 0 < delta.sum() < delta.size  # both outcomes occur
        if V == 1:
            ref = jgk.bc_block_scan(jnp.asarray(gram[t][:, 0]), jnp.asarray(pk[0]), interpret=True)
            _same([x[0] for x in out], ref)


@pytest.mark.parametrize("V,B", SCAN8_CASES)
def test_bc_block_scan_wv_matches_interpret(V, B):
    T = 2
    gram, graw, pk = _scan8_inputs(np.random.default_rng(V * 100 + B + 2), T, V, B, "bc")
    g_t, r_t, pk_t = torch.from_numpy(gram), torch.from_numpy(graw), torch.from_numpy(pk)
    jg, jr, jp = jnp.asarray(gram), jnp.asarray(graw), jnp.asarray(pk)
    for t in range(T):
        out = tgk.bc_block_scan_wv(g_t[t], r_t[t], pk_t)
        _same(out, jgk.bc_block_scan_wv(jg[t], jr[t], jp, interpret=True))
        _same(tgk.bc_block_scan_wv((g_t, t), (r_t, t), pk_t),
              jgk.bc_block_scan_wv((jg, t), (jr, t), jp, interpret=True))
        if V == 1:
            ref = jgk.bc_block_scan_w(jg[t][:, 0], jr[t][:, 0], jp[0], interpret=True)
            _same([x[0] for x in out], ref)
