"""The port's in-block scans and their coefficients against the JAX package.

Packs (`r_block_pack`, `gauss_block_pack`, `bc_block_pack`,
`rcpi_block_pack`, `rcplus_block_pack`): the JAX
functions always emit float32 (their `_pack` casts), so their arithmetic is
evaluated in float64 by running the unjitted functions with the module's
F32 name pointed at float64; the port's float64 result must agree to
1e-12 (q0 is +inf on padded loci in both). The plain scans
(`r_block_scan_v`, `gauss_block_scan_v`, `bc_block_scan_v`,
`bc_block_scan_wv`, `rcpi_block_scan_v`, `rcplus_block_scan_v`) must match
the Pallas kernels in interpret mode (float32, atol 1e-5 on the continuous
outputs; delta and the other discrete outputs exact), sliced and
step-indexed, and at V=1 also the single-chain kernels. The Gaussian scan
as one batched unit lower-triangular solve (`gauss_block_system` and the
library call chip_smoke.py times beside K5/K6) equals the loop in
float64. The annotation
fixtures carry padded loci, annotations that are zero on some loci and a
null class. The CUDA kernels are checked
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


@pytest.mark.parametrize("V,B,K", [(1, 8, 3), (4, 8, 4), (2, 8, 20)])
def test_r_block_scan_v_matches_interpret(V, B, K):
    """K = 20 is past the 16 classes the port's kernel once took; the JAX
    kernel has no cap."""
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


SCAN8_CASES = [(V, B) for V in (1, 3) for B in (8, 16, 40)]  # 40: past one 32-locus group


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


@pytest.mark.parametrize("V,B", [(1, 8), (3, 40)])
def test_gauss_block_scan_v_trisolve_matches_plain(V, B):
    """The Gaussian scan as one batched unit lower-triangular solve equals
    the loop in float64 (1e-9 relative), masked loci (b = c = 0) included."""
    gram, _, pk = _scan8_inputs(np.random.default_rng(V + B), 1, V, B, "gauss")
    pk = pk.astype(np.float64)
    pk[:, -3:, 2:4] = 0.0  # masked loci: identity rows, u = bold
    gram_t, pk_t = torch.from_numpy(gram[0].astype(np.float64)), torch.from_numpy(pk)
    mat, rhs = tgk.gauss_block_system(gram_t, pk_t)
    u = torch.linalg.solve_triangular(mat, rhs, upper=False, unitriangular=True)[..., 0]
    for out, ref in zip((pk_t[..., 1] - u, u), tgk.gauss_block_scan_v_plain(gram_t, pk_t)):
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-9,
                                   atol=1e-9 * ref.abs().max().item())
    assert torch.equal(u[:, -3:], pk_t[:, -3:, 1])


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


# ------------------------------------------------------------ BayesRCpi / BayesRCplus


def _rc_pack_inputs(rng, p, A, K, dtype=np.float64):
    """Planner-like inputs of the annotation packs: three padded loci at the
    end (no annotation there), the first annotation on every other locus and
    the rest on about half of them, and a null first class."""
    mask = np.ones(p, bool)
    mask[-3:] = False
    anz = rng.integers(0, 2, (p, A)).astype(bool)
    anz[:, 0] = True
    anz[~mask] = False
    aprob = anz / np.maximum(anz.sum(1, keepdims=True), 1)
    varc = rng.uniform(0.5, 2.0, (A, 1)) * np.concatenate([[0.0], rng.uniform(1e-3, 1e-1, K - 1)])
    common = dict(
        beta_old=rng.normal(0, 0.1, p) * mask, mpm=rng.uniform(10, 50, p) * mask,
        lss=rng.uniform(0, 1, p), rss=rng.normal(0, 0.1, p), mask=mask, varc=varc,
        logpi=np.log(rng.dirichlet(np.ones(K), A)), ive=dtype(0.7), var_e=dtype(1 / 0.7))
    rcpi = dict(z=rng.normal(0, 1, p), ua=rng.uniform(0, 1, p), uv=rng.uniform(0, 1, p),
                g1=rng.gamma(np.maximum(anz, 1e-6)), g2=rng.gamma(anz + 1.0), aprob=aprob, anz=anz,
                **common)
    rcplus = dict(z=rng.normal(0, 1, (p, A)), ua=rng.uniform(0, 1, (p, A)), anz=anz, **common)
    cast = lambda d: {k: v.astype(dtype) if getattr(v, "dtype", None) == np.float64 else v
                      for k, v in d.items()}
    return cast(rcpi), cast(rcplus)


@pytest.mark.parametrize("kind", ["rcpi", "rcplus"])
def test_rc_block_pack_f64(monkeypatch, kind):
    A, K, p = 3, 4, 40
    args = _rc_pack_inputs(np.random.default_rng(6), p, A, K)[kind == "rcplus"]
    monkeypatch.setattr(jgk, "F32", jnp.float64)
    jfn, tfn = getattr(jgk, f"{kind}_block_pack"), getattr(tgk, f"{kind}_block_pack")
    ref = np.asarray(jfn.__wrapped__(**{k: jnp.asarray(v) for k, v in args.items()}))
    out = tfn(**{k: torch.as_tensor(v) for k, v in args.items()})
    width = 8 + (8 if kind == "rcpi" else 6) * A * K
    assert ref.dtype == np.float64 and out.dtype == torch.float64
    assert out.shape == ref.shape == (p, width)
    assert np.isfinite(ref).all()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)
    # b and c are zero on padded loci and for the null class; for rcplus also
    # where the annotation is zero
    b = out[:, width - 2 * A * K:width - A * K].reshape(p, A, K)
    assert (b[-3:] == 0).all() and (b[:, :, 0] == 0).all() and (b[:-3, 0, 1:] > 0).all()
    if kind == "rcplus":
        assert (b[~torch.as_tensor(args["anz"])] == 0).all()


def _rc_scan_inputs(kind, seed, T, V, B, A, K):
    """Step-indexed Gram blocks with a dominant diagonal near 30 and
    coefficient rows from the port's own pack in float32, with r0 added to
    slot 0 as the sweep does."""
    rng = np.random.default_rng(seed)
    a = rng.normal(0, 1, (T, V, B, 3 * B))
    gram = (np.einsum("tvbn,tvcn->tbvc", a, a) * (30.0 / (3 * B))).astype(np.float32)
    args = _rc_pack_inputs(rng, V * B, A, K, np.float32)[kind == "rcplus"]
    args["mpm"] = (np.einsum("bvb->vb", gram[0]).reshape(-1) * args["mask"]).astype(np.float32)
    pk = getattr(tgk, f"{kind}_block_pack")(**{k: torch.as_tensor(v) for k, v in args.items()})
    pk = pk.reshape(V, B, -1).clone()
    pk[:, :, 0] += torch.as_tensor(rng.normal(0, 5, (V, B)).astype(np.float32))
    assert pk.dtype == torch.float32
    return gram, pk.numpy()


def _same_rc(port, ref, discrete):
    assert len(port) == len(ref)
    for i, (x, r) in enumerate(zip(port, ref)):
        if i in discrete:
            np.testing.assert_array_equal(x.numpy(), np.asarray(r), err_msg=f"output {i}")
        else:
            np.testing.assert_allclose(x.numpy(), np.asarray(r), atol=1e-5, err_msg=f"output {i}")


RC_KINDS = {  # kind -> (V-batched Pallas kernel, its single-chain form, discrete outputs)
    "rcpi": (jgk.rcpi_block_scan_v, jgk.rcpi_block_scan, (2, 3)),
    "rcplus": (jgk.rcplus_block_scan_v, jgk.rcplus_block_scan, (2, 3, 5)),
}


@pytest.mark.parametrize("V,B,A,K", [(1, 8, 3, 3), (4, 8, 2, 4)])
@pytest.mark.parametrize("kind", ["rcpi", "rcplus"])
def test_rc_block_scan_v_matches_interpret(kind, V, B, A, K):
    T = 2
    jscan_v, jscan, discrete = RC_KINDS[kind]
    tscan = getattr(tgk, f"{kind}_block_scan_v")
    gram, pk = _rc_scan_inputs(kind, V * 10 + K, T, V, B, A, K)
    gram_t, pk_t = torch.from_numpy(gram), torch.from_numpy(pk)
    for t in range(T):
        out = tscan(gram_t[t], pk_t, A, K)
        _same_rc(out, jscan_v(jnp.asarray(gram[t]), jnp.asarray(pk), A, K, interpret=True), discrete)
        _same_rc(tscan((gram_t, t), pk_t, A, K),
                 jscan_v((jnp.asarray(gram), t), jnp.asarray(pk), A, K, interpret=True), discrete)
        assert all(torch.isfinite(x).all() for x in out)
        # the padded loci: beta 0, every discrete output 0
        assert (out[0][-1, -3:] == 0).all() and (out[2][-1, -3:] == 0).all()
        assert (out[3][-1, -3:] == 0).all()
        if V == 1:  # the single-chain kernel is the V=1 case
            ref = jscan(jnp.asarray(gram[t][:, 0]), jnp.asarray(pk[0]), A, K, interpret=True)
            _same_rc([x[0] for x in out], ref, discrete)
    delta = out[2].numpy()
    assert len(np.unique(delta)) > 2  # the padded 0 and at least two classes occur
    if kind == "rcpi":
        acat, aprob = out[3].numpy(), out[4].numpy()
        on = pk[:, :, 4] != 0
        anz = pk[:, :, 8 + 3 * A * K:8 + 4 * A * K:K] != 0
        assert (np.take_along_axis(anz, np.maximum(acat - 1, 0)[..., None], -1)[..., 0] | ~on).all()
        np.testing.assert_allclose(aprob.sum(-1)[on], 1.0, atol=1e-6)
        assert (aprob[~anz] == 0).all()
    else:
        cls, bs, nz = (x.numpy() for x in out[3:])
        anz = pk[:, :, 8 + A * K:8 + 2 * A * K:K] != 0
        assert (cls[~anz] == 0).all() and (bs[~anz] == 0).all() and (nz[~anz] == 0).all()
        np.testing.assert_allclose(bs.sum(-1), out[0].numpy(), atol=1e-6)
        assert ((cls > 1) == (nz == 1)).all()  # class 1 is the null class


def test_rcpi_scan_clamps_annotation_at_cdf_edge():
    """A uniform above the annotation CDF's last entry must select the last
    annotation (the JAX pure path's clamp; its TPU kernel leaves the draw
    unclamped and would index past the grid), with every output finite."""
    A, K, V, B = 3, 3, 2, 8
    gram, pk = _rc_scan_inputs("rcpi", 7, 1, V, B, A, K)
    pk[..., 2] = 2.0  # above every CDF entry
    out = tgk.rcpi_block_scan_v(torch.from_numpy(gram[0]), torch.from_numpy(pk), A, K)
    on = pk[:, :, 4] != 0
    assert (out[3].numpy()[on] == A).all() and (out[3].numpy()[~on] == 0).all()
    assert all(torch.isfinite(x).all() for x in out)
    pk[..., 3] = 2.0  # and the class draw likewise
    out = tgk.rcpi_block_scan_v(torch.from_numpy(gram[0]), torch.from_numpy(pk), A, K)
    # where the clamped annotation is zero on the locus its class row is 0/0:
    # class 0 (the null class) there, as on a padded locus
    last = pk[:, :, 8 + 3 * A * K + (A - 1) * K] != 0
    delta = out[2].numpy()
    assert (delta[on & last] == K).all() and (delta[on & ~last] == 1).all()
    assert (out[0].numpy()[on & ~last] == 0).all()
    assert all(torch.isfinite(x).all() for x in out)


@pytest.mark.parametrize("B,A,K,sections,need,fits", [
    (256, 3, 3, 8, 58_624, True),  # the main paths' shape
    (256, 3, 3, 6, 58_624, True),
    (1024, 8, 4, 8, 61_696, True),  # the widest block, a full warp of (annotation, class) pairs
    (1024, 8, 4, 6, 61_696, True),
    (256, 10, 4, 8, 12_296, True),  # past a warp: the serial rule's two rows and scratch
    (1024, 16, 16, 8, 30_080, True),
    (8, 500, 16, 8, 554_640, False),  # one row alone is 256 KB
    (8, 500, 16, 6, 426_640, False),
])
def test_rc_scan_shared_memory_need(B, A, K, sections, need, fits):
    """The annotation scans' shared memory as a function of the shape: the
    skeleton's u per thread and two rotating slots of a 32 x 33 Gram tile; up
    to A * K = 32 two groups' staged coefficients (2 x 32 loci x 6 words x 32
    lanes), independent of A and K; above that two coefficient rows and the
    scratch."""
    assert tgk.rc_scan_smem_bytes(B, A, K, sections) == need
    assert (need <= tgk.SMEM_BYTES) == fits
    if A * K <= 32:
        assert need == tgk.rc_scan_smem_bytes(B, 1, 1, sections)


@pytest.mark.parametrize("B,K,need,fits", [
    (256, 4, 15_616, True),  # the main path's shape
    (1024, 8, 22_784, True),  # the largest rule in one lane: two groups of 32 rows of 40 floats
    (1024, 9, 12_932, True),  # one class past it: the serial rule's two rows and K words of scratch
    (1024, 16, 13_184, True),  # 16 classes at the widest block: once past what K3 took
    (1024, 33, 13_796, True),
    (32, 6_600, 246_240, False),  # two rows of 26,408 floats
])
def test_r_scan_shared_memory_need(B, K, need, fits):
    """K3's shared memory: the skeleton's u per thread and two rotating slots
    of a 32 x 33 Gram tile; for the rule in one lane (K <= 8) two groups'
    whole coefficient rows, above that two rows and the serial rule's K
    words. No chain's rows are held whole, so neither B nor K alone runs out
    of shared memory."""
    assert tgk.R_LANE_MAX_K == 8
    assert tgk.r_scan_smem_bytes(B, K) == need
    assert (need <= tgk.SMEM_BYTES) == fits
