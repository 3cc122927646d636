"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge shapes that chip_smoke.py's main-path shapes do not reach: row counts
that are not a multiple of the gather's rows per warp, the smallest packed
width, a 50k-individual width that needs more than 48 KB of shared memory,
a 100k-individual width whose y no longer fits shared memory (the gather
then reads a transposed copy from device memory), blocks narrower than a
warp or not a multiple of 32, K from 2 to 16, V from 1 to 96 chains, and
short chains through the whole sweep (BayesR, and BayesC with a weighted
residual). CUDA kernels have no CPU mode, so every test here skips without
a card. Run on the card (tests/conftest.py imports jax, which the card's
machine does not have):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

import nextgp_tpu_torch as ngt
from nextgp_tpu_torch.engine.rng import HostStream
from nextgp_tpu_torch.ops import _cuda, gibbs_kernels, pack2

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _rel(out, ref):
    return ((out - ref).abs().max() / ref.abs().max().clamp_min(1e-30)).item()


@pytest.mark.parametrize("rows,n", [(1, 5), (7, 300), (130, 1000), (2048, 600), (9, 50_000)])
def test_pack2_kernels_match_plain(dev, rows, n):
    rng = np.random.default_rng(rows)
    T = 3
    pk = torch.from_numpy(pack2.pack2_np(rng.integers(0, 4, (n, T * rows), dtype=np.int8))).to(dev)
    q = pk.shape[1]
    y4 = torch.randn(4, q, device=dev)
    u = torch.randn(rows, device=dev)
    u_all = torch.randn(T * rows, device=dev)
    before = dict(_cuda.LAUNCHES)
    assert _rel(pack2.matvec(pk, y4), pack2.matvec_plain(pk, y4)) < 1e-5
    assert _rel(pack2.rank_update(pk, u_all), pack2.rank_update_plain(pk, u_all)) < 1e-5
    for t in range(T):
        sl = pk[t * rows:(t + 1) * rows]
        assert _rel(pack2.matvec_step(pk, t, y4, rows), pack2.matvec_plain(sl, y4)) < 1e-5
        assert _rel(pack2.rank_update_step(pk, t, u), pack2.rank_update_plain(sl, u)) < 1e-5
    assert _cuda.LAUNCHES["pack2_matvec"] == before["pack2_matvec"] + 1 + T
    assert _cuda.LAUNCHES["pack2_rank_update"] == before["pack2_rank_update"] + 1 + T


def test_gather_past_the_shared_memory_stage(dev, monkeypatch):
    """n = 100,000 (q = 25,088): 16*q bytes of y exceed a block's shared
    memory, so K1 reads a transposed copy of y from device memory. It must
    match the plain version at a step offset > 0, give the same bits on a
    second call, and sum in the order of the staged path."""
    n, rows, T = 100_000, 1000, 3
    g = torch.Generator(device=dev).manual_seed(5)
    pk = pack2.pack2(torch.randint(0, 3, (n, T * rows), generator=g, device=dev, dtype=torch.int8))
    q = pk.shape[1]
    assert q == pack2.packed_q(n) == 25_088 and 16 * q > pack2.Y_STAGE_BYTES
    y = torch.zeros(4 * q, device=dev)
    y[:n] = torch.randn(n, generator=g, device=dev)
    y4 = pack2.y_planar(y)
    out = pack2.matvec_step(pk, 1, y4, rows)
    assert _rel(out, pack2.matvec_plain(pk[rows:2 * rows], y4)) < 1e-5
    assert torch.equal(out, pack2.matvec_step(pk, 1, y4, rows))
    small = pk[:, :4096].contiguous()  # q = 4096: staged by default
    staged = pack2.matvec_step(small, 2, y4[:, :4096].contiguous(), rows)
    monkeypatch.setattr(pack2, "Y_STAGE_BYTES", 0)
    assert torch.equal(staged, pack2.matvec_step(small, 2, y4[:, :4096].contiguous(), rows))


@pytest.mark.parametrize("V,B,K", [(1, 8, 2), (3, 16, 4), (5, 33, 16), (2, 256, 4), (1, 1024, 3)])
def test_scan_kernel_matches_plain(dev, V, B, K):
    g = torch.Generator(device=dev).manual_seed(V * 1000 + B + K)
    T = 2
    a = torch.randn(T, V, B, 2 * B, generator=g, device=dev)
    gram = torch.einsum("tvbn,tvcn->tbvc", a, a).contiguous() / (2 * B)
    pk = torch.zeros(V, B, 8 + 4 * K, device=dev)
    pk[..., 0] = torch.randn(V, B, generator=g, device=dev)
    pk[..., 1] = 0.1 * torch.randn(V, B, generator=g, device=dev)
    pk[..., 2] = torch.rand(V, B, generator=g, device=dev)
    pk[..., 3] = 1.0
    pk[..., 8:8 + K] = torch.randn(V, B, K, generator=g, device=dev)
    pk[..., 8 + K + 1:8 + 2 * K] = 0.3 * torch.rand(V, B, K - 1, generator=g, device=dev)
    pk[..., 8 + 2 * K + 1:8 + 3 * K] = 0.3 * torch.rand(V, B, K - 1, generator=g, device=dev)
    pk[..., 8 + 3 * K + 1:] = 0.1 * torch.randn(V, B, K - 1, generator=g, device=dev)
    for t in range(T):
        beta, u, delta = gibbs_kernels.r_block_scan_v((gram, t), pk, K)
        rb, ru, rd = gibbs_kernels.r_block_scan_v_plain(gram[t], pk, K)
        # a flipped class (a uniform within rounding of a CDF edge) would show in delta
        assert torch.equal(delta, rd)
        assert _rel(beta, rb) < 1e-4 and _rel(u, ru) < 1e-4
        sliced = gibbs_kernels.r_block_scan_v(gram[t].contiguous(), pk, K)
        assert all(torch.equal(x, y) for x, y in zip(sliced, (beta, u, delta)))


def _scan8_inputs(dev, T, V, B, seed, kind):
    g = torch.Generator(device=dev).manual_seed(seed)
    m = min(2 * B, 256)
    a = torch.randn(T, V, B, m, generator=g, device=dev)
    d = torch.rand(m, generator=g, device=dev) * 1.5 + 0.5
    gram = torch.einsum("tvbn,tvcn->tbvc", a * d, a).contiguous() / m
    graw = torch.einsum("tvbn,tvcn->tbvc", a, a).contiguous() / m
    pk = torch.zeros(V, B, 8, device=dev)
    pk[..., 0] = torch.randn(V, B, generator=g, device=dev)
    pk[..., 1] = 0.1 * torch.randn(V, B, generator=g, device=dev)
    pk[..., 2] = torch.randn(V, B, generator=g, device=dev)
    pk[..., 3] = -0.3 * torch.rand(V, B, generator=g, device=dev)
    pk[..., 4] = torch.randn(V, B, generator=g, device=dev)
    pk[..., 5] = 0.3 * torch.rand(V, B, generator=g, device=dev)
    pk[..., 6] = 0.1 * torch.randn(V, B, generator=g, device=dev)
    pk[..., 7] = torch.randn(V, B, generator=g, device=dev)
    if kind != "gauss":
        pk[:, -1, 2] = float("inf")  # a padded locus: never included
        pk[:, 0, 4] = float("inf")  # a uniform at 0: always included
    return gram, graw, pk


def _keep_off_threshold(gram, graw, pk, plain, margin=1e-3):
    """Move each locus's w at least `margin` away from its threshold
    q0 + q1*pre_raw^2 in the plain scan, so a rounding difference cannot
    flip an indicator. Locus j saw u masked to the loci before it."""
    B = pk.shape[1]
    tri = torch.tril(torch.ones(B, B, device=pk.device), diagonal=-1)
    g, slot = (gram, 0) if graw is None else (graw, 7)
    for _ in range(20):
        _, u, _ = plain(pk)
        pre = pk[..., slot] + torch.einsum("jvi,vi,ji->vj", g, u, tri)
        thr = pk[..., 2] + pk[..., 3] * pre * pre
        near = torch.isfinite(thr) & ((thr - pk[..., 4]).abs() < margin)
        if not near.any():
            return pk
        pk[..., 4] = torch.where(near, thr + 2 * margin, pk[..., 4])
    raise AssertionError("could not keep the thresholds away from w")


@pytest.mark.parametrize("V", [1, 5, 96])
@pytest.mark.parametrize("B", [8, 33, 256, 1024])
@pytest.mark.parametrize("kind", ["gauss", "bc", "bc_w"])
def test_scan8_kernels_match_plain(dev, kind, B, V):
    """K6, K8 and K10 against their plain versions, step-indexed and sliced."""
    T = 2
    gram, graw, pk = _scan8_inputs(dev, T, V, B, V * 10_000 + B, kind)
    for t in range(T):
        if kind == "gauss":
            got = gibbs_kernels.gauss_block_scan_v((gram, t), pk)
            ref = gibbs_kernels.gauss_block_scan_v_plain(gram[t], pk)
            sliced = gibbs_kernels.gauss_block_scan_v(gram[t].contiguous(), pk)
        else:
            if kind == "bc":
                def plain(p):
                    return gibbs_kernels.bc_block_scan_v_plain(gram[t], p)

                def kern(gt, p):
                    return gibbs_kernels.bc_block_scan_v(gt, p)
            else:
                def plain(p):
                    return gibbs_kernels.bc_block_scan_wv_plain(gram[t], graw[t], p)

                def kern(gt, p):
                    return gibbs_kernels.bc_block_scan_wv(gt, (graw, t) if isinstance(gt, tuple)
                                                          else graw[t].contiguous(), p)
            pk = _keep_off_threshold(gram[t], graw[t] if kind == "bc_w" else None, pk, plain)
            ref = plain(pk)
            got = kern((gram, t), pk)
            sliced = kern(gram[t].contiguous(), pk)
            assert torch.equal(got[2], ref[2])
            assert (got[2][:, -1] == 0).all() and (got[2][:, 0] == 1).all()
        assert _rel(got[0], ref[0]) < 1e-4 and _rel(got[1], ref[1]) < 1e-4
        assert all(torch.equal(x, y) for x, y in zip(sliced, got))


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    pk = torch.zeros(4, 128, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="float32"):
        pack2.matvec(pk, torch.zeros(4, 128, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="one CUDA device"):
        pack2.rank_update(pk, torch.zeros(4))
    with pytest.raises(ValueError, match="out of range"):
        pack2.matvec_step(pk, 1, torch.zeros(4, 128, device=dev), 4)
    gram = torch.zeros(1, 8, 2, 8, device=dev)
    with pytest.raises(ValueError, match="pk must be"):
        gibbs_kernels.r_block_scan_v((gram, 0), torch.zeros(2, 8, 12, device=dev), 2)


def _card_and_cpu_chains(dev, prior, weighted=False):
    """A short chain through assemble / make_sweep on the card and the same
    chain on the CPU in float32 from the same draws."""
    rng = np.random.default_rng(3)
    n, p = 300, 512
    g = rng.integers(0, 3, (n, p))
    y = (g - g.mean(0)) @ rng.normal(0, 0.1, p) + rng.normal(0, 1, n)
    res = ngt.RandomEffect(rng.uniform(0.5, 2.0, n), 1.0) if weighted else None
    spec = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))],
                         markers=[ngt.MarkerTerm("M", ngt.from_array(g), prior)], residual=res,
                         block_size=32)
    out = {}
    for device in (dev, torch.device("cpu")):
        plan, st = ngt.assemble(spec, device=device, dtype=torch.float32, vshards=4)
        sweep, draws = ngt.make_sweep(plan), HostStream(4, device)
        for _ in range(3):
            st = sweep(st, draws)
        out[device.type] = st
    return out["cuda"], out["cpu"]


def test_weighted_bayesc_sweep_on_card_matches_plain_chain(dev):
    """BayesC with a weighted residual: K1 twice per step (weighted and raw
    gathers) and K10, against the CPU chain."""
    before = dict(_cuda.LAUNCHES)
    k, c = _card_and_cpu_chains(dev, ngt.BayesC(0.1, 0.05, estimatePi=True), weighted=True)
    T = 512 // 32 // 4
    assert _cuda.LAUNCHES["bc_block_scan_wv"] - before["bc_block_scan_wv"] == 3 * T
    assert _cuda.LAUNCHES["pack2_matvec"] - before["pack2_matvec"] == 2 * 3 * T
    assert torch.equal(k.markers[0].delta.cpu(), c.markers[0].delta)
    assert _rel(k.markers[0].beta.cpu(), c.markers[0].beta) < 1e-3
    assert _rel(k.ycorr.cpu(), c.ycorr) < 1e-4


def test_sweep_on_card_matches_plain_chain(dev):
    """A short BayesR chain through assemble / make_sweep on the card,
    against the same chain on the CPU in float32 from the same draws."""
    k, c = _card_and_cpu_chains(dev, ngt.BayesR([0.9, 0.05, 0.03, 0.02], [0.0, 1e-4, 1e-3, 1e-2],
                                                1.0, estimatePi=True))
    assert torch.equal(k.markers[0].delta.cpu(), c.markers[0].delta)
    assert _rel(k.markers[0].beta.cpu(), c.markers[0].beta) < 1e-3
    assert _rel(k.ycorr.cpu(), c.ycorr) < 1e-4
