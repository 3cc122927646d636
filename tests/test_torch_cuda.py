"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge shapes that chip_smoke.py's main-path shapes do not reach: row counts
that are not a multiple of the gather's rows per warp, the smallest packed
width, a 50k-individual width that needs more than 48 KB of shared memory,
blocks narrower than a warp or not a multiple of 32, K from 2 to 16, and a
short chain through the whole sweep. CUDA kernels have no CPU mode, so
every test here skips without a card. Run on the card (tests/conftest.py
imports jax, which the card's machine does not have):

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


def test_sweep_on_card_matches_plain_chain(dev):
    """A short chain through assemble / make_sweep on the card, against the
    same chain on the CPU in float32 from the same draws."""
    rng = np.random.default_rng(3)
    n, p = 300, 512
    g = rng.integers(0, 3, (n, p))
    y = (g - g.mean(0)) @ rng.normal(0, 0.1, p) + rng.normal(0, 1, n)
    spec = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))],
                         markers=[ngt.MarkerTerm("M", ngt.from_array(g), ngt.BayesR(
                             [0.9, 0.05, 0.03, 0.02], [0.0, 1e-4, 1e-3, 1e-2], 1.0, estimatePi=True))],
                         block_size=32)

    out = {}
    for device in (dev, torch.device("cpu")):
        plan, st = ngt.assemble(spec, device=device, dtype=torch.float32, vshards=4)
        sweep, draws = ngt.make_sweep(plan), HostStream(4, device)
        for _ in range(3):
            st = sweep(st, draws)
        out[device.type] = st
    k, c = out["cuda"], out["cpu"]
    assert torch.equal(k.markers[0].delta.cpu(), c.markers[0].delta)
    assert _rel(k.markers[0].beta.cpu(), c.markers[0].beta) < 1e-3
    assert _rel(k.ycorr.cpu(), c.ycorr) < 1e-4
