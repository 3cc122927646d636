"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge shapes that chip_smoke.py's main-path shapes do not reach: row counts
that are not a multiple of the gather's rows per warp, the smallest packed
width, K1's 4-row warp groups and K2's 512-row slices and 512-byte column tiles
one either side, the 10k, 50k and 100k widths (at 100k y fits neither
shared memory nor L1), K1 on several grids (the same bits), blocks of one locus,
narrower than a warp or not a multiple of 32, K from 1 to 40 (each of K3's two
rules: every instance in one lane's registers, K = 1 to 8, and on one thread
above), V from 1 to 96 chains, the same bits from two launches of K3, K6, K8
and K10,
and short chains through the whole sweep (BayesR, and BayesC with a weighted
residual); for the annotation scans K12 and K14 also one annotation, one
class, K = 16, A * K at, just past and twice a warp's 32 lanes, coefficient
rows that no longer fit shared memory, a chain that is all padding, the same
bits from two launches, and short BayesRCpi, BayesRCplus and BayesLV chains;
for the measurement ladder's kernels odd row counts, q = 16, one step (T = 1),
the 1- and 4-byte-load gathers at word counts past a whole pass and at
n = 100,000 (past the shared memory they once staged y in),
grids of one and of more blocks than row groups, signed dosages, the fused
step with K1's and K2's bits at their edges on any split and its tickets
reset, and each
wrapper's refusals; for the keyed draws (csrc/keyed_rng.cu) the plain
version's numbers at the main path's sizes (1, 4, either side of a warp,
257, 49,152), gammas at shapes 1e-6, 0.5, 1 and 25,000 and the refusal of
a shape that is not positive and finite, a draw captured in a CUDA graph
reading its sweep counter at replay, chains of all seven methods replayed
by make_scan_sampler and make_chain_runner with the same bits as eager
sweeps at V = 1 and 4, and the refusal of streams a graph cannot capture;
for the random effects' level scan (RE1, csrc/level_scan.cu) one level,
either side of a group and of the look-ahead, owners of two row blocks, q
not a multiple of 4, the same bits from two launches, a captured scan whose
replays are the next sweeps' scans, its refusals, an animal model replayed with the eager
chain's bits and following the plain chain; for the CG sampler's solve (CG1,
csrc/cg_solve.cu) the identity structure, a pedigree A^-1, weighted
records, a level with no records, one level and a solve stopped by
max_iter in float64 and float32 against the plain version, the same bits
twice, its refusals, an eager float64 A-cg sweep under the sync debug mode
"error", and A-cg chains replayed with the eager chain's bits and
iteration counts; R1's float64 output against its plain version; for the correlated terms
RE2 (one level, either side of a group, three tiles at q = 3,001; nT = 1,
2, 3 and the generic form at 5), CM1's folded block-step (rows read in
place, r0, centres and sum(y) added, beta written into the sweep's buffer;
with them zero, against the plain scan on complete rows) and its rule
launch (B = 16 and 256, V = 1 and 96, the block-step also at B = 100 and
1000; nT = 1 .. 4 and the generic 5, with padded loci; NaN on a locus that
is not positive definite), each the same bits twice, R1's
split entry point against its plain version and each row against the
single-site entry point, and both paths replayed with the eager chain's
bits and following the plain chain; run_lmem replayed with files,
checkpoints and a resume, and two chains of run_chains, each with the bits
of its run_lmem; BayesR on int8 rows (pack2=False) and on an imputed float
panel, and MultiBreed on float panels, at V = 1 and 4: no K1 or K2 launch,
replays with the eager chain's bits, the card chain following the plain
chain, and genomic_values_state on the card against genomic_values; for
the GRN sampler's scan (GRN1, csrc/grn_scan.cu) bench_grn's shapes and its
edges in float32 and float64 (either side of a tile, 3,000 SNPs, either
side of its shared-memory limit, where the d's go to scratch), a
monomorphic SNP and its refusals, an eager GRN step under the sync debug mode "error", and
est_grn replayed with the eager chain's bits; the float64 instances of K1, K2 and K3
at the float32 instances' edges (1e-12 of scale of the plain versions, the same bits
twice) and float64 BayesR chains on packed, int8 and float rows (following the plain
chain at 1e-9, replays with the eager chain's bits, through run_lmem); the float64
instances of K6, K8 and K10 at V in {1, 4, 96} and B in {8, 40, 256, 1,024}, and
float64 chains of BayesB, BayesC, BayesC+D, BayesPR and BayesLV on the card; the
float64 instances of RE1 and RE2 (nT = 1 .. 4 and the generic 5) at q = 1, 33,
1,025 and 3,001 (1e-12 of scale of the plain versions, the same bits twice), a
float64 RE1 captured in a graph whose replays are the next sweeps' scans, RE2's
refusal of mixed types, and float64 chains of BayesR with an animal effect and
with an (intercept, slope) animal group on the card; the float64 instances of
K12 and K14 (the rule on a warp at A = 8, K = 4 and at A = K = 1, on one thread
at A * K = 33) and of CM1 (nT = 1 .. 4 and the generic 5) and CM1r (1e-12 of
scale, discrete outputs identical), CM1's shared memory as the library and
its wrapper state it, the refusal of mixed types, and float64 chains of
BayesRCpi, BayesRCplus and MultiBreed on the card.
CUDA kernels have no CPU mode, so every test here skips without
a card. Run on the card (tests/conftest.py imports jax, which the card's
machine does not have):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import os

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


@pytest.mark.parametrize("rows,q", [(1, 16), (3, 48), (5, 528), (7, 2560), (4095, 496),
                                    (4097, 16), (511, 12_544), (513, 2560), (1025, 25_088)])
def test_pack2_kernels_at_their_edges(dev, rows, q):
    """K1 and K2 at the edges of their design, on step t = 1 of three: rows
    of 1, one either side of K1's 4-row warp group and of K2's 512-row slice,
    4k +- 1, 7; q = 16 (one K2 lane of a 512-byte tile), 48, one K2 tile
    either side (496, 528: a second tile with one lane), the 10k, 50k and
    100k widths. Both against the plain versions, both bit-identical on a
    second call."""
    g = torch.Generator(device=dev).manual_seed(rows * 7 + q)
    pk = torch.randint(0, 256, (3 * rows, q), generator=g, device=dev, dtype=torch.uint8)
    y4 = torch.randn((4, q), generator=g, device=dev)
    u = torch.randn(rows, generator=g, device=dev)
    sl = pk[rows:2 * rows]
    r0 = pack2.matvec_step(pk, 1, y4, rows)
    dy = pack2.rank_update_step(pk, 1, u)
    assert _rel(r0, pack2.matvec_plain(sl, y4)) < 1e-5
    assert _rel(dy, pack2.rank_update_plain(sl, u)) < 1e-5
    assert torch.equal(r0, pack2.matvec_step(pk, 1, y4, rows))
    assert torch.equal(dy, pack2.rank_update_step(pk, 1, u))


@pytest.mark.parametrize("rows,q", [(1, 16), (9, 2560), (24_576, 2560), (1000, 12_544)])
def test_gather_grid_gives_the_same_bits(dev, rows, q):
    """K1's grid is a parameter: a row's sum is one warp's, in one order,
    whatever the number of blocks."""
    g = torch.Generator(device=dev).manual_seed(q)
    pk = torch.randint(0, 256, (2 * rows, q), generator=g, device=dev, dtype=torch.uint8)
    y4 = torch.randn((4, q), generator=g, device=dev)
    ref = pack2.matvec_step(pk, 1, y4, rows)
    for blocks in (1, 3, 1000):
        assert torch.equal(ref, pack2._matvec_kernel(pk, rows, rows, y4, blocks))


def test_gather_past_the_shared_memory_stage(dev):
    """n = 100,000 (q = 25,088): y's 16*q bytes exceed a block's shared memory
    and L1, so K1 reads them from L2. K1 and K2 must match the plain versions
    at a step offset > 0 and give the same bits on a second call; K1 must
    give the same bits on any grid there too."""
    n, rows, T = 100_000, 1000, 3
    g = torch.Generator(device=dev).manual_seed(5)
    pk = pack2.pack2(torch.randint(0, 3, (n, T * rows), generator=g, device=dev, dtype=torch.int8))
    q = pk.shape[1]
    assert q == pack2.packed_q(n) == 25_088 and 16 * q > gibbs_kernels.SMEM_BYTES
    y = torch.zeros(4 * q, device=dev)
    y[:n] = torch.randn(n, generator=g, device=dev)
    y4 = pack2.y_planar(y)
    u = torch.randn(rows, generator=g, device=dev)
    out = pack2.matvec_step(pk, 1, y4, rows)
    assert _rel(out, pack2.matvec_plain(pk[rows:2 * rows], y4)) < 1e-5
    assert torch.equal(out, pack2.matvec_step(pk, 1, y4, rows))
    assert torch.equal(out, pack2._matvec_kernel(pk, rows, rows, y4, 5))
    dy = pack2.rank_update_step(pk, 2, u)
    assert _rel(dy, pack2.rank_update_plain(pk[2 * rows:], u)) < 1e-5
    assert torch.equal(dy, pack2.rank_update_step(pk, 2, u))


def _r_inputs(dev, T, V, B, K, seed):
    """Step-indexed Gram blocks and BayesR-shaped coefficient rows: a null
    class 0 (q1 = b = c = 0) and K - 1 classes with q1, b > 0."""
    g = torch.Generator(device=dev).manual_seed(seed)
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
    return gram, pk, g


@pytest.mark.parametrize("V,B,K", [
    (1, 8, 2), (3, 16, 4), (5, 33, 16), (2, 256, 4), (1, 1024, 3),
    (2, 40, 1),  # one class: the skeleton and a multiply-add
    (3, 70, 5), (2, 256, 6), (1, 1024, 7),  # every other instance of the rule in one lane
    (4, 96, 8),  # the largest rule in one lane's registers
    (2, 96, 9),  # one class past it: the serial rule
    (2, 256, 20), (1, 1024, 16),  # past K3's old cap of 16 classes; 16 at the widest block
    (2, 64, 32), (3, 64, 40),
])
def test_scan_kernel_matches_plain(dev, V, B, K):
    """K3 against its plain version, step-indexed and sliced, with every
    uniform kept 1e-4 off the CDF edges: the kernel compares cum < u * total
    in its own sum order, so only such inputs fix the class exactly."""
    T = 2
    gram, pk, g = _r_inputs(dev, T, V, B, K, V * 1000 + B + K)
    for t in range(T):
        rb, ru, rd = _keep_off_cdf_edges(pk, lambda p: gibbs_kernels.r_block_scan_v_plain(gram[t], p, K),
                                         [2], (2,), g)
        before = _cuda.LAUNCHES["r_block_scan_v"]
        beta, u, delta = gibbs_kernels.r_block_scan_v((gram, t), pk, K)
        assert _cuda.LAUNCHES["r_block_scan_v"] == before + 1
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
    tri = torch.tril(torch.ones(B, B, dtype=pk.dtype, device=pk.device), diagonal=-1)
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
@pytest.mark.parametrize("B", [1, 8, 31, 33, 256, 1024])
@pytest.mark.parametrize("kind", ["gauss", "bc", "bc_w"])
def test_scan8_kernels_match_plain(dev, kind, B, V):
    """K6, K8 and K10 against their plain versions, step-indexed and sliced;
    at B = 1 and 31 the first group is the last and partial."""
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
            assert (got[2][:, -1] == 0).all()  # padded; at B = 1 also the first locus
            assert B == 1 or (got[2][:, 0] == 1).all()
        assert _rel(got[0], ref[0]) < 1e-4 and _rel(got[1], ref[1]) < 1e-4
        assert all(torch.equal(x, y) for x, y in zip(sliced, got))


RC_SCANS = {  # kind -> (pack, scan, plain scan, row sections, uniform slots, discrete outputs)
    "rcpi": (gibbs_kernels.rcpi_block_pack, gibbs_kernels.rcpi_block_scan_v,
             gibbs_kernels.rcpi_block_scan_v_plain, 8, lambda A, K: [2, 3], (2, 3)),
    "rcplus": (gibbs_kernels.rcplus_block_pack, gibbs_kernels.rcplus_block_scan_v,
               gibbs_kernels.rcplus_block_scan_v_plain, 6,
               lambda A, K: [8 + a * K for a in range(A)], (2, 3, 5)),
}


def _rc_inputs(dev, kind, T, V, B, A, K, seed):
    """Step-indexed Gram blocks with a diagonal near 30 and coefficient rows
    from the port's own pack: the first annotation on every locus and the
    others on about half, a null first class, the last three loci of every
    chain padded and the whole last chain padded when V > 2."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    m = min(2 * B, 256)
    a = randn(T, V, B, m)
    gram = (torch.einsum("tvbn,tvcn->tbvc", a, a) * (30.0 / m)).contiguous()
    p = V * B
    mask = torch.ones(V, B, dtype=torch.bool, device=dev)
    mask[:, -3:] = False
    if V > 2:
        mask[-1] = False
    mask = mask.reshape(-1)
    anz = rand(p, A) < 0.5
    anz[:, 0] = True
    anz &= mask[:, None]
    varc = (0.5 + 1.5 * rand(A, 1)) * torch.cat([torch.zeros(1, device=dev), 1e-3 + 0.1 * rand(K - 1)])
    common = dict(beta_old=0.1 * randn(p) * mask, mpm=torch.einsum("bvb->vb", gram[0]).reshape(-1) * mask,
                  lss=rand(p), rss=0.1 * randn(p), mask=mask, varc=varc,
                  logpi=torch.log_softmax(randn(A, K), dim=-1), ive=torch.tensor(0.7, device=dev),
                  var_e=torch.tensor(1 / 0.7, device=dev))
    if kind == "rcpi":
        aprob = anz / anz.sum(-1, keepdim=True).clamp(min=1)
        args = dict(z=randn(p), ua=rand(p), uv=rand(p),
                    g1=torch._standard_gamma(anz.float().clamp(min=1e-6), generator=g),
                    g2=torch._standard_gamma(anz.float() + 1.0, generator=g), aprob=aprob, anz=anz)
    else:
        args = dict(z=randn(p, A), ua=rand(p, A), anz=anz)
    pk = RC_SCANS[kind][0](**args, **common).reshape(V, B, -1).contiguous()
    pk[:, :, 0] += 5.0 * randn(V, B)
    return gram, pk, g


def _keep_off_cdf_edges(pk, plain, slots, discrete, gen, margin=1e-4):
    """Redraw uniforms until the plain scan gives the same discrete outputs
    with every uniform lowered and raised by `margin`: then none lies
    within the margin of a CDF edge, and a rounding difference cannot flip
    a draw."""
    V, B, _ = pk.shape
    for _ in range(30):
        ref = plain(pk)
        near = torch.zeros(V, B, dtype=torch.bool, device=pk.device)
        for d in (-margin, margin):
            moved = pk.clone()
            moved[:, :, slots] += d
            for i in discrete:
                near |= (plain(moved)[i] != ref[i]).reshape(V, B, -1).any(-1)
        if not near.any():
            return ref
        fresh = torch.rand((V, B, len(slots)), generator=gen, device=pk.device)
        pk[:, :, slots] = torch.where(near[..., None], fresh, pk[:, :, slots])
    raise AssertionError("could not keep the uniforms away from the CDF edges")


@pytest.mark.parametrize("V,B,A,K", [
    (1, 8, 3, 3),  # a single chain (K11, K13), narrower than a warp
    (3, 33, 1, 4),  # one annotation, B not a multiple of 32, one chain all padding
    (5, 64, 2, 16),  # K = 16, once the most that K3 took
    (2, 256, 8, 4),  # a chain's rcpi rows (8 + 8AK floats) exceed shared memory
    (2, 256, 10, 4),  # a chain's rcplus rows (8 + 6AK floats) too
    (96, 256, 3, 3),  # the main path's shape
    (1, 1024, 2, 3),  # the widest block
    (2, 64, 1, 1),  # one annotation, one class: nothing to draw
    (2, 40, 11, 3),  # A * K = 33, one pair past a warp: the rule on one thread
    (1, 256, 16, 4),  # A * K = 64
])
@pytest.mark.parametrize("kind", ["rcpi", "rcplus"])
def test_rc_scan_kernels_match_plain(dev, kind, V, B, A, K):
    """K12 and K14 against their plain versions, step-indexed and sliced.
    The kernels read each locus's coefficients from device memory, so a
    chain's rows need not fit shared memory."""
    _, scan, plain_fn, sections, slots, discrete = RC_SCANS[kind]
    T = 2
    gram, pk, gen = _rc_inputs(dev, kind, T, V, B, A, K, V * 10_000 + B + A + K)
    if (kind, A) in {("rcpi", 8), ("rcplus", 10)}:
        assert 4 * B * (8 + sections * A * K) > gibbs_kernels.SMEM_BYTES
    for t in range(T):
        ref = _keep_off_cdf_edges(pk, lambda p: plain_fn(gram[t], p, A, K), slots(A, K), discrete, gen)
        before = _cuda.LAUNCHES[f"{kind}_block_scan_v"]
        got = scan((gram, t), pk, A, K)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[f"{kind}_block_scan_v"] == before + 1
        for i, (x, r) in enumerate(zip(got, ref)):
            if i in discrete:
                assert torch.equal(x, r), f"output {i}"
            else:
                assert torch.isfinite(x).all() and _rel(x, r) < 1e-4, f"output {i}"
        # padded loci: beta 0 and every discrete output 0
        assert (got[0][:, -3:] == 0).all() and all((got[i][:, -3:] == 0).all() for i in discrete)
        if V > 2:
            assert (got[0][-1] == 0).all() and (got[2][-1] == 0).all()
        sliced = scan(gram[t].contiguous(), pk, A, K)
        assert all(torch.equal(x, y) for x, y in zip(sliced, got))


@pytest.mark.parametrize("V,B,A,K", [(96, 256, 3, 3), (3, 100, 8, 4), (2, 40, 11, 3)])
@pytest.mark.parametrize("kind", ["rcpi", "rcplus"])
def test_rc_scan_kernels_give_the_same_bits_twice(dev, kind, V, B, A, K):
    """Every sum in K12 and K14 has a fixed order and nothing is atomic: two
    launches on the same inputs give bit-identical outputs, with the rule on
    a warp (A * K <= 32) and on one thread."""
    scan = RC_SCANS[kind][1]
    gram, pk, _ = _rc_inputs(dev, kind, 1, V, B, A, K, 17 + B)
    first = scan((gram, 0), pk, A, K)
    torch.cuda.synchronize()
    for _ in range(3):
        again = scan((gram, 0), pk, A, K)
        assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert all(torch.isfinite(x).all() for x in first)


@pytest.mark.parametrize("kind,V,B,K", [
    ("r", 96, 256, 4), ("r", 3, 100, 20), ("r", 2, 64, 40),
    ("bc_w", 96, 256, 0), ("bc_w", 2, 1024, 0),
    ("gauss", 96, 256, 0), ("gauss", 2, 1024, 0), ("gauss", 3, 33, 0),
    ("bc", 96, 256, 0), ("bc", 2, 1024, 0), ("bc", 3, 33, 0),
])
def test_scan_kernels_give_the_same_bits_twice(dev, kind, V, B, K):
    """K3 (in one lane's registers, and on one thread at K = 20 and 40), K10 (two
    Grams; at B = 1,024 the instance whose prefetched rows spill), K6 and K8
    (at B = 33 the 4-byte loads and a partial group): two launches on the
    same inputs give bit-identical outputs."""
    if kind == "r":
        gram, pk, _ = _r_inputs(dev, 1, V, B, K, 17 + B)

        def run():
            return gibbs_kernels.r_block_scan_v((gram, 0), pk, K)
    else:
        gram, graw, pk = _scan8_inputs(dev, 1, V, B, 17 + B, kind)

        def run():
            if kind == "gauss":
                return gibbs_kernels.gauss_block_scan_v((gram, 0), pk)
            if kind == "bc":
                return gibbs_kernels.bc_block_scan_v((gram, 0), pk)
            return gibbs_kernels.bc_block_scan_wv((gram, 0), (graw, 0), pk)
    first = run()
    torch.cuda.synchronize()
    for _ in range(3):
        again = run()
        assert all(torch.equal(x, y) for x, y in zip(first, again))
    assert all(torch.isfinite(x).all() for x in first)


def test_rcpi_scan_kernel_clamps_the_annotation_draw(dev):
    """A uniform above the annotation CDF's last entry selects the last
    annotation, with every output finite, as the plain version does."""
    V, B, A, K = 2, 16, 3, 3
    gram, pk, _ = _rc_inputs(dev, "rcpi", 1, V, B, A, K, 11)
    pk[..., 2] = 2.0
    got = gibbs_kernels.rcpi_block_scan_v((gram, 0), pk, A, K)
    ref = gibbs_kernels.rcpi_block_scan_v_plain(gram[0], pk, A, K)
    on = pk[..., 4] != 0
    assert (got[3][on] == A).all() and (got[3][~on] == 0).all()
    assert torch.equal(got[3], ref[3]) and all(torch.isfinite(x).all() for x in got)


def test_rc_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    gram = torch.zeros(1, 8, 2, 8, device=dev)
    with pytest.raises(ValueError, match="A >= 1 and K >= 1"):
        gibbs_kernels.rcpi_block_scan_v((gram, 0), torch.zeros(2, 8, 8, device=dev), 0, 3)
    with pytest.raises(ValueError, match="two coefficient rows exceed shared memory"):
        gibbs_kernels.rcpi_block_scan_v((gram, 0), torch.zeros(2, 8, 8 + 8 * 8000, device=dev), 500, 16)
    with pytest.raises(ValueError, match="pk must be"):
        gibbs_kernels.rcplus_block_scan_v((gram, 0), torch.zeros(2, 8, 8 + 8 * 6, device=dev), 2, 3)
    with pytest.raises(ValueError, match="float32"):
        gibbs_kernels.rcplus_block_scan_v((gram, 0),
                                          torch.zeros(2, 8, 8 + 6 * 6, dtype=torch.float64, device=dev), 2, 3)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    pk = torch.zeros(4, 128, dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="float32 or float64"):
        pack2.matvec(pk, torch.zeros(4, 128, dtype=torch.float16, device=dev))
    with pytest.raises(ValueError, match="float32 or float64"):
        pack2.rank_update(pk, torch.zeros(4, dtype=torch.float16, device=dev))
    with pytest.raises(ValueError, match="one CUDA device"):
        pack2.rank_update(pk, torch.zeros(4))
    with pytest.raises(ValueError, match="out of range"):
        pack2.matvec_step(pk, 1, torch.zeros(4, 128, device=dev), 4)
    gram = torch.zeros(1, 8, 2, 8, device=dev)
    with pytest.raises(ValueError, match="pk must be"):
        gibbs_kernels.r_block_scan_v((gram, 0), torch.zeros(2, 8, 12, device=dev), 2)
    with pytest.raises(ValueError, match="K >= 1"):
        gibbs_kernels.r_block_scan_v((gram, 0), torch.zeros(2, 8, 8, device=dev), 0)
    with pytest.raises(ValueError, match="two coefficient rows exceed shared memory"):
        gibbs_kernels.r_block_scan_v((gram, 0), torch.zeros(2, 8, 8 + 4 * 6600, device=dev), 6600)
    # K3 and K8 take float64 gram and pk together, not one of each; K10 both Grams too
    with pytest.raises(ValueError, match="float32, or both float64"):
        gibbs_kernels.r_block_scan_v((gram, 0), torch.zeros(2, 8, 12, dtype=torch.float64, device=dev), 1)
    with pytest.raises(ValueError, match="bc_block_scan_v: .*float32, or both float64"):
        gibbs_kernels.bc_block_scan_v((gram, 0), torch.zeros(2, 8, 8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="bc_block_scan_wv: .*float32, or both float64"):
        gibbs_kernels.bc_block_scan_wv((gram.double(), 0), (gram, 0),
                                       torch.zeros(2, 8, 8, dtype=torch.float64, device=dev))
    # K12 and K14 take float32 or float64 gram and pk, not one of each nor float16
    pk_rc = torch.zeros(2, 8, 8 + 8 * 6, dtype=torch.float64, device=dev)
    with pytest.raises(ValueError, match="rcpi_block_scan_v: .*float32, or both float64"):
        gibbs_kernels.rcpi_block_scan_v((gram, 0), pk_rc, 2, 3)
    with pytest.raises(ValueError, match="rcplus_block_scan_v: .*float32, or both float64"):
        gibbs_kernels.rcplus_block_scan_v((gram.double(), 0), pk_rc[..., :8 + 6 * 6].float().contiguous(), 2, 3)
    with pytest.raises(ValueError, match="rcpi_block_scan_v: .*float32, or both float64"):
        gibbs_kernels.rcpi_block_scan_v((gram.half(), 0), pk_rc.half(), 2, 3)


N_SMALL, P_SMALL = 300, 512


def _card_and_cpu_chains(dev, prior, weighted=False):
    """A short chain through assemble / make_sweep on the card and the same
    chain on the CPU in float32 from the same draws."""
    rng = np.random.default_rng(3)
    n, p = N_SMALL, P_SMALL
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


def _annot():
    return np.random.default_rng(6).integers(0, 2, (P_SMALL, 3)) | np.array([1, 0, 0])


@pytest.mark.parametrize("method", ["BayesRCpi", "BayesRCplus", "BayesLV"])
def test_annotation_and_lv_sweeps_on_card_match_plain_chain(dev, method):
    """BayesRCpi (K12), BayesRCplus (K14) and BayesLV (K6) through assemble /
    make_sweep on the card, against the CPU chain from the same draws."""
    if method == "BayesLV":
        prior, scan = ngt.BayesLV(0.01, np.random.default_rng(7).normal(0, 1, (P_SMALL, 3)), 0.01,
                                  estimateVarZeta=True), "gauss_block_scan_v"
    else:
        prior = getattr(ngt, method)([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, _annot(),
                                     estimatePi=True)
        scan = {"BayesRCpi": "rcpi_block_scan_v", "BayesRCplus": "rcplus_block_scan_v"}[method]
    before = dict(_cuda.LAUNCHES)
    k, c = _card_and_cpu_chains(dev, prior)
    T = P_SMALL // 32 // 4
    assert _cuda.LAUNCHES[scan] - before[scan] == 3 * T
    assert _cuda.LAUNCHES["pack2_matvec"] - before["pack2_matvec"] == 3 * T
    km, cm = k.markers[0], c.markers[0]
    assert torch.equal(km.delta.cpu(), cm.delta)
    assert _rel(km.beta.cpu(), cm.beta) < 1e-3 and _rel(k.ycorr.cpu(), c.ycorr) < 1e-4
    assert _rel(km.var_beta.cpu(), cm.var_beta) < 1e-3
    if method == "BayesRCpi":
        assert torch.equal(km.annot_cat.cpu(), cm.annot_cat)
        assert _rel(km.annot_prob.cpu(), cm.annot_prob) < 1e-4
    if method != "BayesLV":
        assert _rel(km.pi_hat.cpu(), cm.pi_hat) < 1e-4
    else:
        assert _rel(km.lv_c.cpu(), cm.lv_c) < 1e-3 and (km.var_beta[:P_SMALL] > 0).all()


# ------------------------------------------------------------ the ladder's kernels


def _ladder_inputs(dev, rows, q, T, seed=0):
    from nextgp_tpu_torch import micro

    return micro.step_inputs(rows, q, T, dev, seed)


@pytest.mark.parametrize("rows,q,T", [(1, 16, 1), (7, 48, 3), (130, 256, 2), (1000, 12_544, 2),
                                      (2051, 2560, 1)])
def test_ladder_step_kernels_match_plain(dev, rows, q, T):
    """read_step (exact) and fused_step on odd row counts, q = 16, rows that
    are no multiple of a warp's four, T = 1 (both jobs on one step), a
    50k-individual width; fused dy bit-identical across two runs."""
    from nextgp_tpu_torch.ops import micro as mk

    pk_all, u, y4 = _ladder_inputs(dev, rows, q, T, seed=rows)
    before = dict(_cuda.LAUNCHES)
    for t in range(T):
        assert torch.equal(mk.read_step(pk_all, t, rows), mk.read_step_plain(pk_all, t, rows))
        for blocks in (1, 3, 1000):
            assert torch.equal(mk.read_step(pk_all, t, rows, blocks), mk.read_step_plain(pk_all, t, rows))
        t1 = (t + 1) % T
        r0, dy = mk.fused_step(pk_all, t, t1, u, y4)
        ref_r0, ref_dy = mk.fused_step_plain(pk_all, t, t1, u, y4)
        assert _rel(r0, ref_r0) < 1e-5 and _rel(dy, ref_dy) < 1e-5
        again = mk.fused_step(pk_all, t, t1, u, y4)
        assert torch.equal(r0, again[0]) and torch.equal(dy, again[1])
        # the fused gather sums in K1's order past its stage, the scatter in K2's slices' order
        assert _rel(r0, pack2.matvec_step(pk_all, t1, y4, rows)) < 1e-5
    assert _cuda.LAUNCHES["read_step"] == before["read_step"] + 4 * T
    assert _cuda.LAUNCHES["fused_step"] == before["fused_step"] + 2 * T


PACK2_EDGES = [(1, 16), (3, 48), (5, 528), (7, 2560), (4095, 496), (4097, 16), (511, 12_544),
               (513, 2560), (1025, 25_088)]


@pytest.mark.parametrize("rows,q", PACK2_EDGES)
def test_fused_step_has_k1_and_k2_bits_at_their_edges(dev, rows, q):
    """The fused step runs K1's and K2's bodies: at K1's and K2's edge shapes
    (test_pack2_kernels_at_their_edges), gathering step 2 and scattering
    step 1 of three, r0 has K1's bits and dy K2's, twice, on its default
    split and on splits of one gather block and of more gather blocks than
    row groups; one launch a call."""
    from nextgp_tpu_torch.ops import micro as mk

    g = torch.Generator(device=dev).manual_seed(rows * 7 + q)
    pk = torch.randint(0, 256, (3 * rows, q), generator=g, device=dev, dtype=torch.uint8)
    y4 = torch.randn((4, q), generator=g, device=dev)
    u = torch.randn(rows, generator=g, device=dev)
    k1, k2 = pack2.matvec_step(pk, 2, y4, rows), pack2.rank_update_step(pk, 1, u)
    for gather in (None, None, 1, rows + 7):
        before = _cuda.LAUNCHES["fused_step"]
        r0, dy = mk.fused_step(pk, 1, 2, u, y4, gather)
        assert _cuda.LAUNCHES["fused_step"] == before + 1
        assert torch.equal(r0, k1) and torch.equal(dy, k2), gather


def test_fused_step_tickets_are_its_own_and_reset(dev):
    """The fused step closes K2's slices with tickets of its own (not K2's):
    after each launch every one of them is 0 again, K2's are untouched, and
    a second launch on other inputs gives K2's bits again."""
    from nextgp_tpu_torch.ops import micro as mk

    rows, q = 1537, 2560  # four slices over five tiles
    g = torch.Generator(device=dev).manual_seed(11)
    pk = torch.randint(0, 256, (2 * rows, q), generator=g, device=dev, dtype=torch.uint8)
    y4 = torch.randn((4, q), generator=g, device=dev)
    for t, t1 in ((0, 1), (1, 0)):
        u = torch.randn(rows, generator=g, device=dev)
        dy = mk.fused_step(pk, t, t1, u, y4)[1]
        assert torch.equal(dy, pack2.rank_update_step(pk, t, u))
        key = (pk.device, _cuda.stream_of(pk))
        assert mk._TICKETS[key] is not pack2._TICKETS[key]
        assert int(mk._TICKETS[key].abs().sum()) == 0 and int(pack2._TICKETS[key].abs().sum()) == 0


@pytest.mark.parametrize("rows,q", [(1, 16), (7, 48), (130, 256), (515, 12_544), (1030, 4100)])
def test_gather_width_kernels_match_plain_and_k1(dev, rows, q):
    """S1a and S1b against their plain versions and K1's: rows of 1, 7 and
    1,030 (not a multiple of the warp's four), and word counts past a whole
    pass (q = 4,100: 4,100 bytes and 1,025 words, neither a multiple of 32)."""
    from nextgp_tpu_torch.ops import micro as mk

    g = torch.Generator(device=dev).manual_seed(q)
    pk = torch.randint(0, 256, (rows, q), generator=g, device=dev, dtype=torch.uint8)
    y4 = torch.randn((4, q), generator=g, device=dev)
    y16, pk32 = mk.y_words(y4, 4), pk.view(torch.int32)
    before = dict(_cuda.LAUNCHES)
    ref = pack2.matvec_plain(pk, y4)
    for out, plain in ((mk.gather_width(pk, y4), mk.gather_width_plain(pk, y4)),
                       (mk.gather_width(pk32, y16), mk.gather_width_plain(pk32, y16))):
        assert _rel(out, plain) < 1e-5 and _rel(out, ref) < 1e-5
    assert _cuda.LAUNCHES["gather_width1"] == before["gather_width1"] + 1
    assert _cuda.LAUNCHES["gather_width4"] == before["gather_width4"] + 1


@pytest.mark.parametrize("width", [1, 4])
def test_gather_width_past_the_old_shared_memory_cap(dev, width):
    """n = 100,000 (q = 25,088): 16 q bytes of y are more than a block's
    shared memory, where S1 staged y until it took K1's body. Within 1e-5 of
    scale of its plain version and of K1's, the same bits from a second
    launch and on grids of 1 and 7 blocks, one launch counted a call."""
    from nextgp_tpu_torch.ops import micro as mk

    n, rows = 100_000, 1000
    q = pack2.packed_q(n)
    assert q == 25_088 and 16 * q > gibbs_kernels.SMEM_BYTES
    g = torch.Generator(device=dev).manual_seed(width)
    pk = torch.randint(0, 256, (rows, q), generator=g, device=dev, dtype=torch.uint8)
    y4 = torch.randn((4, q), generator=g, device=dev)
    pkw, yw = (pk, y4) if width == 1 else (pk.view(torch.int32), mk.y_words(y4, 4))
    before = _cuda.LAUNCHES[f"gather_width{width}"]
    out = mk.gather_width(pkw, yw)
    assert _cuda.LAUNCHES[f"gather_width{width}"] == before + 1
    assert _rel(out, mk.gather_width_plain(pkw, yw)) < 1e-5
    assert _rel(out, pack2.matvec_plain(pk, y4)) < 1e-5
    for blocks in (0, 1, 7):
        assert torch.equal(out, mk.gather_width(pkw, yw, blocks=blocks))


@pytest.mark.parametrize("rows,n", [(1, 16), (7, 48), (130, 1024), (2051, 10_240)])
def test_dense_kernels_match_plain(dev, rows, n):
    from nextgp_tpu_torch.ops import micro as mk

    g = torch.Generator(device=dev).manual_seed(n)
    mt = torch.randint(-3, 4, (rows, n), generator=g, device=dev, dtype=torch.int8)  # signed too
    y, u = torch.randn(n, generator=g, device=dev), torch.randn(rows, generator=g, device=dev)
    before = dict(_cuda.LAUNCHES)
    assert _rel(mk.dense_gather(mt, y), mk.dense_gather_plain(mt, y)) < 1e-5
    out = mk.dense_scatter(mt, u)
    assert _rel(out, mk.dense_scatter_plain(mt, u)) < 1e-5
    assert torch.equal(out, mk.dense_scatter(mt, u))
    assert _cuda.LAUNCHES["dense_gather"] == before["dense_gather"] + 1
    assert _cuda.LAUNCHES["dense_scatter"] == before["dense_scatter"] + 2


def test_ladder_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    from nextgp_tpu_torch.ops import micro as mk

    pk = torch.zeros(8, 64, dtype=torch.uint8, device=dev)
    y4, u = torch.zeros(4, 64, device=dev), torch.zeros(4, device=dev)
    with pytest.raises(ValueError, match="out of range"):
        mk.read_step(pk, 2, 4)
    with pytest.raises(ValueError, match="multiple of 16"):
        mk.read_step(pk[:, :40].contiguous(), 0, 4)
    with pytest.raises(ValueError, match="blocks must be"):
        mk.read_step(pk, 0, 4, blocks=0)
    with pytest.raises(ValueError, match="out of range"):
        mk.fused_step(pk, 0, 2, u, y4)
    with pytest.raises(ValueError, match="float32"):
        mk.fused_step(pk, 0, 1, u.double(), y4)
    with pytest.raises(ValueError, match="float32"):
        mk.gather_width(pk, torch.zeros(16, 64, device=dev))  # y16 with byte loads
    with pytest.raises(ValueError, match="uint8 or int32"):
        mk.gather_width(pk.to(torch.int16), y4)
    with pytest.raises(ValueError, match="blocks must be"):
        mk.gather_width(pk, y4, blocks=-1)
    mt = torch.zeros(8, 64, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="int8"):
        mk.dense_gather(pk, torch.zeros(64, device=dev))
    with pytest.raises(ValueError, match="float32"):
        mk.dense_scatter(mt, torch.zeros(7, device=dev))
    with pytest.raises(ValueError, match="exceed a block's shared memory"):
        mk.dense_gather(torch.zeros(2, 64_000, dtype=torch.int8, device=dev),
                        torch.zeros(64_000, device=dev))


# ------------------------------------------------------------ keyed draws and replayed chains

GAMMA_SHAPES = (0.5, 1.0, 3.0, 5000.0, 25_000.0)


def check_keyed_rng(dev, n_unit, n_gamma, sweep=7, tail=(4, 0, 4, 1)):
    """keyed_rng against its plain version on the card: uniforms the same
    bits, normals within 1e-6 of their scale, gammas within 1e-5 relative
    where both accepted at the same attempt, the share of elements whose
    accepting attempt differs at most 1e-4, two launches the same bits.
    Returns the numbers that chip_smoke.py prints."""
    from nextgp_tpu_torch.engine import rng as R

    h0 = R._splitmix64(5)
    counter = torch.tensor(sweep, dtype=torch.int64, device=dev)
    alpha = torch.tensor(GAMMA_SHAPES, device=dev).repeat_interleave(n_gamma)
    out = {}
    for kind, n in ((R.UNIFORM, n_unit), (R.NORMAL, n_unit), (R.GAMMA, alpha.numel())):
        a = alpha if kind == R.GAMMA else None
        got, att = R.keyed_draw(kind, h0, counter, tail, n, torch.float32, a, iters=True)
        again = R.keyed_draw(kind, h0, counter, tail, n, torch.float32, a)
        ref, ref_att = R.keyed_draw_plain(kind, h0, counter, tail, n, torch.float32, a, iters=True)
        assert torch.equal(got, again)
        if kind == R.UNIFORM:
            assert torch.equal(got, ref)
            out["uniform"] = 0.0
        elif kind == R.NORMAL:
            err = (got - ref).abs().max().item()
            assert err <= 1e-6 * ref.abs().max().item()
            out["normal"] = err
        else:
            same = att == ref_att
            assert (att >= 0).all() and torch.isfinite(got).all()
            rel = ((got - ref).abs() / ref.abs())[same].max().item()
            share = 1.0 - same.float().mean().item()
            assert rel <= 1e-5 and share <= 1e-4
            out["gamma"], out["gamma_attempts_differ"] = rel, share
    return out


def test_keyed_rng_matches_plain(dev):
    before = _cuda.LAUNCHES["keyed_rng"]
    check_keyed_rng(dev, 49_152, 4096)
    assert _cuda.LAUNCHES["keyed_rng"] - before == 6


@pytest.mark.parametrize("n", [1, 4, 31, 33, 257, 49_152])
def test_keyed_rng_matches_plain_at_the_main_path_sizes(dev, n):
    """R1 at a draw of one and four elements (the intercept, varE's and the
    class variance's chi2, the Dirichlet), either side of a warp, past two
    blocks and at p_pad: uniforms the plain version's bits, normals within
    1e-6 of scale, gammas (shapes from 0.5 to 25,000 in turn) within 1e-5
    where the accepting attempt agrees, two launches the same bits."""
    from nextgp_tpu_torch.engine import rng as R

    counter = torch.tensor(11, dtype=torch.int64, device=dev)
    h0, tail = R._splitmix64(3), (4, 0, 4, 1)
    alpha = torch.tensor(GAMMA_SHAPES, device=dev).repeat(n)[:n].contiguous()
    for kind in (R.UNIFORM, R.NORMAL, R.GAMMA):
        a = alpha if kind == R.GAMMA else None
        got, att = R.keyed_draw(kind, h0, counter, tail, n, torch.float32, a, iters=True)
        ref, ref_att = R.keyed_draw_plain(kind, h0, counter, tail, n, torch.float32, a, iters=True)
        assert torch.equal(got, R.keyed_draw(kind, h0, counter, tail, n, torch.float32, a))
        if kind == R.UNIFORM:
            assert torch.equal(got, ref)
        elif kind == R.NORMAL:
            assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()
        else:
            same = att == ref_att
            assert (att >= 0).all() and 1.0 - same.float().mean().item() <= 1e-4
            assert (((got - ref).abs() / ref.abs())[same] <= 1e-5).all()


@pytest.mark.parametrize("shape", [1e-6, 0.5, 1.0, 25_000.0])
def test_keyed_rng_gamma_at_its_shape_edges(dev, shape):
    """Gammas at a shape of 1e-6 (clamped at the smallest normal float),
    0.5 (boosted), 1 and 25,000, 20,000 draws each, against the plain version
    under phase 7a's tolerances; and a shape that is NaN, 0, negative or
    infinite in any lane of a warp gives NaN and no attempt, its neighbours
    their plain values."""
    from nextgp_tpu_torch.engine import rng as R

    counter = torch.tensor(4, dtype=torch.int64, device=dev)
    h0, tail = R._splitmix64(8), (2, 0, 2, 1)
    n = 20_000
    alpha = torch.full((n,), shape, device=dev)
    alpha[5::97] = torch.tensor([float("nan"), 0.0, -1.0, float("inf")], device=dev).repeat(52)[
        :alpha[5::97].numel()]
    got, att = R.keyed_draw(R.GAMMA, h0, counter, tail, n, torch.float32, alpha, iters=True)
    ref, ref_att = R.keyed_draw_plain(R.GAMMA, h0, counter, tail, n, torch.float32, alpha, iters=True)
    bad = ~(torch.isfinite(alpha) & (alpha > 0))
    assert bad.sum() == 207 and got[bad].isnan().all() and (att[bad] == -1).all()
    same = (att == ref_att) & ~bad
    assert (att[~bad] >= 0).all() and 1.0 - same[~bad].float().mean().item() <= 1e-4
    assert (((got - ref).abs() / ref.abs())[same] <= 1e-5).all()
    assert (got[~bad] >= torch.finfo(torch.float32).tiny).all()


def test_keyed_rng_reads_its_counter_at_replay(dev):
    """A draw captured in a CUDA graph reads the sweep counter when the
    graph replays: after the counter moves, the replay gives the eager draw
    at the new sweep."""
    s = ngt.KeyedStream(3, dev, torch.float32)
    counter = torch.zeros((), dtype=torch.int64, device=dev)
    site = ngt.Site(0, 4, 2, ((4, 1),), counter=counter)
    s.normal(site, (1000,))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        s.normal(site, (1000,))
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        drawn = s.normal(site, (1000,))
    for sweep in (5, 6):
        counter.fill_(sweep)
        graph.replay()
        assert torch.equal(drawn, s.normal(ngt.Site(sweep, 4, 2, ((4, 1),)), (1000,)))


def _small_spec(method, n=N_SMALL, p=P_SMALL):
    rng = np.random.default_rng(8)
    g = rng.integers(0, 3, (n, p))
    y = (g - g.mean(0)) @ rng.normal(0, 0.1, p) + rng.normal(0, 1, n)
    rc = ([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, _annot())
    prior = {"BayesR": lambda: ngt.BayesR([0.9, 0.05, 0.03, 0.02], [0.0, 1e-4, 1e-3, 1e-2], 1.0,
                                          estimatePi=True),
             "BayesB": lambda: ngt.BayesB(0.1, 0.05, estimatePi=True),
             "BayesC": lambda: ngt.BayesC(0.1, 0.05, estimatePi=True),
             "BayesPR": lambda: ngt.BayesPR(32, 0.05),
             "BayesRCpi": lambda: ngt.BayesRCpi(*rc, estimatePi=True),
             "BayesRCplus": lambda: ngt.BayesRCplus(*rc, estimatePi=True),
             "BayesLV": lambda: ngt.BayesLV(0.01, rng.normal(0, 1, (p, 3)), 0.01,
                                            estimateVarZeta=True)}[method]()
    chr_ids = (np.arange(p) // 100) % 2 + 1
    return ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))],
                         markers=[ngt.MarkerTerm("M", ngt.from_array(g, chr_ids=chr_ids), prior)],
                         block_size=32)


@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("method", ["BayesR", "BayesB", "BayesC", "BayesPR", "BayesRCpi",
                                    "BayesRCplus", "BayesLV"])
def test_replayed_chain_equals_eager_chain(dev, method, V):
    """make_scan_sampler's graph replays against eager sweeps of the same
    KeyedStream from the same state: the same bits in every draw and in the
    final ycorr, and the same sweep index on the host and on the card
    (BayesPR with regions of 32 loci: its region sums inside the graph)."""
    plan, st0 = ngt.assemble(_small_spec(method), device=dev, vshards=V)
    stream = ngt.KeyedStream(21, dev, torch.float32)
    st, draws = ngt.make_scan_sampler(plan, 3, 2)(st0, stream)
    sweep, eager, kept = ngt.make_sweep(plan), st0, []
    for _ in range(3):
        for _ in range(2):
            eager = sweep(eager, stream)
        kept.append(ngt.collect_sample(eager, plan))
    for name, d in draws.items():
        assert d.is_cuda and torch.equal(d, torch.stack([k[name] for k in kept])), name
    assert torch.equal(st.ycorr, eager.ycorr)
    assert st.sweep_index == eager.sweep_index == 6 and int(st.sweep_counter) == 6
    # the runner's replayed form gives the same chain
    run_thin, loop = ngt.make_chain_runner(plan, 2), st0
    for k in kept:
        loop, sample = run_thin(loop, stream)
        assert all(torch.equal(sample[name], k[name]) for name in k)
    assert torch.equal(loop.ycorr, eager.ycorr)


@pytest.mark.parametrize("stream_cls", ["PhiloxStream", "HostStream"])
def test_scan_sampler_refuses_streams_it_cannot_capture(dev, stream_cls):
    """On the card only a KeyedStream can be captured: any other stream
    raises, naming it, and nothing falls back to eager sweeps."""
    from nextgp_tpu_torch.engine import rng as R

    plan, st = ngt.assemble(_small_spec("BayesR"), device=dev, vshards=4)
    stream = getattr(R, stream_cls)(1, dev, torch.float32)
    with pytest.raises(TypeError, match=stream_cls):
        ngt.make_scan_sampler(plan, 2, 2)(st, stream)


# ------------------------------------------------------------------ RE1, the level scan


def _level_inputs(q, dev, seed=0):
    """A symmetric positive-definite structure with unit-scale off-diagonal
    coupling, and a first sweep's vectors."""
    g = torch.Generator(device=dev).manual_seed(seed)
    m = torch.randn(q, q, generator=g, device=dev) / q ** 0.5
    ivstr = (m @ m.T + torch.eye(q, device=dev)).contiguous()
    yi, z, u = (torch.randn(q, generator=g, device=dev) for _ in range(3))
    zpz = torch.rand(q, generator=g, device=dev) * 3
    return ivstr, yi, zpz, z, u, torch.tensor(1.7, device=dev), torch.tensor(0.6, device=dev)


# RE1's edges: one level; a group of 32 levels, one either side; 32 (L + 1)
# = 192 levels (L = 5), the most without an owner's far sums, one either
# side; the old tile of 1,024 and one past it; q = 2,049 and 3,001; 25,000
# levels, past one row block per owner warp on a card of 132 SMs (so an
# owner interleaves two); q not a multiple of 4 (4-byte copies of A) at 31,
# 33, 191, 193, 1,025, 2,049 and 3,001.
LEVEL_QS = [1, 31, 32, 33, 191, 192, 193, 1000, 1024, 1025, 2049, 3001, 25_000]


@pytest.mark.parametrize("q", LEVEL_QS)
def test_level_scan_matches_plain(dev, q):
    """RE1 at its group, look-ahead and owner edges (LEVEL_QS): within 1e-4
    of u's scale of the plain version, the same bits from two launches, one
    count per call."""
    from nextgp_tpu_torch.ops import random_scan

    args = _level_inputs(q, dev, q)
    before = _cuda.LAUNCHES["level_scan"]
    out = random_scan.level_scan(*args)
    ref = random_scan.level_scan_plain(*args)
    assert _rel(out, ref) < 1e-4
    assert torch.equal(out, random_scan.level_scan(*args))
    assert _cuda.LAUNCHES["level_scan"] == before + 2
    assert not torch.equal(out, args[4])  # u itself is left as it was


def test_level_scan_replayed_takes_the_next_sweep(dev):
    """RE1 captured in a CUDA graph with its output copied back into u: each
    replay is the next sweep's scan (the flags are set to 0 inside the
    graph), with the bits of eager calls on the same inputs."""
    from nextgp_tpu_torch.ops import random_scan

    ivstr, yi, zpz, z, u, ive, ivu = _level_inputs(1000, dev, 3)
    eager = [u]
    for _ in range(3):
        eager.append(random_scan.level_scan(ivstr, yi, zpz, z, eager[-1], ive, ivu))
    u_buf = u.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        random_scan.level_scan(ivstr, yi, zpz, z, u_buf, ive, ivu)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        u_buf.copy_(random_scan.level_scan(ivstr, yi, zpz, z, u_buf, ive, ivu))
    u_buf.copy_(u)
    for want in eager[1:]:
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(u_buf, want)


def test_level_scan_refuses_what_it_does_not_take(dev):
    from nextgp_tpu_torch.ops import random_scan

    ivstr, yi, zpz, z, u, ive, ivu = _level_inputs(40, dev)
    with pytest.raises(ValueError, match="float32"):
        random_scan.level_scan(ivstr.double(), yi, zpz, z, u, ive, ivu)
    with pytest.raises(ValueError, match="contiguous"):
        random_scan.level_scan(ivstr.T, yi, zpz, z, u, ive, ivu)
    with pytest.raises(ValueError, match="vectors"):
        random_scan.level_scan(ivstr, yi[:39], zpz, z, u, ive, ivu)


def _random_spec(sampler="scan"):
    from nextgp_tpu_torch.data import pedigree as P

    spec = _small_spec("BayesR")
    n = spec.y.shape[0]
    rng = np.random.default_rng(9)
    ids = [f"a{i}" for i in range(n)]
    sires = [None] * 20 + [ids[rng.integers(0, i)] for i in range(20, n)]
    dams = [None] * 20 + [ids[rng.integers(0, i)] for i in range(20, n)]
    ped = ngt.build_pedigree(ids, sires, dams)
    z = np.zeros((n, n))
    z[np.arange(n), ped.index_of(ids)] = 1.0
    if sampler == "cg":
        idx, val = P.a_inverse_padded(ped)
        sire, dam, dsq = P.a_inverse_factor(ped)
        term = ngt.RandomTerm("A", z, prior=ngt.Random("A", 0.3, sampler="cg"),
                              sparse_struct=dict(iv_idx=idx, iv_val=val, sire=sire, dam=dam,
                                                 dinv_sqrt=dsq))
    else:
        term = ngt.RandomTerm("A", z, prior=ngt.Random("A", 0.3), ivstr=P.a_inverse(ped))
    spec.random = [term]
    return spec


def test_animal_model_replayed_equals_eager(dev):
    """BayesR + an animal effect: the replayed chain (level scan inside the
    graph) has the eager chain's bits; the plain chain on the CPU from the
    same host draws follows the kernel chain."""
    spec = _random_spec()
    plan, st0 = ngt.assemble(spec, device=dev, vshards=4)
    stream = ngt.KeyedStream(23, dev, torch.float32)
    st, draws = ngt.make_scan_sampler(plan, 3, 2)(st0, stream)
    sweep, eager, kept = ngt.make_sweep(plan), st0, []
    for _ in range(3):
        for _ in range(2):
            eager = sweep(eager, stream)
        kept.append(ngt.collect_sample(eager, plan))
    assert {"uA", "varUA"} <= set(draws)
    for name, d in draws.items():
        assert torch.equal(d, torch.stack([k[name] for k in kept])), name
    assert torch.equal(st.ycorr, eager.ycorr)
    chains = []
    for device in (dev, "cpu"):
        plan, st = ngt.assemble(spec, device=device, dtype=torch.float32, vshards=4)
        sweep, draws = ngt.make_sweep(plan), HostStream(4, device, torch.float32)
        for _ in range(3):
            st = sweep(st, draws)
        chains.append(st.random[0].u.cpu())
    assert _rel(*chains) < 1e-3


def _acg_spec():
    """Intercept + a CG animal effect on _random_spec's pedigree, every
    animal recorded (no marker set: its kernels take float32)."""
    spec = _random_spec("cg")
    spec.markers = []
    return spec


def test_cg_term_on_the_card(dev):
    """A CG animal effect on the card, in float64: eager sweeps stop their
    solves by the tolerance, each one CG1 launch, and the replayed scan
    sampler runs the same plan with a KeyedStream."""
    plan, st = ngt.assemble(_acg_spec(), device=dev, dtype=torch.float64, vshards=4)
    sweep, stream = ngt.make_sweep(plan), ngt.PhiloxStream(3, dev, torch.float64)
    before = _cuda.LAUNCHES["cg_solve"]
    for _ in range(3):
        st = sweep(st, stream)
        assert 0 < int(sweep.cg_iterations[0]) < plan.random[0].cg_iters
    assert _cuda.LAUNCHES["cg_solve"] - before == 3
    assert torch.isfinite(st.random[0].u).all() and st.random[0].var_u > 0
    st, draws = ngt.make_scan_sampler(plan, 2, 1)(st, ngt.KeyedStream(1, dev, torch.float64))
    assert torch.isfinite(draws["uA"]).all() and (draws["varUA"] > 0).all()


def _cg_system(kind, dtype, dev, seed=0):
    """A CG sampler's system of one of CG_CASES: the port's plan tables for
    an intercept and a CG term on 60 levels (one level for "one-level"),
    a right-hand side and a start, as cg_solve_sparse's arguments but tol
    and max_iter, on dev in dtype."""
    from nextgp_tpu_torch.data import pedigree as P

    rng = np.random.default_rng(seed)
    if kind == "one-level":
        z_idx, q, weights, ss = np.zeros(5, np.int64), 1, None, None
    else:
        q, n = 60, 90
        z_idx = rng.integers(0, q, n)
        z_idx[rng.uniform(size=n) < 0.1] = -1
        weights = rng.uniform(0.5, 2.0, n) if kind == "weighted" else None
        if kind == "empty-level":
            z_idx[z_idx == 7] = 3
        ss = None
        if kind != "identity":
            ids = [f"a{i}" for i in range(q)]
            sires, dams = [None] * q, [None] * q
            for i in range(q // 5, q):
                s, d = rng.integers(0, i // 2, 2)
                sires[i] = ids[s] if rng.uniform() > 0.1 else None
                dams[i] = ids[d] if s != d and rng.uniform() > 0.1 else None
            ped = ngt.build_pedigree(ids, sires, dams)
            idx, val = P.a_inverse_padded(ped)
            sire, dam, dsq = P.a_inverse_factor(ped)
            ss = dict(iv_idx=idx, iv_val=val, sire=sire, dam=dam, dinv_sqrt=dsq)
    spec = ngt.ModelSpec(
        y=rng.normal(size=z_idx.size), fixed=[ngt.FixedTerm("int", np.ones(z_idx.size))],
        random=[ngt.RandomTerm("a", None, prior=ngt.Random("A" if ss else "I", 0.7, sampler="cg"),
                               z_idx=z_idx, n_levels=q, sparse_struct=ss)],
        residual=None if weights is None else ngt.RandomEffect(weights, 1.3))
    plan, st = ngt.assemble(spec, device="cpu", dtype=torch.float64)
    rp, rs = plan.random[0], st.random[0]

    def to(t):
        return t.to(dev, dtype if t.is_floating_point() else t.dtype)

    return (to(rp.z_diag / 1.3), to(rs.iv_idx), to(rs.iv_val), to(rp.iv_len),
            to(torch.tensor(1 / 0.7, dtype=torch.float64)), to(torch.from_numpy(rng.normal(size=q))),
            to(torch.from_numpy(rng.normal(size=q))))


CG_CASES = ("identity", "pedigree", "weighted", "empty-level", "one-level")


@pytest.mark.parametrize("kind", CG_CASES + ("max-iter",))
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_solve_kernel_matches_plain(dev, dtype, kind):
    """CG1 against its plain version on the same system: the same iteration
    count, x within 1e-10 of its scale in float64 and 1e-5 in float32, and
    the same bits from two launches; "max-iter" is the pedigree system
    stopped after 3 iterations. An iterate CG stops on is up to ~cond * tol
    from the solution, and two solvers that round their sums in other orders
    stop on iterates a fraction of that apart (2.2e-10 of x's scale at the
    default 1e-8 on the empty-level system): float64 holds x where both
    solved to 1e-12, and the counts at 1e-8 and 1e-12. In float32 the default
    1e-8 lies in the residual's rounding noise, where the two can stop an
    iteration apart (31 and 30 on the empty-level system): float32 holds
    both at 1e-4, where the residual crosses its threshold clearly."""
    from nextgp_tpu_torch.ops import cg

    args = _cg_system("pedigree" if kind == "max-iter" else kind, dtype, dev)
    if kind == "max-iter":
        lims = [dict(tol=1e-30, max_iter=3)]
    else:
        lims = [dict(tol=1e-8), dict(tol=1e-12)] if dtype == torch.float64 else [dict(tol=1e-4)]
    for lim in lims:
        before = _cuda.LAUNCHES["cg_solve"]
        x, it, res = cg.cg_solve_sparse(*args, **lim)
        x2, it2, res2 = cg.cg_solve_sparse(*args, **lim)
        assert _cuda.LAUNCHES["cg_solve"] - before == 2
        assert it.is_cuda and it.dtype == torch.int32 and it.shape == ()
        assert torch.equal(x, x2) and torch.equal(it, it2) and torch.equal(res, res2)
        px, pit, pres = cg.cg_solve_sparse_plain(*(t.cpu() for t in args), **lim)
        assert int(it) == int(pit)
        if kind == "max-iter":
            assert int(it) == 3
        else:
            limit = lim["tol"] * args[5].norm().item()
            assert 0 < int(it) < 1000 and float(res) <= limit and float(pres) <= limit
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    assert (x.cpu() - px).abs().max().item() <= tol * px.abs().max().item()


def _wide_cg_system(dtype, dev, kids):
    """A CG sampler's system on a pedigree in which one sire has `kids`
    offspring by as many dams (his A^-1 row 1 + 2 kids entries: 91 past 8 x
    8 at 45; 4,401 at 2,200, more chunks than a round of CG1's threads), so
    that the blocks beside his row own no rows."""
    from nextgp_tpu_torch.data import pedigree as P

    rng = np.random.default_rng(7)
    f = 50 + kids  # founders: sires 0 .. 49, dams 50 .. f - 1
    q = f + kids + 55
    ids = [f"a{i}" for i in range(q)]
    sires, dams = [None] * q, [None] * q
    for i in range(f, q):
        first = i < f + kids
        sires[i] = ids[0] if first else ids[rng.integers(1, 50)]
        dams[i] = ids[50 + (i - f) if first else rng.integers(50, f)]
    ped = ngt.build_pedigree(ids, sires, dams)
    idx, val = P.a_inverse_padded(ped)
    sire, dam, dsq = P.a_inverse_factor(ped)
    z_idx = rng.integers(0, q, q + 100)
    spec = ngt.ModelSpec(y=rng.normal(size=z_idx.size), fixed=[ngt.FixedTerm("int", np.ones(z_idx.size))],
                         random=[ngt.RandomTerm("a", None, prior=ngt.Random("A", 0.7, sampler="cg"),
                                                z_idx=z_idx, n_levels=q,
                                                sparse_struct=dict(iv_idx=idx, iv_val=val, sire=sire,
                                                                   dam=dam, dinv_sqrt=dsq))])
    plan, st = ngt.assemble(spec, device="cpu", dtype=torch.float64)
    rp, rs = plan.random[0], st.random[0]
    assert int(rp.iv_len.max()) == 1 + 2 * kids

    def to(t):
        return t.to(dev, dtype if t.is_floating_point() else t.dtype)

    return (to(rp.z_diag / 1.3), to(rs.iv_idx), to(rs.iv_val), to(rp.iv_len),
            to(torch.tensor(1 / 0.7, dtype=torch.float64)), to(torch.from_numpy(rng.normal(size=q))),
            to(torch.from_numpy(rng.normal(size=q))))


@pytest.mark.parametrize("kids", [45, 2200])
@pytest.mark.parametrize("staged", [0, 5])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_solve_streamed_chunks_match_staged(dev, dtype, staged, kids):
    """CG1 on a system with a row wider than 8 x 8 entries (and one wider
    than a round of chunks) and blocks that own no rows: with every chunk of
    K in shared memory (the default here) and with none or 5 a block there,
    the rest streamed from scratch, the same bits (one layout, one order of
    sums), the plain version's iteration count, x within 1e-10 of scale
    solved to 1e-12 in float64 (1e-5 in float32, solved to 1e-4 as in
    test_cg_solve_kernel_matches_plain; the system with a row of 4,401
    entries to 1e-3: at 1e-4 its float32 residual lies in rounding noise,
    where the kernel stopped after 26 iterations and the plain version
    after 27), and the same bits twice."""
    from nextgp_tpu_torch.ops import cg

    args = _wide_cg_system(dtype, dev, kids)
    grid = _cuda.lib().ngt_cg_solve_grid(int(dtype == torch.float64))
    full = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev), cg.row_cuts(args[3], grid),
                      torch.full((1,), args[3].numel(), dtype=torch.int32, device=dev)])
    assert (full.diff() == 0).any()
    lim = dict(tol=1e-12 if dtype == torch.float64 else 1e-4 if kids == 45 else 1e-3)
    x, it, res = cg.cg_solve_sparse_kernel(*args, **lim)
    sx, sit, sres = cg.cg_solve_sparse_kernel(*args, **lim, staged=staged)
    sx2, _, _ = cg.cg_solve_sparse_kernel(*args, **lim, staged=staged)
    assert torch.equal(x, sx) and torch.equal(it, sit) and torch.equal(res, sres) and torch.equal(sx, sx2)
    px, pit, _ = cg.cg_solve_sparse_plain(*(t.cpu() for t in args), **lim)
    assert int(it) == int(pit) and 0 < int(it) < 1000
    tol = 1e-10 if dtype == torch.float64 else 1e-5
    assert (x.cpu() - px).abs().max().item() <= tol * px.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cg_plan_layout_sizes_scratch_by_live_entries(dev, dtype):
    """plan_layout (made once on the host, as the plan makes it) against
    cg_layout made on the card for the same grid: the same cuts and chunk
    slots, fewer slots than the padded width's bound; a solve given it the
    same bits as one without (the wrapper's own layout, its scratch sized by
    the padded width); a layout for another grid refused; and an A-cg plan
    assembled on the card carries the layout of its live lengths."""
    from nextgp_tpu_torch.ops import cg

    args = _wide_cg_system(dtype, dev, 45)
    grid = _cuda.lib().ngt_cg_solve_grid(int(dtype == torch.float64))
    cuts, first, slots = cg.plan_layout(args[3].cpu(), dtype, dev)
    dcuts, dfirst = cg.cg_layout(args[3], grid)
    assert torch.equal(cuts, dcuts) and torch.equal(first, dfirst) and slots == int(first[-1])
    assert slots < args[3].numel() * args[1].shape[1] // cg.CHUNK + grid
    lim = dict(tol=1e-12 if dtype == torch.float64 else 1e-4)
    x, it, res = cg.cg_solve_sparse(*args, **lim)
    lx, lit, lres = cg.cg_solve_sparse(*args, **lim, layout=(cuts, first, slots))
    assert torch.equal(x, lx) and torch.equal(it, lit) and torch.equal(res, lres)
    with pytest.raises(ValueError, match="grid"):
        cg.cg_solve_sparse(*args, **lim, layout=(cuts[:-1], first[:-1], slots))
    plan, _ = ngt.assemble(_acg_spec(), device=dev, dtype=dtype, vshards=4)
    rp = plan.random[0]
    assert all(torch.equal(a, b) for a, b in zip(rp.cg_layout, cg.cg_layout(rp.iv_len, grid)))


def test_cg_solve_refuses_what_it_does_not_take(dev):
    from nextgp_tpu_torch.ops import cg

    args = list(_cg_system("pedigree", torch.float64, dev))
    with pytest.raises(ValueError, match="one dtype"):
        cg.cg_solve_sparse(args[0].float(), *args[1:])
    with pytest.raises(ValueError, match="int32"):
        cg.cg_solve_sparse(args[0], args[1].long(), *args[2:])
    with pytest.raises(ValueError, match="vectors"):
        cg.cg_solve_sparse(*args[:5], args[5][:10], args[6])
    with pytest.raises(ValueError, match="float32 or float64"):
        cg.cg_solve_sparse(*(t.half() if t.is_floating_point() else t for t in args))


def test_eager_cg_sweep_makes_no_host_sync(dev):
    """An eager A-cg sweep with a KeyedStream, float64, under
    torch.cuda.set_sync_debug_mode("error"): no operation of the sweep
    waits for the card (CG1 decides its stopping rule there)."""
    plan, st = ngt.assemble(_acg_spec(), device=dev, dtype=torch.float64, vshards=4)
    sweep, stream = ngt.make_sweep(plan), ngt.KeyedStream(2, dev, torch.float64)
    st = sweep(st, stream)  # the first call builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            st = sweep(st, stream)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert 0 < int(sweep.cg_iterations[0]) < plan.random[0].cg_iters
    assert torch.isfinite(st.random[0].u).all()


def test_acg_replayed_chain_equals_eager(dev):
    """A-cg in float64 with a KeyedStream: make_scan_sampler's replays, and
    a ReplayedSweep's, keep the eager chain's bits (draws, ycorr, and each
    sweep's CG iteration count); make_chain_runner and run_lmem run it."""
    from nextgp_tpu_torch.engine import sweep as engine_sweep

    spec = _acg_spec()
    plan, st0 = ngt.assemble(spec, device=dev, dtype=torch.float64, vshards=4)
    stream = ngt.KeyedStream(23, dev, torch.float64)
    st, draws = ngt.make_scan_sampler(plan, 3, 2)(st0, stream)
    sweep, eager, kept, iters = ngt.make_sweep(plan), st0, [], []
    for _ in range(3):
        for _ in range(2):
            eager = sweep(eager, stream)
            iters.append(int(sweep.cg_iterations[0]))
        kept.append(ngt.collect_sample(eager, plan))
    assert {"uA", "varUA"} <= set(draws)
    for name, d in draws.items():
        assert torch.equal(d, torch.stack([k[name] for k in kept])), name
    assert torch.equal(st.ycorr, eager.ycorr)
    rep = engine_sweep.ReplayedSweep(plan, st0, stream)
    for i in range(6):
        rep.run(1)
        assert int(rep.cg_iterations[0]) == iters[i]
    assert torch.equal(rep.static.ycorr, eager.ycorr)
    run_thin = ngt.make_chain_runner(plan, 2)
    st, sample = run_thin(st0, stream)
    assert torch.equal(sample["uA"], kept[0]["uA"])
    res = ngt.run_lmem(spec, 6, 2, 2, out_folder=None, device=dev, dtype=torch.float64, vshards=4,
                       stream=stream)
    assert np.array_equal(res.draws["uA"], torch.stack([k["uA"] for k in kept[1:]]).cpu().numpy())


@pytest.mark.parametrize("n", [1, 33, 49_152])
def test_keyed_rng_float64_matches_plain(dev, n):
    """R1's float64 output against keyed_draw_plain(..., float64): uniforms
    the same bits, normals within 1e-6 of scale, gammas within 1e-5
    relative where the accepting attempt agrees, for the single-site and
    the split entry points; the float64 numbers are the float32 draw's
    uniforms and normals widened."""
    from nextgp_tpu_torch.engine import rng as R

    counter = torch.tensor(11, dtype=torch.int64, device=dev)
    h0, tail = R._splitmix64(3), (4, 0, 4, 1)
    alpha = torch.tensor(GAMMA_SHAPES, device=dev, dtype=torch.float64).repeat(n)[:n].contiguous()
    for rows in (None, (3, 1)):
        count = 1 if rows is None else rows[0]
        for kind in (R.UNIFORM, R.NORMAL, R.GAMMA):
            a = alpha.repeat(count) if kind == R.GAMMA else None
            got, att = R.keyed_draw(kind, h0, counter, tail, n, torch.float64, a, iters=True, rows=rows)
            ref, ref_att = R.keyed_draw_plain(kind, h0, counter, tail, n, torch.float64, a, iters=True,
                                              rows=rows)
            assert got.dtype == torch.float64 and got.shape == (count * n,)
            if kind == R.UNIFORM:
                assert torch.equal(got, ref)
            elif kind == R.NORMAL:
                assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()
            else:
                same = att == ref_att
                assert (att >= 0).all() and 1.0 - same.float().mean().item() <= 1e-4
                assert (((got - ref).abs() / ref.abs())[same] <= 1e-5).all()
            if kind != R.GAMMA:
                f32 = R.keyed_draw(kind, h0, counter, tail, n, torch.float32, rows=rows)
                assert torch.equal(got, f32.double())


# ------------------------------------------------------------------ M9: RE2, CM1, split draws


def _corr_level_inputs(q, n_t, dev, seed=0):
    """RE2's inputs: RE1's structure, yi (nT, q), per-level cross-products
    (q, nT, nT), z (q, nT), an old u (nT, q), varE and iVarU."""
    ivstr, *_ = _level_inputs(q, dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    x = torch.randn(q, 3, n_t, generator=g, device=dev)
    zpz = torch.einsum("lkt,lku->ltu", x, x) + 0.1 * torch.eye(n_t, device=dev)
    yi, u = (torch.randn(n_t, q, generator=g, device=dev) for _ in range(2))
    z = torch.randn(q, n_t, generator=g, device=dev)
    m = torch.randn(n_t, n_t, generator=g, device=dev)
    ivu = torch.linalg.inv(m @ m.T / n_t + torch.eye(n_t, device=dev))
    return ivstr, yi, zpz.contiguous(), z, u, torch.tensor(1.7, device=dev), ivu


@pytest.mark.parametrize("n_t", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("q", [1, 31, 33, 193, 3001, 25_000])
def test_corr_level_scan_matches_plain(dev, q, n_t):
    """RE2 at one level, either side of a group, one past the look-ahead's
    192 levels, at q = 3,001 (not a multiple of 4) and 25,000 (owners of two
    row blocks), for nT = 1 .. 4 (the cooperative form, its rule built in
    the kernel; at 4 one ring slot fewer) and 5 (the generic form, three
    and 25 tiles): within 1e-4 of u's scale of the plain version, the same
    bits from two launches, one count per call."""
    from nextgp_tpu_torch.ops import random_scan

    args = _corr_level_inputs(q, n_t, dev, q + n_t)
    before = _cuda.LAUNCHES["corr_level_scan"]
    out = random_scan.corr_level_scan(*args)
    ref = random_scan.corr_level_scan_plain(*args)
    assert out.shape == (n_t, q) and torch.isfinite(out).all()
    assert _rel(out, ref) < 1e-4
    assert torch.equal(out, random_scan.corr_level_scan(*args))
    assert _cuda.LAUNCHES["corr_level_scan"] == before + 2


def test_corr_level_scan_non_positive_definite_level_gives_nan(dev):
    """A level whose lhs is not positive definite (its cross-products made
    negative definite): the rule the kernel builds gives NaN there (and so
    in the levels after it, which it couples to), and the call makes no
    host sync."""
    from nextgp_tpu_torch.ops import random_scan

    args = list(_corr_level_inputs(100, 2, dev, 3))
    args[2] = args[2].clone()
    args[2][40] = -10.0 * torch.eye(2, device=dev)
    random_scan.corr_level_scan(*args)  # the first call builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = random_scan.corr_level_scan(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out[:, :40]).all() and torch.isnan(out[:, 40]).all()


def _corr_block_inputs(V, B, n_t, dev, seed=0, pad=0):
    """CM1's inputs: a step's (B, nT, V, B, nT) centered cross-Gram from
    random dosages, and packed rows from corr_block_pack with r0 added; the
    last `pad` loci of every chain padded."""
    from nextgp_tpu_torch.ops import corr_scan

    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randint(0, 3, (V, B, n_t, 200), generator=g, device=dev).float()
    X = X - X.mean(-1, keepdim=True)
    G = torch.einsum("vjtn,vkwn->jtvkw", X, X).contiguous()
    mpm = torch.einsum("jtvjw->vjtw", G).reshape(-1, n_t, n_t)
    bold, z, r0 = (torch.randn(V * B, n_t, generator=g, device=dev) * 0.1 for _ in range(3))
    m = torch.randn(n_t, n_t, generator=g, device=dev)
    ivb = torch.linalg.inv(m @ m.T / n_t * 0.01 + 0.01 * torch.eye(n_t, device=dev))
    mask = (torch.arange(B, device=dev) < B - pad).repeat(V)
    pk = corr_scan.corr_block_pack(bold, z, ivb.expand(V * B, n_t, n_t), mpm, mask,
                                   torch.tensor(1 / 1.3, device=dev)).view(V, B, -1).clone()
    pk[..., :n_t] += r0.view(V, B, n_t) * 20
    return G, pk


@pytest.mark.parametrize("n_t", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("V,B", [(1, 16), (1, 256), (96, 16), (96, 256)])
def test_corr_block_scan_matches_plain(dev, V, B, n_t):
    """CM1 on complete rows at B in {16, 256}, V in {1, 96}, nT = 1 .. 4
    (register forms: three slots, two, one) and 5 (the generic form), with
    padded loci: the folded block-step on a one-step (V, 1, B, W) pack with
    r0, the centres and sum(y) zero against the plain scan
    (corr_block_scan_v_plain): beta and u within 1e-4 of their scale,
    padded loci's beta 0, the same bits from two launches."""
    from nextgp_tpu_torch.ops import corr_scan

    G, pk = _corr_block_inputs(V, B, n_t, dev, V * B + n_t, pad=3)
    zero = torch.zeros((V, B, n_t), device=dev)
    fold = (zero, zero, torch.zeros((), device=dev))
    beta = torch.empty((V, 1, B, n_t), device=dev)
    before = _cuda.LAUNCHES["corr_block_scan_v"]
    u = corr_scan.corr_block_step((G[None], 0), pk[:, None], *fold, beta)
    rb, ru = corr_scan.corr_block_scan_v_plain(G, pk, n_t)
    assert torch.isfinite(beta).all() and torch.isfinite(u).all()
    assert _rel(beta[:, 0], rb) < 1e-4 and _rel(u, ru) < 1e-4
    assert (beta[:, 0, B - 3:] == 0).all()
    b1 = beta.clone()
    u2 = corr_scan.corr_block_step((G[None], 0), pk[:, None], *fold, beta)
    assert torch.equal(beta, b1) and torch.equal(u, u2)
    assert _cuda.LAUNCHES["corr_block_scan_v"] == before + 2


def _corr_rule_inputs(p, n_t, dev, seed=0, n_regions=7):
    """The rule's inputs for p loci: beta, z, a positive definite mpm per
    locus, seven regions' covariances, region ids (the last four loci past
    the regions, as padded loci are), a mask with the last four loci
    padded, varE."""
    g = torch.Generator(device=dev).manual_seed(seed)
    bold, z = (torch.randn(p, n_t, generator=g, device=dev) * s for s in (0.1, 1.0))
    x = torch.randn(p, 40, n_t, generator=g, device=dev)
    mpm = torch.einsum("lkt,lku->ltu", x, x).contiguous()
    m = torch.randn(n_regions, n_t, n_t, generator=g, device=dev)
    var_beta = (m @ m.transpose(1, 2) / n_t * 0.01 + 0.01 * torch.eye(n_t, device=dev)).contiguous()
    region = torch.randint(0, n_regions, (p,), generator=g, device=dev, dtype=torch.int32)
    region[-4:] = n_regions
    mask = torch.arange(p, device=dev) < p - 4
    return bold, z, var_beta, region, mpm, mask, torch.tensor(1.3, device=dev)


@pytest.mark.parametrize("n_t", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("V,B", [(1, 16), (1, 256), (96, 16), (96, 256)])
def test_corr_rule_matches_pack(dev, V, B, n_t):
    """CM1's rule launch on the rows of two steps of V chains of B loci
    (nT = 1 .. 4) against its plain version (the regions' inverses gathered,
    then corr_block_pack): adj, c and M each within 1e-5 of its scale, bold
    copied, padded loci's c and M 0, the same bits twice, one count per
    call; at nT = 5 the torch pack itself, with no launch."""
    from nextgp_tpu_torch.ops import corr_scan

    args = _corr_rule_inputs(V * 2 * B, n_t, dev, V + B + n_t)
    before = _cuda.LAUNCHES["corr_rule"]
    pk = corr_scan.corr_rule(*args)
    ref = corr_scan.corr_rule_plain(*args)
    if n_t > corr_scan.FAST_NT:
        assert torch.equal(pk, ref) and _cuda.LAUNCHES["corr_rule"] == before
        return
    assert pk.shape == ref.shape and torch.isfinite(pk).all()
    for sl in (slice(0, n_t), slice(2 * n_t, 3 * n_t), slice(3 * n_t, None)):
        assert _rel(pk[:, sl], ref[:, sl]) < 1e-5
    assert torch.equal(pk[:, n_t:2 * n_t], args[0])
    assert (pk[-4:, 2 * n_t:] == 0).all()
    assert torch.equal(pk, corr_scan.corr_rule(*args))
    assert _cuda.LAUNCHES["corr_rule"] == before + 2


def test_corr_rule_non_positive_definite_locus_gives_nan(dev):
    """A locus whose lhs is not positive definite (its mpm made negative
    definite): the rule launch gives NaN in its c, finite rows elsewhere,
    and the call makes no host sync."""
    from nextgp_tpu_torch.ops import corr_scan

    args = list(_corr_rule_inputs(300, 2, dev, 5))
    args[4] = args[4].clone()
    args[4][40] = -1e3 * torch.eye(2, device=dev)
    corr_scan.corr_rule(*args)  # the first call builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pk = corr_scan.corr_rule(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    others = torch.arange(300, device=dev) != 40
    assert torch.isnan(pk[40, 4:6]).all() and torch.isfinite(pk[others]).all()


@pytest.mark.parametrize("n_t", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("V,B", [(1, 16), (1, 256), (96, 16), (96, 256), (1, 100), (96, 100),
                                 (1, 1000), (8, 1000)])
def test_corr_block_step_matches_plain(dev, V, B, n_t):
    """CM1's folded block-step at step 1 of two (B = 100 and 1000: a short
    last group staged by 4-byte copies; B = 1000 the 1024-thread form, its
    32 warps handing on at named barriers, its far products loaded from the
    Gram): its rows read in place from the (V, 2, B, W) pack, K1's r0, the
    step's centres and sum(y) (0-d) folded into adj, beta written into the (V, 2, B, nT) buffer; against
    the plain block-step (clone, add, scan, copy): beta and u within 1e-4
    of their scale, padded loci's beta exactly 0, step 0 of the buffer
    untouched, step 0 of the Gram and of the rows never read (NaN there),
    the same bits from two launches, one count per call."""
    from nextgp_tpu_torch.ops import corr_scan

    G, pk = _corr_block_inputs(V, B, n_t, dev, V * B + n_t + 7, pad=3)
    gram = torch.stack([torch.full_like(G, float("nan")), G])
    pk_g = torch.stack([torch.full_like(pk, float("nan")), pk], dim=1).contiguous()  # (V, 2, B, W)
    g = torch.Generator(device=dev).manual_seed(B + n_t)
    r0, cb = (torch.randn(V, B, n_t, generator=g, device=dev) for _ in range(2))
    cb[:, B - 3:] = 0.0  # a padded locus has no centre
    r0[:, B - 3:] = 0.0  # nor a K1 sum
    sum_y = torch.tensor(2.5, device=dev)
    beta = torch.full((V, 2, B, n_t), 7.0, device=dev)
    ref = beta.clone()
    before = _cuda.LAUNCHES["corr_block_scan_v"]
    u = corr_scan.corr_block_step((gram, 1), pk_g, r0, cb, sum_y, beta)
    ru = corr_scan.corr_block_step_plain(G, pk_g, 1, r0, cb, sum_y, ref)
    assert torch.isfinite(beta).all() and torch.isfinite(u).all()
    assert _rel(beta[:, 1], ref[:, 1]) < 1e-4 and _rel(u, ru) < 1e-4
    assert (beta[:, 1, B - 3:] == 0).all() and (beta[:, 0] == 7.0).all()
    b1 = beta.clone()
    u2 = corr_scan.corr_block_step((gram, 1), pk_g, r0, cb, sum_y, beta)
    assert torch.equal(u, u2) and torch.equal(beta, b1)
    assert _cuda.LAUNCHES["corr_block_scan_v"] == before + 2


def test_keyed_split_draw_matches_plain(dev):
    """R1's split entry point (every region's draws in one launch) against
    the plain version: uniforms its bits, normals within 1e-6 of scale,
    gammas within 1e-5 where the accepting attempt agrees; one launch per
    draw, the same bits twice; and R1's single-site entry point unchanged
    (each row the single-site draw at that row's site)."""
    from nextgp_tpu_torch.engine import rng as R

    counter = torch.tensor(5, dtype=torch.int64, device=dev)
    h0 = R._splitmix64(9)
    tail, slot = R.split_tail(R.Site(0, 4, 1, ((2, 1),)), 492, ((2, 0),))
    alpha = torch.tensor(GAMMA_SHAPES, device=dev).repeat(492 * 2)[:492 * 4].contiguous()
    for kind, n in ((R.UNIFORM, 4), (R.NORMAL, 4), (R.GAMMA, 4)):
        a = alpha if kind == R.GAMMA else None
        before = _cuda.LAUNCHES["keyed_rng"]
        got, att = R.keyed_draw(kind, h0, counter, tail, n, torch.float32, a, iters=True,
                                rows=(492, slot))
        assert _cuda.LAUNCHES["keyed_rng"] == before + 1
        ref, ref_att = R.keyed_draw_plain(kind, h0, counter, tail, n, torch.float32, a, iters=True,
                                          rows=(492, slot))
        assert torch.equal(got, R.keyed_draw(kind, h0, counter, tail, n, torch.float32, a,
                                             rows=(492, slot)))
        if kind == R.UNIFORM:
            assert torch.equal(got, ref)
        elif kind == R.NORMAL:
            assert (got - ref).abs().max().item() <= 1e-6 * ref.abs().max().item()
        else:
            same = att == ref_att
            assert (att >= 0).all() and 1.0 - same.float().mean().item() <= 1e-3
            assert (((got - ref).abs() / ref.abs())[same] <= 1e-5).all()
        for r in (0, 17, 491):
            t = list(tail)
            t[slot] = r
            one = R.keyed_draw(kind, h0, counter, tuple(t), n, torch.float32,
                               None if a is None else a[r * n:(r + 1) * n].contiguous())
            assert torch.equal(one, got[r * n:(r + 1) * n])


def _corr_specs(n=300, p=256):
    """An intercept with two correlated marker sets (BayesPR, regions of 32
    loci), and an intercept with an (intercept, slope) animal group on a
    pedigree's A^-1."""
    from nextgp_tpu_torch.data import pedigree as P

    rng = np.random.default_rng(12)
    g1, g2 = (rng.integers(0, 3, (n, p)) for _ in range(2))
    y = (g1 - g1.mean(0)) @ rng.normal(0, 0.1, p) + (g2 - g2.mean(0)) @ rng.normal(0, 0.1, p) \
        + rng.normal(0, 1, n)
    chr_ids = np.ones(p, int)
    v = np.array([[0.02, 0.01], [0.01, 0.02]])
    ms = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))], corr_markers=[
        ngt.CorrMarkerTerm(("M1", "M2"), (ngt.from_array(g1, chr_ids=chr_ids),
                                          ngt.from_array(g2, chr_ids=chr_ids)),
                           ngt.BayesPR(32, v))], block_size=32)
    ids = [f"a{i}" for i in range(n)]
    ped = ngt.build_pedigree(ids, [None] * 30 + [ids[rng.integers(0, i)] for i in range(30, n)],
                             [None] * 30 + [ids[rng.integers(0, i)] for i in range(30, n)])
    z = np.zeros((n, n))
    z[np.arange(n), ped.index_of(ids)] = 1.0
    x = rng.normal(size=n)
    rs = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))], random=[
        ngt.RandomTerm(("A", "S"), (z, z * x[:, None]), prior=ngt.Random("A", np.eye(2) * 0.3),
                       ivstr=P.a_inverse(ped))])
    return ms, rs


@pytest.mark.parametrize("which,V", [("markers", 1), ("markers", 4), ("random", 1)])
def test_corr_paths_replayed_equal_eager_and_follow_plain(dev, which, V):
    """Both M9 paths through make_scan_sampler's graph replays with the
    eager chain's bits (CM1, K1/K2 and R1's split draws, or RE2, inside the
    graph); the plain chain on the CPU from the same host draws follows the
    kernel chain; every drawn covariance is positive definite."""
    spec = _corr_specs()[0 if which == "markers" else 1]
    plan, st0 = ngt.assemble(spec, device=dev, vshards=V)
    stream = ngt.KeyedStream(29, dev, torch.float32)
    st, draws = ngt.make_scan_sampler(plan, 3, 2)(st0, stream)
    sweep, eager, kept = ngt.make_sweep(plan), st0, []
    for _ in range(3):
        for _ in range(2):
            eager = sweep(eager, stream)
        kept.append(ngt.collect_sample(eager, plan))
    for name, d in draws.items():
        assert torch.equal(d, torch.stack([k[name] for k in kept])), name
    assert torch.equal(st.ycorr, eager.ycorr)
    cov = (st.corr_markers[0].var_beta if which == "markers" else st.random[0].var_u[None])
    assert (torch.linalg.cholesky_ex(cov)[1] == 0).all()
    chains = []
    for device in (dev, "cpu"):
        plan, s = ngt.assemble(spec, device=device, dtype=torch.float32, vshards=V)
        sw, hs = ngt.make_sweep(plan), HostStream(4, device, torch.float32)
        for _ in range(3):
            s = sw(s, hs)
        chains.append((s.corr_markers[0].beta if which == "markers" else s.random[0].u).cpu())
    assert _rel(*chains) < 1e-3


# ------------------------------------------------------------------ the runtime (M10)


def _leaves_equal(a, b):
    from nextgp_tpu_torch.engine import sweep as engine_sweep

    la, lb = engine_sweep._leaves(a), engine_sweep._leaves(b)
    return la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la) \
        and a.sweep_index == b.sweep_index


def test_replayed_run_lmem_files_checkpoints_and_resume(dev, tmp_path):
    """run_lmem replayed (KeyedStream) with files and a checkpoint every 2
    kept samples, the kept samples copied a chunk at a time: the draws of
    the run without files; a run stopped at 21 sweeps (9 kept, the last
    checkpoint at kept 8) and resumed: the files byte for byte, the draws and every leaf
    of the final state bit for bit."""
    spec, stream = _small_spec("BayesR"), ngt.KeyedStream(31, dev, torch.float32)
    kw = dict(n_chain=29, n_burn=3, n_thin=2, vshards=4, stream=stream)  # 13 kept
    ref = ngt.run_lmem(spec, out_folder=None, device=dev, **kw)
    full = ngt.run_lmem(spec, out_folder=str(tmp_path / "a"), checkpoint_every=2, device=dev, **kw)
    ngt.run_lmem(spec, out_folder=str(tmp_path / "b"), checkpoint_every=2, device=dev,
                 **{**kw, "n_chain": 21})
    resumed = ngt.run_lmem(spec, out_folder=str(tmp_path / "b"), checkpoint_every=2, resume=True,
                           device=dev, **kw)
    for name, d in ref.draws.items():
        assert np.array_equal(full.draws[name], d) and np.array_equal(resumed.draws[name], d[8:]), name
    outs = sorted(f for f in os.listdir(tmp_path / "a") if f.endswith("Out"))
    assert outs and all((tmp_path / "a" / f).read_bytes() == (tmp_path / "b" / f).read_bytes()
                        for f in outs)
    assert _leaves_equal(full.state, resumed.state) and _leaves_equal(full.state, ref.state)
    assert full.state.ycorr.is_cuda and int(full.state.sweep_counter) == 29


def test_replayed_run_chains_equal_run_lmem(dev):
    """Two chains through run_chains, each replayed with its own KeyedStream
    on one assembled state: each the same bits as run_lmem with its stream,
    and the batched state stacks their final states."""
    spec = _small_spec("BayesR")
    streams = [ngt.KeyedStream(s, dev, torch.float32) for s in (41, 42)]
    kw = dict(n_chain=17, n_burn=3, n_thin=2, vshards=4)
    out = ngt.run_chains(spec, 2, track="all", device=dev, streams=streams, **kw)
    for c, stream in enumerate(streams):
        one = ngt.run_lmem(spec, out_folder=None, device=dev, stream=stream, **kw)
        for name, d in one.draws.items():
            assert np.array_equal(out["draws"][name][c], d), (c, name)
        assert torch.equal(out["state"].ycorr[c], one.state.ycorr)
    assert out["state"].sweep_index.tolist() == [17, 17] and np.isfinite(out["rhat"]["varE"]).all()


def test_replayed_run_chains_files_checkpoints_and_resume(dev, tmp_path):
    """run_chains replayed (a KeyedStream a chain) with per-chain files and
    a checkpoint every 2 kept samples: the draws of the run without files;
    a run stopped at 21 sweeps (9 kept, the last checkpoint at kept 8) and
    resumed: every chain's files byte for byte, the draws and every leaf of
    the batched state bit for bit."""
    from nextgp_tpu_torch.engine import sweep as engine_sweep

    spec = _small_spec("BayesR")
    streams = [ngt.KeyedStream(s, dev, torch.float32) for s in (41, 42)]
    kw = dict(n_chain=29, n_burn=3, n_thin=2, vshards=4, track="all", device=dev, streams=streams)
    ref = ngt.run_chains(spec, 2, **kw)  # 13 kept
    full = ngt.run_chains(spec, 2, out_folder=str(tmp_path / "a"), checkpoint_every=2, **kw)
    ngt.run_chains(spec, 2, out_folder=str(tmp_path / "b"), checkpoint_every=2, **{**kw, "n_chain": 21})
    resumed = ngt.run_chains(spec, 2, out_folder=str(tmp_path / "b"), checkpoint_every=2, resume=True,
                             **kw)
    for name, d in ref["draws"].items():
        assert np.array_equal(full["draws"][name], d), name
        assert np.array_equal(resumed["draws"][name], d[:, 8:]), name
    for chain in ("chain1", "chain2"):
        a, b = tmp_path / "a" / chain, tmp_path / "b" / chain
        outs = sorted(f for f in os.listdir(a) if f.endswith("Out"))
        assert outs and all((a / f).read_bytes() == (b / f).read_bytes() for f in outs), chain
    for other in (resumed, ref):
        la, lb = engine_sweep._leaves(full["state"]), engine_sweep._leaves(other["state"])
        assert la.keys() == lb.keys() and all(torch.equal(la[k], lb[k]) for k in la)
    assert full["state"].sweep_index.tolist() == [29, 29]


# ------------------------------------------------------------------ unpacked storage (M7c)


def _storage_spec(kind, corr=False, n=300, p=512):
    """An intercept and a BayesR marker set (or a correlated pair under
    BayesPR) over int8 dosages or an imputed panel (5 % fractional dosages,
    from_float_array)."""
    rng = np.random.default_rng(14)
    gs = [rng.integers(0, 3, (n, p)).astype(float) for _ in range(2 if corr else 1)]
    if kind == "float":
        for g in gs:
            hit = rng.random(g.shape) < 0.05
            g[hit] = rng.uniform(0, 2, int(hit.sum()))
    y = sum((g - g.mean(0)) @ rng.normal(0, 0.1, p) for g in gs) + rng.normal(0, 1, n)
    datas = [ngt.from_float_array(g, chr_ids=np.ones(p, int)) if kind == "float"
             else ngt.from_array(g, chr_ids=np.ones(p, int)) for g in gs]
    if corr:
        return ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))], block_size=32,
                             corr_markers=[ngt.CorrMarkerTerm(("M1", "M2"), tuple(datas), ngt.BayesPR(
                                 32, np.array([[0.02, 0.01], [0.01, 0.02]])))])
    return ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))], block_size=32,
                         markers=[ngt.MarkerTerm("M", datas[0], ngt.BayesR(
                             [0.9, 0.05, 0.03, 0.02], [0.0, 1e-4, 1e-3, 1e-2], 1.0, estimatePi=True))])


@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("kind,corr", [("int8", False), ("float", False), ("float", True)],
                         ids=["BayesR-int8", "BayesR-float", "MultiBreed-float"])
def test_unpacked_storage_on_the_card(dev, kind, corr, V):
    """int8 (pack2=False) and float rows on the card: the sweep's gather and
    scatter are products (K1 and K2 never launch), the scans (K3, or CM1 and
    its rule) run as on packed rows; make_scan_sampler's replays give the
    eager chain's bits; the float32 card chain follows the plain chain on
    the CPU from the same host draws; genomic_values_state on the card (a
    float32 product) is within 1e-5 of scale of genomic_values (host
    float64)."""
    spec = _storage_spec(kind, corr)
    plan, st0 = ngt.assemble(spec, device=dev, vshards=V, pack2=False if kind == "int8" else None)
    mt = (st0.corr_markers if corr else st0.markers)[0].mt
    assert mt.dtype == (torch.int8 if kind == "int8" else torch.float32)
    before = dict(_cuda.LAUNCHES)
    stream = ngt.KeyedStream(31, dev, torch.float32)
    sweep, eager, kept = ngt.make_sweep(plan), st0, []
    for _ in range(3):
        for _ in range(2):
            eager = sweep(eager, stream)
        kept.append(ngt.collect_sample(eager, plan))
    ran = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    T = 512 // 32 // V
    assert ran["pack2_matvec"] == ran["pack2_rank_update"] == 0
    assert ran["corr_block_scan_v" if corr else "r_block_scan_v"] == 6 * T
    st, draws = ngt.make_scan_sampler(plan, 3, 2)(st0, stream)
    for name, d in draws.items():
        assert torch.equal(d, torch.stack([k[name] for k in kept])), name
    assert torch.equal(st.ycorr, eager.ycorr)
    chains = []
    for device in (dev, "cpu"):
        p_, s = ngt.assemble(spec, device=device, dtype=torch.float32, vshards=V,
                             pack2=False if kind == "int8" else None)
        sw, hs = ngt.make_sweep(p_), HostStream(4, device, torch.float32)
        for _ in range(3):
            s = sw(s, hs)
        chains.append(((s.corr_markers if corr else s.markers)[0].beta.cpu(), s.ycorr.cpu()))
    assert _rel(chains[0][0], chains[1][0]) < 1e-3 and _rel(chains[0][1], chains[1][1]) < 1e-4
    if not corr:
        beta = draws["betaM"].mean(0).cpu().numpy()
        host = ngt.genomic_values(spec.markers[0].data, beta)
        card = ngt.genomic_values_state(plan, st, beta=beta).double().cpu().numpy()
        assert np.abs(card - host).max() / np.abs(host).max() < 1e-5


# ------------------------------------------------------------------ GRN1 and the GRN step

# bench_grn's three (G, S), then GRN1's edges: one SNP, either side of one
# and two tiles of 32, 2,000 and 3,000 SNPs (tens of tiles); one gene, three,
# 100; 2,048 and 2,049 (the old kernel's register limit)
GRN_SHAPES = ([(10, 20), (30, 60), (100, 200)]
              + [(G, S) for S in (1, 31, 32, 33, 63, 64, 65, 2000, 3000) for G in (1, 3, 100)]
              + [(5, 2048), (5, 2049)])
GRN_TOL = {torch.float32: 1e-4, torch.float64: 1e-10}  # of d's scale: the sums in another order


def _grn_inputs(dev, G, S, dtype, n=2000, zero_snp=None):
    """GRN1's inputs: the Gram of S centred dosage rows of n individuals
    (a row constant where zero_snp names it), r0 at the scale x'ycorr has,
    normal z and bold, var_e 0.25."""
    g = torch.Generator(device=dev).manual_seed(1000 * G + S)
    x = torch.randint(0, 3, (S, n), generator=g, device=dev).double()
    if zero_snp is not None:
        x[zero_snp] = 1.0
    xc = x - x.mean(1, keepdim=True)
    gram = (xc @ xc.T).to(dtype)
    r0, z, bold = (torch.randn(G, S, generator=g, device=dev, dtype=torch.float64).to(dtype)
                   for _ in range(3))
    return gram, r0 * 20.0, z, bold * 0.05, torch.tensor(0.25, dtype=dtype, device=dev)


def _grn_held(out, ref, dtype):
    """d (or bnew) within GRN_TOL of its scale, non-finite where ref is."""
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(out), fin)
    if fin.any():
        o, r = out[fin], ref[fin]
        assert (o - r).abs().max().item() <= GRN_TOL[dtype] * r.abs().max().item()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("G,S", GRN_SHAPES)
def test_grn_scan_kernel_matches_plain(dev, G, S, dtype):
    """GRN1 against grn_scan_plain: d and bnew within GRN_TOL of scale,
    bnew = bold - d exactly, the same bits from two launches, with the
    layout made once or by the call."""
    from nextgp_tpu_torch.ops import grn_scan

    args = _grn_inputs(dev, G, S, dtype)
    lay = grn_scan.grn_layout(args[0])
    bnew, d = grn_scan.grn_scan_kernel(*args, lay)
    rb, rd = grn_scan.grn_scan_plain(*args)
    _grn_held(d, rd, dtype)
    _grn_held(bnew, rb, dtype)
    assert torch.equal(bnew, args[3] - d)
    b2, d2 = grn_scan.grn_scan_kernel(*args)
    assert torch.equal(b2, bnew) and torch.equal(d2, d)
    assert torch.equal(grn_scan.grn_scan(*args, lay)[1], d)  # the dispatcher launches it


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("past", [0, 1], ids=["at", "past"])
def test_grn_scan_kernel_at_its_shared_memory_limit(dev, past, dtype):
    """At the most SNPs whose d's shared memory holds (24,384 in float64,
    53,440 in float32 on an H100) and one past it, where the call takes
    scratch: held to the plain version, the same bits twice, and each gene
    the bits of a call on it alone."""
    from nextgp_tpu_torch.ops import grn_scan

    f64 = int(dtype == torch.float64)
    limit = grn_scan.smem_snps(dev, f64)
    S = limit + past
    assert S > 3000 and (grn_scan.scratch_words(3, S, limit) > 0) == bool(past)
    args = _grn_inputs(dev, 3, S, dtype, n=200)
    lay = grn_scan.grn_layout(args[0])
    bnew, d = grn_scan.grn_scan_kernel(*args, lay)
    rb, rd = grn_scan.grn_scan_plain(*args)
    _grn_held(d, rd, dtype)
    _grn_held(bnew, rb, dtype)
    assert torch.equal(grn_scan.grn_scan_kernel(*args, lay)[1], d)
    one = [args[0]] + [t[2:3].contiguous() for t in args[1:4]] + [args[4]]
    assert torch.equal(grn_scan.grn_scan_kernel(*one, lay)[1][0], d[2])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("S", [200, 2000, 3000])
def test_grn_scan_kernel_on_a_monomorphic_snp(dev, S, dtype):
    """A SNP whose centred row is zero (gram[q, q] = 0): its reciprocal is
    infinite, as the JAX package divides by it, so that SNP's draw and every
    later one of each gene are not finite, where the plain version's are;
    nothing before it changes."""
    from nextgp_tpu_torch.ops import grn_scan

    q0 = S // 3
    args = _grn_inputs(dev, 3, S, dtype, zero_snp=q0)
    bnew, d = grn_scan.grn_scan_kernel(*args)
    rb, rd = grn_scan.grn_scan_plain(*args)
    assert not torch.isfinite(d[:, q0:]).any() and torch.isfinite(d[:, :q0]).all()
    _grn_held(d, rd, dtype)
    _grn_held(bnew, rb, dtype)


def test_grn_scan_refuses_what_it_does_not_take(dev):
    from nextgp_tpu_torch.ops import grn_scan

    gram, r0, z, bold, ve = _grn_inputs(dev, 3, 40, torch.float32)
    with pytest.raises(ValueError, match="one CUDA device"):
        grn_scan.grn_scan_kernel(gram.cpu(), r0, z, bold, ve)
    with pytest.raises(ValueError, match="float32, or every input float64"):
        grn_scan.grn_scan_kernel(gram.double(), r0, z, bold, ve)
    with pytest.raises(ValueError, match="float32, or every input float64"):
        grn_scan.grn_scan_kernel(gram.half(), r0.half(), z.half(), bold.half(), ve.half())
    with pytest.raises(ValueError, match="contiguous"):
        grn_scan.grn_scan_kernel(gram[:39, :39], r0, z, bold, ve)
    with pytest.raises(ValueError, match="contiguous"):
        grn_scan.grn_scan_kernel(gram, r0, z.T.contiguous().T, bold, ve)
    with pytest.raises(ValueError, match="one value"):
        grn_scan.grn_scan_kernel(gram, r0, z, bold, ve.expand(2))
    with pytest.raises(ValueError, match="layout"):
        grn_scan.grn_scan_kernel(gram, r0, z, bold, ve, grn_scan.grn_layout(gram[:33, :33].contiguous()))
    with pytest.raises(ValueError, match="layout"):
        grn_scan.grn_scan_kernel(gram, r0, z, bold, ve, grn_scan.grn_layout(gram.double()))


def _grn_data(G=6, spg=5, N=400, seed=4):
    """A small GRN problem: test_grn.py's design on G genes."""
    rng = np.random.default_rng(seed)
    S = G * spg
    x = rng.integers(0, 3, (S, N)).astype(float)
    xc = x - x.mean(axis=1, keepdims=True)
    lam1 = np.zeros((G, G))
    lam1[1, 0], lam1[3, 2] = 0.5, -0.4
    lam2 = np.zeros((G, S))
    for g in range(G):
        lam2[g, g * spg:(g + 1) * spg] = rng.normal(0, 0.4, spg)
    y = np.linalg.solve(np.eye(G) - lam1, rng.normal(0, 1, (G, 1)) + lam2 @ xc + rng.normal(0, 0.3, (G, N)))
    return x, y, G


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_eager_grn_step_makes_no_host_sync(dev, dtype):
    """An eager GRN step with a KeyedStream under
    torch.cuda.set_sync_debug_mode("error"): no operation of the step waits
    for the card (the Metropolis-Hastings choice is made there)."""
    from nextgp_tpu_torch.grn import sampler as tgrn

    x, y, G = _grn_data()
    _, state, step = tgrn.prepare_grn(x, y, G, start_lam1=np.full(G * G - G, 0.1), dtype=dtype, device=dev)
    stream = ngt.KeyedStream(3, dev, dtype)
    state = step(state, stream)  # the first call builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            state = step(state, stream)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(state.lam2).all() and torch.isfinite(state.lam1).all()
    assert state.it == 4 and int(state.it_counter) == 4


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_grn_replayed_chain_equals_eager(dev, dtype):
    """est_grn with a KeyedStream on the card replays one captured step;
    its draws, accept count and final state are the bits of eager steps
    with the same stream; GRN1 launches once an eager step."""
    from nextgp_tpu_torch.grn import sampler as tgrn

    x, y, G = _grn_data()
    kw = dict(start_lam1=np.full(G * G - G, 0.1), dtype=dtype, device=dev)
    stream = ngt.KeyedStream(9, dev, dtype)
    acc, draws, st = ngt.est_grn(x, y, G, 5, 14, 4, 2, out_folder=None, stream=stream, **kw)
    _, state, step = tgrn.prepare_grn(x, y, G, **kw)
    before, kept = _cuda.LAUNCHES["grn_scan"], []
    for it in range(1, 15):
        state = step(state, stream)
        if it >= 6 and it % 2 == 0:
            kept.append(tgrn.grn_sample(state, step))
    assert _cuda.LAUNCHES["grn_scan"] - before == 14
    assert acc == int(state.accept) and st.it == state.it == 14
    for name, d in draws.items():
        assert np.array_equal(d, torch.stack([k[name] for k in kept]).cpu().numpy()), name
    for f in ("mu", "lam1", "lam2", "var_lam1", "var_beta", "var_e", "ycorr", "accept", "it_counter"):
        assert torch.equal(getattr(st, f), getattr(state, f)), f


# ------------------------------------------------------------ float64: K1, K2, K3, K6, K8, K10

TOL_F64 = 1e-12  # of the output's scale: float64 sums in another order than the plain version's


@pytest.mark.parametrize("rows,q", [(1, 16), (3, 48), (5, 528), (7, 2560), (4095, 496),
                                    (4097, 16), (511, 12_544), (513, 2560), (1025, 25_088),
                                    (24_576, 2560)])
def test_pack2_f64_kernels_match_plain(dev, rows, q):
    """K1's and K2's float64 instances at the float32 instances' edges (and
    the main path's 24,576 x 2,560 step), on step t = 1 of three, and K1'
    and K2' over the whole panel: within 1e-12 of scale of the plain
    versions (which sum in float64 too), the same bits on a second call,
    float64 out, each launch counted as float64 and none as float32. K2's
    float64 tile is 256 bytes, so q = 16, 48 and 496 also fall either side
    of it."""
    g = torch.Generator(device=dev).manual_seed(rows * 7 + q)
    pk = torch.randint(0, 256, (3 * rows, q), generator=g, device=dev, dtype=torch.uint8)
    y4 = torch.randn((4, q), generator=g, device=dev, dtype=torch.float64)
    u = torch.randn(rows, generator=g, device=dev, dtype=torch.float64)
    u_all = torch.randn(3 * rows, generator=g, device=dev, dtype=torch.float64)
    sl = pk[rows:2 * rows]
    before = dict(_cuda.LAUNCHES)
    r0 = pack2.matvec_step(pk, 1, y4, rows)
    dy = pack2.rank_update_step(pk, 1, u)
    r0_all, dy_all = pack2.matvec(pk, y4), pack2.rank_update(pk, u_all)
    ran = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    assert ran["pack2_matvec_f64"] == ran["pack2_rank_update_f64"] == 2
    assert ran["pack2_matvec"] == ran["pack2_rank_update"] == 0
    assert all(x.dtype == torch.float64 for x in (r0, dy, r0_all, dy_all))
    assert _rel(r0, pack2.matvec_plain(sl, y4)) < TOL_F64
    assert _rel(dy, pack2.rank_update_plain(sl, u)) < TOL_F64
    assert _rel(r0_all, pack2.matvec_plain(pk, y4)) < TOL_F64
    assert _rel(dy_all, pack2.rank_update_plain(pk, u_all)) < TOL_F64
    assert torch.equal(r0, pack2.matvec_step(pk, 1, y4, rows))
    assert torch.equal(dy, pack2.rank_update_step(pk, 1, u))
    for blocks in (1, 3, 1000):
        assert torch.equal(r0, pack2._matvec_kernel(pk, rows, rows, y4, blocks))


@pytest.mark.parametrize("V,B,K", [
    (1, 8, 4), (4, 33, 4), (96, 256, 4), (1, 1024, 4), (2, 40, 1), (3, 70, 5),
    (4, 96, 8),  # the largest rule in one lane's registers
    (1, 256, 9), (4, 256, 9), (96, 256, 9),  # one class past it: the serial rule
    (1, 256, 20), (4, 64, 20), (96, 256, 20), (1, 1024, 16),
])
def test_scan_f64_kernel_matches_plain(dev, V, B, K):
    """K3's float64 instance against its plain version in float64,
    step-indexed and sliced, every uniform kept 1e-4 off the CDF edges:
    delta (the class) exactly, beta and u within 1e-12 of their scale, the
    same bits on a second launch, counted as float64."""
    T = 2
    gram, pk, g = _r_inputs(dev, T, V, B, K, V * 1000 + B + K + 7)
    gram, pk = gram.double(), pk.double()
    for t in range(T):
        rb, ru, rd = _keep_off_cdf_edges(pk, lambda p: gibbs_kernels.r_block_scan_v_plain(gram[t], p, K),
                                         [2], (2,), g)
        before = dict(_cuda.LAUNCHES)
        beta, u, delta = gibbs_kernels.r_block_scan_v((gram, t), pk, K)
        assert _cuda.LAUNCHES["r_block_scan_v_f64"] == before["r_block_scan_v_f64"] + 1
        assert _cuda.LAUNCHES["r_block_scan_v"] == before["r_block_scan_v"]
        assert beta.dtype == u.dtype == torch.float64 and delta.dtype == torch.int32
        assert torch.equal(delta, rd)
        assert _rel(beta, rb) < TOL_F64 and _rel(u, ru) < TOL_F64
        again = gibbs_kernels.r_block_scan_v((gram, t), pk, K)
        sliced = gibbs_kernels.r_block_scan_v(gram[t].contiguous(), pk, K)
        for other in (again, sliced):
            assert all(torch.equal(x, y) for x, y in zip(other, (beta, u, delta)))


SCAN8_F64 = {  # kind -> (its launch counter, the wrapper, the plain version)
    "gauss": ("gauss_block_scan_v", lambda gt, rt, p: gibbs_kernels.gauss_block_scan_v(gt, p),
              lambda g, r, p: gibbs_kernels.gauss_block_scan_v_plain(g, p)),
    "bc": ("bc_block_scan_v", lambda gt, rt, p: gibbs_kernels.bc_block_scan_v(gt, p),
           lambda g, r, p: gibbs_kernels.bc_block_scan_v_plain(g, p)),
    "bc_w": ("bc_block_scan_wv", gibbs_kernels.bc_block_scan_wv, gibbs_kernels.bc_block_scan_wv_plain),
}


@pytest.mark.parametrize("V", [1, 4, 96])
@pytest.mark.parametrize("B", [8, 40, 256, 1024])
@pytest.mark.parametrize("kind", list(SCAN8_F64))
def test_scan8_f64_kernels_match_plain(dev, kind, B, V):
    """K6's, K8's and K10's float64 instances against their plain versions
    in float64, step-indexed and sliced, every w kept off its threshold:
    delta exactly, beta and u within 1e-12 of their scale, the same bits on
    a second launch, each launch counted as float64 and none as float32."""
    name, scan, plain = SCAN8_F64[kind]
    T = 2
    gram, graw, pk = (x.double() for x in _scan8_inputs(dev, T, V, B, V * 10_000 + B + 3, kind))
    for t in range(T):
        if kind != "gauss":
            pk = _keep_off_threshold(gram[t], graw[t] if kind == "bc_w" else None, pk,
                                     lambda p: plain(gram[t], graw[t], p))
        ref = plain(gram[t], graw[t], pk)
        before = dict(_cuda.LAUNCHES)
        got = scan((gram, t), (graw, t), pk)
        torch.cuda.synchronize()
        assert _cuda.LAUNCHES[name + "_f64"] == before[name + "_f64"] + 1
        assert _cuda.LAUNCHES[name] == before[name]
        assert got[0].dtype == got[1].dtype == torch.float64
        if kind != "gauss":
            assert got[2].dtype == torch.int32 and torch.equal(got[2], ref[2])
            assert (got[2][:, -1] == 0).all() and (got[2][:, 0] == 1).all()
        assert _rel(got[0], ref[0]) < TOL_F64 and _rel(got[1], ref[1]) < TOL_F64
        again = scan((gram, t), (graw, t), pk)
        sliced = scan(gram[t].contiguous(), graw[t].contiguous(), pk)
        for other in (again, sliced):
            assert all(torch.equal(x, y) for x, y in zip(other, got))


F64_METHODS = {  # method -> (its _small_spec method, weighted residual, its scan's launch counter)
    "BayesB": ("BayesB", False, "bc_block_scan_v"), "BayesC": ("BayesC", False, "bc_block_scan_v"),
    "BayesC+D": ("BayesC", True, "bc_block_scan_wv"), "BayesPR": ("BayesPR", False, "gauss_block_scan_v"),
    "BayesLV": ("BayesLV", False, "gauss_block_scan_v"),
}


@pytest.mark.parametrize("method", list(F64_METHODS))
def test_f64_chain_on_the_card(dev, method):
    """A float64 chain of BayesB, BayesC, BayesC+D (weighted residual),
    BayesPR and BayesLV on the card at V = 4 (assemble takes it): K1, its
    scan and K2 run as their float64 instances and no float32 one runs; the
    card chain follows the float64 plain chain on the CPU from the same host
    draws (3 sweeps: beta and ycorr within 1e-9 of scale, delta equal); and
    make_scan_sampler's replays of a float64 KeyedStream give the eager
    chain's bits."""
    base, weighted, scan = F64_METHODS[method]
    spec = _small_spec(base)
    if weighted:
        spec.residual = ngt.RandomEffect(np.random.default_rng(3).uniform(0.5, 2.0, N_SMALL), 1.0)
    V, T = 4, P_SMALL // 32 // 4
    chains = []
    for device in (dev, "cpu"):
        plan, st = ngt.assemble(spec, device=device, dtype=torch.float64, vshards=V)
        sw, hs = ngt.make_sweep(plan), HostStream(4, device, torch.float64)
        before = dict(_cuda.LAUNCHES)
        for _ in range(3):
            st = sw(st, hs)
        ran = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
        if device == dev:
            assert ran[scan + "_f64"] == 3 * T
            assert ran["pack2_matvec_f64"] == (2 if weighted else 1) * 3 * T
            assert ran["pack2_rank_update_f64"] == 3 * T
            assert not any(v for k, v in ran.items() if not k.endswith("_f64"))
        m = st.markers[0]
        chains.append((m.beta.cpu(), m.delta.cpu(), st.ycorr.cpu()))
    assert torch.equal(chains[0][1], chains[1][1])
    assert _rel(chains[0][0], chains[1][0]) < 1e-9 and _rel(chains[0][2], chains[1][2]) < 1e-9
    plan, st0 = ngt.assemble(spec, device=dev, dtype=torch.float64, vshards=V)
    stream = ngt.KeyedStream(21, dev, torch.float64)
    st, draws = ngt.make_scan_sampler(plan, 3, 2)(st0, stream)
    sweep, eager, kept = ngt.make_sweep(plan), st0, []
    for _ in range(3):
        for _ in range(2):
            eager = sweep(eager, stream)
        kept.append(ngt.collect_sample(eager, plan))
    for name, d in draws.items():
        assert torch.equal(d, torch.stack([k[name] for k in kept])), name
    assert torch.equal(st.ycorr, eager.ycorr)


def _f64_spec(kind):
    """The BayesR model of _small_spec on 0..2 dosages (packed, or int8 rows
    under pack2=False) or on float rows."""
    spec = _small_spec("BayesR")
    if kind == "float":
        rng = np.random.default_rng(9)
        g = rng.integers(0, 3, (N_SMALL, P_SMALL)) + rng.uniform(0, 0.5, (N_SMALL, P_SMALL))
        spec.markers = [ngt.MarkerTerm("M", ngt.from_float_array(g), spec.markers[0].prior)]
    return spec


@pytest.mark.parametrize("V", [1, 4])
@pytest.mark.parametrize("kind", ["packed", "int8", "float"])
def test_bayesr_f64_chain_on_the_card(dev, kind, V):
    """A float64 BayesR chain on the card (assemble takes it): on packed rows
    K1, K3 and K2 run as their float64 instances and no float32 one runs;
    on int8 or float rows K3 alone (the passes are products); the card
    chain follows the float64 plain chain on the CPU from the same host
    draws (3 sweeps: beta and ycorr within 1e-9 of scale, delta equal);
    make_scan_sampler's replays of a float64 KeyedStream give the eager
    chain's bits; genomic_values_state (K2' in float64 on packed rows)
    within 1e-12 of scale of genomic_values."""
    spec = _f64_spec(kind)
    pack = False if kind == "int8" else None
    chains = []
    for device in (dev, "cpu"):
        plan, st = ngt.assemble(spec, device=device, dtype=torch.float64, vshards=V, pack2=pack)
        assert st.ycorr.dtype == torch.float64
        sw, hs = ngt.make_sweep(plan), HostStream(4, device, torch.float64)
        before = dict(_cuda.LAUNCHES)
        for _ in range(3):
            st = sw(st, hs)
        ran = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
        if device == dev:
            T = 512 // 32 // V
            assert ran["r_block_scan_v_f64"] == 3 * T
            packed = 3 * T if kind == "packed" else 0
            assert ran["pack2_matvec_f64"] == ran["pack2_rank_update_f64"] == packed
            assert not any(ran[k] for k in ("pack2_matvec", "pack2_rank_update", "r_block_scan_v"))
        chains.append((st.markers[0].beta.cpu(), st.markers[0].delta.cpu(), st.ycorr.cpu()))
    assert torch.equal(chains[0][1], chains[1][1])
    assert _rel(chains[0][0], chains[1][0]) < 1e-9 and _rel(chains[0][2], chains[1][2]) < 1e-9
    plan, st0 = ngt.assemble(spec, device=dev, dtype=torch.float64, vshards=V, pack2=pack)
    stream = ngt.KeyedStream(21, dev, torch.float64)
    st, draws = ngt.make_scan_sampler(plan, 3, 2)(st0, stream)
    sweep, eager, kept = ngt.make_sweep(plan), st0, []
    for _ in range(3):
        for _ in range(2):
            eager = sweep(eager, stream)
        kept.append(ngt.collect_sample(eager, plan))
    for name, d in draws.items():
        assert d.dtype in (torch.float64, torch.int32, torch.int64, torch.bool), name
        assert torch.equal(d, torch.stack([k[name] for k in kept])), name
    assert torch.equal(st.ycorr, eager.ycorr)
    beta = draws["betaM"].mean(0).cpu().numpy()
    host = ngt.genomic_values(spec.markers[0].data, beta)
    card = ngt.genomic_values_state(plan, st, beta=beta).cpu().numpy()
    assert np.abs(card - host).max() / np.abs(host).max() < 1e-12


def test_run_lmem_f64_on_the_card(dev):
    """run_lmem in float64 on the card through the float64 instances, with
    a KeyedStream (replays) and the default PhiloxStream (eager sweeps):
    finite draws, the residual identity within 1e-9 of max|y|."""
    spec = _small_spec("BayesR")
    for stream in (ngt.KeyedStream(3, dev, torch.float64), None):
        before = dict(_cuda.LAUNCHES)
        res = ngt.run_lmem(spec, 20, 10, 2, out_folder=None, device=dev, dtype=torch.float64,
                           vshards=4, stream=stream)
        ran = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
        assert ran["r_block_scan_v_f64"] > 0 and ran["pack2_matvec_f64"] > 0
        assert ran["r_block_scan_v"] == ran["pack2_matvec"] == 0
        assert all(np.isfinite(d).all() for d in res.draws.values())
        st, plan = res.state, ngt.assemble(spec, device=dev, dtype=torch.float64, vshards=4)[0]
        gv = ngt.genomic_values_state(plan, st)
        drift = (st.ycorr - (st.y - st.fixed[0].b[0] - gv)).abs().max() / st.y.abs().max()
        assert drift.item() < 1e-9


# ------------------------------------------------------------------ float64 RE1 and RE2

F64_LEVEL_QS = [1, 33, 1025, 3001]  # one level, one past a group, past the old tile, q not even
TOL_F64 = 1e-12  # of u's scale: float64 sums in the kernel's order and the plain's


@pytest.mark.parametrize("q", F64_LEVEL_QS)
def test_level_scan_f64_matches_plain(dev, q):
    """RE1's float64 instance within 1e-12 of u's scale of the float64
    plain version, the same bits from two launches, counted as
    level_scan_f64 and not as level_scan."""
    from nextgp_tpu_torch.ops import random_scan

    args = [t.double() for t in _level_inputs(q, dev, q)]
    before = dict(_cuda.LAUNCHES)
    out = random_scan.level_scan(*args)
    ref = random_scan.level_scan_plain(*args)
    assert out.dtype == torch.float64 and _rel(out, ref) < TOL_F64
    assert torch.equal(out, random_scan.level_scan(*args))
    assert _cuda.LAUNCHES["level_scan_f64"] == before["level_scan_f64"] + 2
    assert _cuda.LAUNCHES["level_scan"] == before["level_scan"]


@pytest.mark.parametrize("n_t", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("q", F64_LEVEL_QS)
def test_corr_level_scan_f64_matches_plain(dev, q, n_t):
    """RE2's float64 instance, the cooperative form (nT = 1 .. 4, its rule
    built in double in the kernel) and the generic one (5), within 1e-12 of
    u's scale of the float64 plain version, the same bits from two
    launches, counted as corr_level_scan_f64."""
    from nextgp_tpu_torch.ops import random_scan

    args = [t.double() for t in _corr_level_inputs(q, n_t, dev, q + n_t)]
    before = dict(_cuda.LAUNCHES)
    out = random_scan.corr_level_scan(*args)
    ref = random_scan.corr_level_scan_plain(*args)
    assert out.dtype == torch.float64 and out.shape == (n_t, q) and torch.isfinite(out).all()
    assert _rel(out, ref) < TOL_F64
    assert torch.equal(out, random_scan.corr_level_scan(*args))
    assert _cuda.LAUNCHES["corr_level_scan_f64"] == before["corr_level_scan_f64"] + 2
    assert _cuda.LAUNCHES["corr_level_scan"] == before["corr_level_scan"]


def test_level_scan_f64_replayed_takes_the_next_sweep(dev):
    """RE1's float64 instance captured in a CUDA graph with its output copied
    back into u: each replay is the next sweep's scan (the 64-bit marks are
    set inside the graph), with the bits of eager calls on the same inputs."""
    from nextgp_tpu_torch.ops import random_scan

    ivstr, yi, zpz, z, u, ive, ivu = (t.double() for t in _level_inputs(1000, dev, 3))
    eager = [u]
    for _ in range(3):
        eager.append(random_scan.level_scan(ivstr, yi, zpz, z, eager[-1], ive, ivu))
    u_buf = u.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        random_scan.level_scan(ivstr, yi, zpz, z, u_buf, ive, ivu)  # warm up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        u_buf.copy_(random_scan.level_scan(ivstr, yi, zpz, z, u_buf, ive, ivu))
    u_buf.copy_(u)
    for want in eager[1:]:
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(u_buf, want)


def test_corr_level_scan_refuses_mixed_types(dev):
    """RE2 takes every input float32 or every one float64, nothing between."""
    from nextgp_tpu_torch.ops import random_scan

    ivstr, yi, zpz, z, u, var_e, ivu = _corr_level_inputs(40, 2, dev)
    with pytest.raises(ValueError, match="float32"):
        random_scan.corr_level_scan(ivstr.double(), yi, zpz, z, u, var_e, ivu)
    with pytest.raises(ValueError, match="float64"):
        random_scan.corr_level_scan(ivstr.double(), yi.double(), zpz.double(), z.double(), u.double(),
                                    var_e, ivu.double())


def _random_f64_spec(kind):
    """BayesR with an animal effect on a pedigree's A^-1 ("A", _random_spec's
    model), or with an (intercept, slope) animal group on the same A^-1
    ("A2")."""
    from nextgp_tpu_torch.data import pedigree as P

    spec = _random_spec()
    if kind == "A2":
        term = spec.random[0]
        x = np.random.default_rng(10).normal(size=spec.y.shape[0])
        spec.random = [ngt.RandomTerm(("A", "S"), (term.z, term.z * x[:, None]),
                                      prior=ngt.Random("A", np.eye(2) * 0.3), ivstr=term.ivstr)]
    return spec


@pytest.mark.parametrize("kind", ["A", "A2"])
def test_random_f64_chain_on_the_card(dev, kind):
    """A float64 chain of BayesR with an animal effect (RE1) or an
    (intercept, slope) animal group (RE2) on the card (assemble takes it):
    the level scan, K1, K2 and K3 run as their float64 instances and no
    float32 one runs; the card chain follows the float64 plain chain on
    the CPU from the same host draws (3 sweeps: u, beta and ycorr within
    1e-9 of scale, delta equal); make_scan_sampler's replays of a float64
    KeyedStream give the eager chain's bits."""
    spec = _random_f64_spec(kind)
    scan = "level_scan_f64" if kind == "A" else "corr_level_scan_f64"
    chains = []
    for device in (dev, "cpu"):
        plan, st = ngt.assemble(spec, device=device, dtype=torch.float64, vshards=4)
        sw, hs = ngt.make_sweep(plan), HostStream(4, device, torch.float64)
        before = dict(_cuda.LAUNCHES)
        for _ in range(3):
            st = sw(st, hs)
        ran = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
        if device == dev:
            assert ran[scan] == 3 and ran["r_block_scan_v_f64"] > 0
            assert not any(v for k, v in ran.items() if not k.endswith("_f64"))
        chains.append((st.random[0].u.cpu(), st.markers[0].beta.cpu(), st.markers[0].delta.cpu(),
                       st.ycorr.cpu()))
    assert torch.equal(chains[0][2], chains[1][2])
    for i in (0, 1, 3):
        assert _rel(chains[0][i], chains[1][i]) < 1e-9
    plan, st0 = ngt.assemble(spec, device=dev, dtype=torch.float64, vshards=4)
    stream = ngt.KeyedStream(21, dev, torch.float64)
    st, draws = ngt.make_scan_sampler(plan, 3, 2)(st0, stream)
    sweep, eager, kept = ngt.make_sweep(plan), st0, []
    for _ in range(3):
        for _ in range(2):
            eager = sweep(eager, stream)
        kept.append(ngt.collect_sample(eager, plan))
    for name, d in draws.items():
        assert torch.equal(d, torch.stack([k[name] for k in kept])), name
    assert torch.equal(st.ycorr, eager.ycorr)


# ------------------------------------------------------------------ float64 K12, K14, CM1 and CM1r


@pytest.mark.parametrize("V,B,A,K", [
    (96, 256, 3, 3),  # the main path's shape
    (2, 256, 8, 4),  # A * K = 32, the widest rule on a warp
    (3, 1024, 8, 4),  # and the widest block
    (3, 33, 1, 1),  # the skeleton's floor
    (2, 40, 11, 3),  # A * K = 33: the rule on one thread
    (1, 8, 3, 3),  # a single chain (K11, K13), narrower than a warp
])
@pytest.mark.parametrize("kind", ["rcpi", "rcplus"])
def test_rc_scan_f64_kernels_match_plain(dev, kind, V, B, A, K):
    """K12's and K14's float64 instances against their float64 plain
    versions on inputs kept off the CDF edges: beta, u and the real
    per-annotation output within 1e-12 of their scale, delta, acat, cls and
    nz identical, the same bits twice, counted as <name>_f64 alone."""
    _, scan, plain_fn, _, slots, discrete = RC_SCANS[kind]
    gram, pk, gen = _rc_inputs(dev, kind, 1, V, B, A, K, V * 1000 + B + A + K)
    gram, pk = gram.double(), pk.double()
    ref = _keep_off_cdf_edges(pk, lambda p: plain_fn(gram[0], p, A, K), slots(A, K), discrete, gen)
    name = f"{kind}_block_scan_v"
    before = dict(_cuda.LAUNCHES)
    got = scan((gram, 0), pk, A, K)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES[name + "_f64"] == before[name + "_f64"] + 1 and _cuda.LAUNCHES[name] == before[name]
    for i, (x, r) in enumerate(zip(got, ref)):
        if i in discrete:
            assert x.dtype == torch.int32 and torch.equal(x, r), f"output {i}"
        else:
            assert x.dtype == torch.float64 and torch.isfinite(x).all() and _rel(x, r) < TOL_F64, f"output {i}"
    assert all(torch.equal(x, y) for x, y in zip(got, scan((gram, 0), pk, A, K)))


def test_rcpi_scan_f64_kernel_clamps_the_annotation_draw(dev):
    """K12's float64 instance, like its float32 one, draws the last
    annotation for a uniform past the annotation CDF's last entry."""
    V, B, A, K = 2, 16, 3, 3
    gram, pk, _ = _rc_inputs(dev, "rcpi", 1, V, B, A, K, 11)
    gram, pk = gram.double(), pk.double()
    pk[..., 2] = 2.0
    got = gibbs_kernels.rcpi_block_scan_v((gram, 0), pk, A, K)
    ref = gibbs_kernels.rcpi_block_scan_v_plain(gram[0], pk, A, K)
    on = pk[..., 4] != 0
    assert (got[3][on] == A).all() and (got[3][~on] == 0).all()
    assert torch.equal(got[3], ref[3]) and all(torch.isfinite(x).all() for x in got)


@pytest.mark.parametrize("n_t", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("V,B", [(1, 16), (96, 256), (1, 100), (8, 1000)])
def test_corr_block_step_f64_matches_plain(dev, V, B, n_t):
    """CM1's float64 instance (the fast form at nT = 1 .. 4, each cut to its
    float64 shape, and the generic form at 5) at step 1 of two, as
    test_corr_block_step_matches_plain holds the float32 one: beta and u
    within 1e-12 of their scale of the float64 plain block-step, padded
    loci's beta 0, step 0 untouched and never read, the same bits twice,
    counted as corr_block_scan_v_f64 alone."""
    from nextgp_tpu_torch.ops import corr_scan

    G, pk = (x.double() for x in _corr_block_inputs(V, B, n_t, dev, V * B + n_t + 7, pad=3))
    gram = torch.stack([torch.full_like(G, float("nan")), G])
    pk_g = torch.stack([torch.full_like(pk, float("nan")), pk], dim=1).contiguous()
    g = torch.Generator(device=dev).manual_seed(B + n_t)
    r0, cb = (torch.randn(V, B, n_t, generator=g, device=dev, dtype=torch.float64) for _ in range(2))
    cb[:, B - 3:] = 0.0
    r0[:, B - 3:] = 0.0
    sum_y = torch.tensor(2.5, dtype=torch.float64, device=dev)
    beta = torch.full((V, 2, B, n_t), 7.0, dtype=torch.float64, device=dev)
    ref = beta.clone()
    before = dict(_cuda.LAUNCHES)
    u = corr_scan.corr_block_step((gram, 1), pk_g, r0, cb, sum_y, beta)
    ru = corr_scan.corr_block_step_plain(G, pk_g, 1, r0, cb, sum_y, ref)
    assert u.dtype == torch.float64 and torch.isfinite(beta).all() and torch.isfinite(u).all()
    assert _rel(beta[:, 1], ref[:, 1]) < TOL_F64 and _rel(u, ru) < TOL_F64
    assert (beta[:, 1, B - 3:] == 0).all() and (beta[:, 0] == 7.0).all()
    b1 = beta.clone()
    assert torch.equal(u, corr_scan.corr_block_step((gram, 1), pk_g, r0, cb, sum_y, beta))
    assert torch.equal(beta, b1)
    assert _cuda.LAUNCHES["corr_block_scan_v_f64"] == before["corr_block_scan_v_f64"] + 2
    assert _cuda.LAUNCHES["corr_block_scan_v"] == before["corr_block_scan_v"]


@pytest.mark.parametrize("n_t", [1, 2, 3, 4])
def test_corr_rule_f64_matches_pack(dev, n_t):
    """CM1r's float64 instance on 4,096 loci against the float64 torch pack:
    adj, c and M within 1e-12 of their scale, bold copied, padded loci's c
    and M 0, the same bits twice, counted as corr_rule_f64 alone; a locus
    whose lhs is not positive definite gives NaN in its c."""
    from nextgp_tpu_torch.ops import corr_scan

    args = [a.double() if a.is_floating_point() else a for a in _corr_rule_inputs(4096, n_t, dev, 40 + n_t)]
    before = dict(_cuda.LAUNCHES)
    pk = corr_scan.corr_rule(*args)
    ref = corr_scan.corr_rule_plain(*args)
    assert pk.dtype == torch.float64 and pk.shape == ref.shape and torch.isfinite(pk).all()
    for sl in (slice(0, n_t), slice(2 * n_t, 3 * n_t), slice(3 * n_t, None)):
        assert _rel(pk[:, sl], ref[:, sl]) < TOL_F64
    assert torch.equal(pk[:, n_t:2 * n_t], args[0]) and (pk[-4:, 2 * n_t:] == 0).all()
    assert torch.equal(pk, corr_scan.corr_rule(*args))
    assert _cuda.LAUNCHES["corr_rule_f64"] == before["corr_rule_f64"] + 2
    assert _cuda.LAUNCHES["corr_rule"] == before["corr_rule"]
    args[4] = args[4].clone()
    args[4][40] = -1e3 * torch.eye(n_t, dtype=torch.float64, device=dev)
    pk = corr_scan.corr_rule(*args)
    others = torch.arange(4096, device=dev) != 40
    assert torch.isnan(pk[40, 2 * n_t:3 * n_t]).any() and torch.isfinite(pk[others]).all()


def test_corr_block_step_smem_matches_the_library(dev):
    """CM1's shared memory as the library states it
    (ngt_corr_block_step_smem_bytes) equals ops/corr_scan's counterpart at
    every nT, B and type, and fits a block."""
    from nextgp_tpu_torch.ops import corr_scan

    lib = _cuda.lib()
    for n_t in range(1, 6):
        for B in (1, 16, 64, 65, 96, 256, 257, 1000, 1024):
            for f64 in (0, 1):
                need = corr_scan.block_step_smem_bytes(n_t, B, 8 if f64 else 4)
                assert lib.ngt_corr_block_step_smem_bytes(n_t, B, f64) == need <= gibbs_kernels.SMEM_BYTES


def test_corr_wrappers_refuse_mixed_types(dev):
    """CM1 and CM1r take every value float32 or every one float64, nothing
    between and no float16."""
    from nextgp_tpu_torch.ops import corr_scan

    args = list(_corr_rule_inputs(64, 2, dev, 3))
    with pytest.raises(ValueError, match="corr_rule: every value float32, or every one float64"):
        corr_scan.corr_rule(args[0].double(), *args[1:])
    with pytest.raises(ValueError, match="corr_rule: every value float32, or every one float64"):
        corr_scan.corr_rule(*[a.half() if a.is_floating_point() else a for a in args])
    G, pk = _corr_block_inputs(2, 32, 2, dev)
    zero = torch.zeros((2, 32, 2), device=dev)
    beta = torch.zeros((2, 1, 32, 2), device=dev)
    with pytest.raises(ValueError, match="corr_block_step: every value float32, or every one float64"):
        corr_scan.corr_block_step((G[None].double(), 0), pk[:, None].double(), zero, zero,
                                  torch.zeros((), device=dev), beta.double())
    with pytest.raises(ValueError, match="corr_block_step: every value float32, or every one float64"):
        corr_scan.corr_block_step((G[None], 0), pk[:, None], zero, zero, torch.zeros((), device=dev),
                                  beta.double())


@pytest.mark.parametrize("method", ["BayesRCpi", "BayesRCplus", "MultiBreed"])
def test_f64_annotation_and_corr_chains_on_the_card(dev, method):
    """A float64 chain of BayesRCpi, BayesRCplus or MultiBreed (two
    correlated BayesPR marker sets) on the card at V = 4 (assemble takes
    it): the scan (K12, K14, or CM1 with its rule CM1r), K1 and K2 run as
    their float64 instances and no float32 one runs; the card chain follows
    the float64 plain chain on the CPU from the same host draws (3 sweeps:
    beta and ycorr within 1e-9 of scale, delta equal); make_scan_sampler's
    replays of a float64 KeyedStream give the eager chain's bits."""
    corr = method == "MultiBreed"
    spec = _corr_specs()[0] if corr else _small_spec(method)
    scan = {"BayesRCpi": "rcpi_block_scan_v", "BayesRCplus": "rcplus_block_scan_v",
            "MultiBreed": "corr_block_scan_v"}[method]
    V, T = 4, 256 // 32 // 4 if corr else P_SMALL // 32 // 4
    chains = []
    for device in (dev, "cpu"):
        plan, st = ngt.assemble(spec, device=device, dtype=torch.float64, vshards=V)
        sw, hs = ngt.make_sweep(plan), HostStream(4, device, torch.float64)
        before = dict(_cuda.LAUNCHES)
        for _ in range(3):
            st = sw(st, hs)
        ran = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
        if device == dev:
            assert ran[scan + "_f64"] == 3 * T and ran["pack2_rank_update_f64"] == 3 * T
            assert not corr or ran["corr_rule_f64"] == 3
            assert not any(v for k, v in ran.items() if not k.endswith("_f64"))
        m = st.corr_markers[0] if corr else st.markers[0]
        chains.append((m.beta.cpu(), None if corr else m.delta.cpu(), st.ycorr.cpu()))
    assert corr or torch.equal(chains[0][1], chains[1][1])
    assert _rel(chains[0][0], chains[1][0]) < 1e-9 and _rel(chains[0][2], chains[1][2]) < 1e-9
    plan, st0 = ngt.assemble(spec, device=dev, dtype=torch.float64, vshards=V)
    stream = ngt.KeyedStream(21, dev, torch.float64)
    st, draws = ngt.make_scan_sampler(plan, 3, 2)(st0, stream)
    sweep, eager, kept = ngt.make_sweep(plan), st0, []
    for _ in range(3):
        for _ in range(2):
            eager = sweep(eager, stream)
        kept.append(ngt.collect_sample(eager, plan))
    for name, d in draws.items():
        assert torch.equal(d, torch.stack([k[name] for k in kept])), name
    assert torch.equal(st.ycorr, eager.ycorr)


# ------------------------------------------------------------------ vshards="auto" on the card

N_AUTO, P_AUTO = 2_000, 2_048  # records enough that "auto" gives BayesR a V > 1 in blocks of 32


@pytest.mark.parametrize("method", ["BayesR", "BayesC", "MultiBreed"])
def test_auto_vshards_on_the_card(dev, method):
    """vshards="auto" on the card: a single marker set takes _card_vshards
    for its blocks, records and method (BayesR a V > 1, BayesC at most its
    cap), a correlated set V = 1; each plan records the V it resolved to as
    the V asked for."""
    from nextgp_tpu_torch.engine import plan as t_plan

    if method == "MultiBreed":
        plan, _ = ngt.assemble(_corr_specs()[0], device=dev, vshards="auto")
        cp = plan.corr_markers[0]
        assert cp.n_blocks > 1 and cp.vshards == cp.vshards_asked == 1
        return
    plan, _ = ngt.assemble(_small_spec(method, N_AUTO, P_AUTO), device=dev, vshards="auto")
    mp = plan.markers[0]
    want = t_plan._card_vshards(mp.n_blocks, mp.block, N_AUTO, method)
    assert mp.vshards == mp.vshards_asked == want
    assert want > 1 if method == "BayesR" else want <= t_plan._CARD_VSHARDS_CAP.get(method, 1)


def test_run_lmem_default_runs_the_card_rule(dev):
    """run_lmem with its default vshards on BayesR runs at the rule's V > 1:
    K1, K3 and K2 launched n_chain * nb / V times (eager sweeps)."""
    before = dict(_cuda.LAUNCHES)
    res = ngt.run_lmem(_small_spec("BayesR", N_AUTO, P_AUTO), 10, 4, 2, out_folder=None, device=dev)
    ran = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    mp = res.plan.markers[0]
    assert mp.vshards > 1
    assert ran["r_block_scan_v"] == ran["pack2_matvec"] == ran["pack2_rank_update"] == 10 * (mp.n_blocks // mp.vshards)


def test_checkpoint_at_one_is_refused_under_auto_on_the_card(dev, tmp_path):
    """A checkpoint taken at V = 1 does not resume under "auto" on the card,
    which gives BayesR another V: the plan's fingerprint refuses it and the
    message says why."""
    spec = _small_spec("BayesR", N_AUTO, P_AUTO)
    kw = dict(n_chain=8, n_burn=2, n_thin=2, device=dev, out_folder=str(tmp_path / "out"), checkpoint_every=1)
    ngt.run_lmem(spec, vshards=1, **{**kw, "n_chain": 4})
    with pytest.raises(ValueError, match=r"block chains \(V\) differ\. A chain is not continued at another V"):
        ngt.run_lmem(spec, resume=True, **kw)
