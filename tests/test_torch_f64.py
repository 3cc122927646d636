"""The float64 instances of K1, K2, K3, K6, K8, K10, K12, K14, RE1, RE2,
CM1 and CM1r as far as the CPU reaches them: the shapes and sizes their
wrappers compute (K2's float64 grid, the scans', the level scans' and CM1's
float64 shared memory), the CPU path of every wrapper in float64 (the plain
version, no launch), and the launch counters that tell a float64 launch
from a float32 one. The kernels themselves run in tests/test_torch_cuda.py
on the card; float64 chains of BayesR, BayesB, BayesC, BayesC with a
weighted residual, BayesPR, BayesLV, BayesRCpi and BayesRCplus on the CPU
are held to the JAX package by tests/test_torch_sweep.py
(`test_five_sweeps_match` and its cases), the float64 level scans' samplers
by tests/test_torch_random.py (`test_sample_random_uni_matches`) and
tests/test_torch_corr.py (`test_single_stages_match`,
`test_four_sweeps_match`, which hold correlated marker sets too)."""
import numpy as np
import pytest
import torch

from nextgp_tpu_torch.ops import _cuda, corr_scan, gibbs_kernels, pack2, random_scan


@pytest.mark.parametrize("rows,q", [(1, 16), (255, 240), (511, 256), (512, 272), (513, 528),
                                    (24_576, 2_560), (24_576, 12_544), (1000, 25_088)])
def test_rank_grid_f64_covers_the_panel(rows, q):
    """K2's float64 grid: column tiles of RANK_TILE_F64 (256) bytes cover the
    q bytes with less than one tile to spare, twice the float32 grid's
    tiles (within one), and the same row slices."""
    tiles, slices = pack2.rank_grid(rows, q, torch.float64)
    assert pack2.RANK_TILE_F64 == 256 == pack2.RANK_TILE // 2
    assert (tiles - 1) * pack2.RANK_TILE_F64 < q <= tiles * pack2.RANK_TILE_F64
    tiles32, slices32 = pack2.rank_grid(rows, q)
    assert slices == slices32 and 2 * tiles32 - 1 <= tiles <= 2 * tiles32
    assert pack2.rank_grid(rows, q, torch.float32) == (tiles32, slices32)


@pytest.mark.parametrize("B,K,need,fits", [
    (256, 4, 31_232, True),  # the main path's shape
    (1024, 8, 45_568, True),  # the largest rule in one lane
    (1024, 9, 25_864, True),  # the serial rule
    (1024, 16, 26_368, True),
    (32, 3500, 269_280, False),  # fits in float32 (134,640 bytes), not in float64
    (32, 6_600, 492_480, False),
])
def test_r_scan_f64_shared_memory_need(B, K, need, fits):
    """K3's float64 instance takes 8 bytes for every element of the float32
    instance's layout: the u's, the two Gram tile slots and the rule's rows."""
    assert gibbs_kernels.r_scan_smem_bytes(B, K, 8) == need == 2 * gibbs_kernels.r_scan_smem_bytes(B, K)
    assert (need <= gibbs_kernels.SMEM_BYTES) == fits


@pytest.mark.parametrize("B", [32, 256, 1024])
@pytest.mark.parametrize("grams", [1, 2])
def test_scan8_f64_shared_memory_need(B, grams):
    """K6, K8 (one Gram) and K10's (two) float64 instances take 8 bytes for
    every element of the float32 instances' layout: the u's, the two Gram
    tile slots and two groups' rows. K10 in float64 at B = 1,024 needs
    46,080 bytes, well within a block's shared memory."""
    need = gibbs_kernels.scan8_smem_bytes(B, grams, 8)
    assert need == 2 * gibbs_kernels.scan8_smem_bytes(B, grams)
    assert need == 8 * (B + 2 * grams * 32 * 33 + 2 * 32 * 8)
    assert need <= 46_080 < gibbs_kernels.SMEM_BYTES


@pytest.mark.parametrize("kind", ["gauss", "bc", "bc_w"])
def test_cpu_scan8_wrappers_take_float64_as_the_plain_versions(kind):
    """On CPU tensors the wrappers of K6, K8 and K10 are their plain
    versions in float64, step-indexed or on one block, and count no
    launch."""
    rng = np.random.default_rng(5)
    V, B = 3, 40
    gram = torch.from_numpy(rng.normal(size=(2, B, V, B))) / B
    graw = torch.from_numpy(rng.normal(size=(2, B, V, B))) / B
    pk = torch.from_numpy(rng.normal(size=(V, B, 8)))
    pk[..., 3] = -0.3 * pk[..., 3].abs()
    pk[:, -1, 2] = float("inf")  # a padded locus
    before = dict(_cuda.LAUNCHES)
    if kind == "gauss":
        got = gibbs_kernels.gauss_block_scan_v((gram, 1), pk)
        ref = gibbs_kernels.gauss_block_scan_v_plain(gram[1], pk)
        one = gibbs_kernels.gauss_block_scan_v(gram[1], pk)
    elif kind == "bc":
        got = gibbs_kernels.bc_block_scan_v((gram, 1), pk)
        ref = gibbs_kernels.bc_block_scan_v_plain(gram[1], pk)
        one = gibbs_kernels.bc_block_scan_v(gram[1], pk)
    else:
        got = gibbs_kernels.bc_block_scan_wv((gram, 1), (graw, 1), pk)
        ref = gibbs_kernels.bc_block_scan_wv_plain(gram[1], graw[1], pk)
        one = gibbs_kernels.bc_block_scan_wv(gram[1], graw[1], pk)
    assert got[0].dtype == got[1].dtype == torch.float64
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(one, ref))
    if kind != "gauss":
        assert got[2].dtype == torch.int32 and (got[2][:, -1] == 0).all()
    assert _cuda.LAUNCHES == before


def test_cpu_wrappers_take_float64_as_the_plain_versions():
    """On CPU tensors every wrapper is its plain version, in float64 as in
    float32, and counts no launch."""
    rng = np.random.default_rng(4)
    rows, n, V, B, K = 12, 70, 3, 16, 4
    pk = torch.from_numpy(pack2.pack2_np(rng.integers(0, 3, (n, 2 * rows), dtype=np.int8)))
    q = pk.shape[1]
    y4 = torch.from_numpy(rng.normal(size=(4, q)))
    u = torch.from_numpy(rng.normal(size=rows))
    gram = torch.from_numpy(rng.normal(size=(2, B, V, B))) / B
    rows_k = torch.zeros(V, B, 8 + 4 * K, dtype=torch.float64)
    rows_k[..., 0] = torch.from_numpy(rng.normal(size=(V, B)))
    rows_k[..., 2] = torch.from_numpy(rng.uniform(size=(V, B)))
    rows_k[..., 3] = 1.0
    rows_k[..., 8 + K + 1:8 + 2 * K] = 0.3
    rows_k[..., 8 + 2 * K + 1:8 + 3 * K] = 0.2
    before = dict(_cuda.LAUNCHES)
    r0 = pack2.matvec_step(pk, 1, y4, rows)
    dy = pack2.rank_update_step(pk, 1, u)
    assert r0.dtype == dy.dtype == torch.float64
    assert torch.equal(r0, pack2.matvec_plain(pk[rows:], y4))
    assert torch.equal(dy, pack2.rank_update_plain(pk[rows:], u))
    got = gibbs_kernels.r_block_scan_v((gram, 1), rows_k, K)
    ref = gibbs_kernels.r_block_scan_v_plain(gram[1], rows_k, K)
    assert got[0].dtype == torch.float64 and all(torch.equal(a, b) for a, b in zip(got, ref))
    assert _cuda.LAUNCHES == before


def test_launch_counters_tell_float64_from_float32():
    """K1, K2, K3, K6, K8, K10, K12, K14, RE1, RE2, CM1 and CM1r count their
    float64 launches apart (`<name>_f64`), so a run can show which instance
    its path went through; no other kernel has a float64 counter of its
    own."""
    f64 = sorted(k for k in _cuda.LAUNCHES if k.endswith("_f64"))
    assert f64 == ["bc_block_scan_v_f64", "bc_block_scan_wv_f64", "corr_block_scan_v_f64",
                   "corr_level_scan_f64", "corr_rule_f64", "gauss_block_scan_v_f64", "level_scan_f64",
                   "pack2_matvec_f64", "pack2_rank_update_f64", "r_block_scan_v_f64",
                   "rcpi_block_scan_v_f64", "rcplus_block_scan_v_f64"]
    assert all(k.removesuffix("_f64") in _cuda.LAUNCHES for k in f64)


# RE1 (n_t = 0) and RE2's cooperative form (n_t = 1 .. 4): the scan launch's
# shared memory in the float32 instances before float64 existed (kScanSmem
# and coop_smem<NT> of csrc/level_scan.cu), and in the float64 instances
LEVEL_SMEM = {(0, 4): 199_936, (1, 4): 199_488, (2, 4): 209_792, (3, 4): 224_576, (4, 4): 209_536,
              (0, 8): 216_960, (1, 8): 216_448, (2, 8): 228_992, (3, 8): 188_416, (4, 8): 204_800}


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("n_t", [0, 1, 2, 3, 4], ids=["RE1", "nT=1", "nT=2", "nT=3", "nT=4"])
def test_level_scan_shared_memory_need(n_t, itemsize):
    """Each instance's need fits the 232,448 bytes an H100 block may opt in
    to; float32's equals the need before the float64 instances (its ring of
    7 slots, 6 at nT = 4); float64's ring is shallower (4 slots at nT <= 2,
    3 at nT = 3 and 4, where the owners' staging decides the need)."""
    need = random_scan.level_scan_smem_bytes(n_t, itemsize)
    assert need == LEVEL_SMEM[(n_t, itemsize)]
    assert need <= random_scan.SMEM_LIMIT == gibbs_kernels.SMEM_BYTES
    assert random_scan.level_scan_smem_bytes(5, itemsize) == 0  # RE2's generic form


def test_cpu_level_scan_takes_float64_as_the_plain_version():
    """On float64 CPU tensors RE1's wrapper is its plain version and counts
    no launch."""
    rng = np.random.default_rng(6)
    q = 70
    m = rng.normal(size=(q, q)) / q ** 0.5
    ivstr = torch.from_numpy(m @ m.T + np.eye(q))
    yi, z, u = (torch.from_numpy(rng.normal(size=q)) for _ in range(3))
    zpz = torch.from_numpy(rng.uniform(0, 3, q))
    ive, ivu = torch.tensor(1.7, dtype=torch.float64), torch.tensor(0.6, dtype=torch.float64)
    before = dict(_cuda.LAUNCHES)
    got = random_scan.level_scan(ivstr, yi, zpz, z, u, ive, ivu)
    assert got.dtype == torch.float64
    assert torch.equal(got, random_scan.level_scan_plain(ivstr, yi, zpz, z, u, ive, ivu))
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("n_t", [1, 2, 3, 4, 5])
def test_cpu_corr_level_scan_takes_float64_as_the_plain_version(n_t):
    """On float64 CPU tensors RE2's wrapper (nT = 1 .. 4, the cooperative
    form's on the card, and 5, the generic form's) is its plain version and
    counts no launch."""
    rng = np.random.default_rng(7 + n_t)
    q = 45
    m = rng.normal(size=(q, q)) / q ** 0.5
    ivstr = torch.from_numpy(m @ m.T + np.eye(q))
    x = rng.normal(size=(q, 3, n_t))
    zpz = torch.from_numpy(np.einsum("lkt,lku->ltu", x, x) + 0.1 * np.eye(n_t))
    yi, u = (torch.from_numpy(rng.normal(size=(n_t, q))) for _ in range(2))
    z = torch.from_numpy(rng.normal(size=(q, n_t)))
    a = rng.normal(size=(n_t, n_t))
    ivu = torch.from_numpy(np.linalg.inv(a @ a.T / n_t + np.eye(n_t)))
    var_e = torch.tensor(1.7, dtype=torch.float64)
    before = dict(_cuda.LAUNCHES)
    got = random_scan.corr_level_scan(ivstr, yi, zpz, z, u, var_e, ivu)
    assert got.dtype == torch.float64 and got.shape == (n_t, q) and torch.isfinite(got).all()
    assert torch.equal(got, random_scan.corr_level_scan_plain(ivstr, yi, zpz, z, u, var_e, ivu))
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("B,A,K,sections,need", [
    (256, 3, 3, 8, 117_248),  # the main path's shape, K12
    (256, 3, 3, 6, 117_248),  # K14: the same staged Coefs
    (1024, 8, 4, 8, 123_392),  # the largest shape phase 3 runs, A * K = 32: the rule on a warp
    (1024, 11, 3, 8, 29_792),  # A * K = 33: the serial rule's scratch and two rows
    (256, 16, 4, 6, 25_856),  # K14's serial rule, A * K = 64
    (32, 500, 16, 8, 1_109_280),  # rows that fit in no block
])
def test_rc_scan_f64_shared_memory_need(B, A, K, sections, need):
    """K12's and K14's float64 instances take 8 bytes for every element of
    the float32 instances' layout: the u's, the two Gram tile slots, and
    two groups' staged coefficients (A * K <= 32) or the serial rule's
    scratch and two rows; every shape the scans run fits a block."""
    got = gibbs_kernels.rc_scan_smem_bytes(B, A, K, sections, 8)
    assert got == need == 2 * gibbs_kernels.rc_scan_smem_bytes(B, A, K, sections)
    assert (need <= gibbs_kernels.SMEM_BYTES) == (A < 500)


# CM1's fast form at B = 256 and 1,024: the float32 bytes are the layout's
# before float64 existed (three slots up to nT = 2, two at 3, one at 4; far
# buffers up to nT = 2 at 96 .. 256 loci); the float64 shapes are cut to fit
CM1_SMEM = {
    (1, 256, 4): 55_696, (2, 256, 4): 211_984, (3, 256, 4): 159_632, (4, 256, 4): 142_352,
    (1, 1024, 4): 31_120, (2, 1024, 4): 113_680, (3, 1024, 4): 168_848, (4, 1024, 4): 154_640,
    (1, 256, 8): 111_392, (2, 256, 8): 215_072, (3, 256, 8): 163_104, (4, 256, 8): 153_632,
    (1, 1024, 8): 62_240, (2, 1024, 8): 227_360, (3, 1024, 8): 181_536, (4, 1024, 8): 178_208,
}


@pytest.mark.parametrize("itemsize", [4, 8], ids=["float32", "float64"])
@pytest.mark.parametrize("B", [256, 1024])
@pytest.mark.parametrize("n_t", [1, 2, 3, 4])
def test_corr_block_step_shared_memory_need(n_t, B, itemsize):
    """CM1's fast form needs what its layout states at every nT <= 4, in
    both types, and fits the 232,448 bytes a block may opt in to; float64
    would not fit as float32 lays it out at nT = 2 (far buffers), 3 (two
    slots) and 4 (a slot with the next group's columns). The generic form
    (nT = 5) takes none."""
    need = corr_scan.block_step_smem_bytes(n_t, B, itemsize)
    assert need == CM1_SMEM[(n_t, B, itemsize)] <= gibbs_kernels.SMEM_BYTES == 232_448
    if itemsize == 8 and (n_t, B) in {(2, 256), (3, 256), (4, 256)}:
        assert 2 * CM1_SMEM[(n_t, B, 4)] > gibbs_kernels.SMEM_BYTES
    assert corr_scan.block_step_smem_bytes(5, B, itemsize) == 0


def _rc_rows(kind, V, B, A, K, seed):
    """A float64 Gram block (B, V, B) and coefficient rows from the port's
    own pack (the first annotation on every locus, the last locus of each
    chain padded)."""
    rng = np.random.default_rng(seed)
    p = V * B
    x = rng.normal(size=(V, B, 64))
    gram = torch.from_numpy(np.einsum("vbn,vcn->bvc", x, x) / 64)
    mask = torch.from_numpy(np.tile(np.arange(B) < B - 1, V))
    anz = torch.from_numpy(rng.uniform(size=(p, A)) < 0.5)
    anz[:, 0] = True
    anz &= mask[:, None]
    varc = torch.from_numpy(rng.uniform(0.5, 2.0, (A, 1)) * np.r_[0.0, rng.uniform(1e-3, 0.1, K - 1)])
    logpi = torch.log_softmax(torch.from_numpy(rng.normal(size=(A, K))), dim=-1)

    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape))

    common = dict(beta_old=0.1 * f(p) * mask, mpm=torch.einsum("bvb->vb", gram).reshape(-1) * mask,
                  lss=torch.from_numpy(rng.uniform(size=p)), rss=0.1 * f(p), mask=mask, varc=varc,
                  logpi=logpi, ive=torch.tensor(0.7, dtype=torch.float64),
                  var_e=torch.tensor(1 / 0.7, dtype=torch.float64))
    if kind == "rcpi":
        aprob = anz / anz.sum(-1, keepdim=True).clamp(min=1)
        pk = gibbs_kernels.rcpi_block_pack(
            z=f(p), ua=torch.from_numpy(rng.uniform(size=p)), uv=torch.from_numpy(rng.uniform(size=p)),
            g1=torch.from_numpy(rng.gamma(1.0, size=(p, A))), g2=torch.from_numpy(rng.gamma(2.0, size=(p, A))),
            aprob=aprob.double(), anz=anz, **common)
    else:
        pk = gibbs_kernels.rcplus_block_pack(z=f(p, A), ua=torch.from_numpy(rng.uniform(size=(p, A))), anz=anz,
                                             **common)
    return gram, pk.reshape(V, B, -1).contiguous()


@pytest.mark.parametrize("A,K", [(3, 3), (1, 1), (11, 3)], ids=["warp", "floor", "serial"])
@pytest.mark.parametrize("kind", ["rcpi", "rcplus"])
def test_cpu_rc_wrappers_take_float64_as_the_plain_versions(kind, A, K):
    """On float64 CPU tensors the wrappers of K12 and K14 are their plain
    versions, step-indexed or on one block, with float64 real outputs and
    int32 discrete ones, and count no launch."""
    V, B = 3, 40
    gram, pk = _rc_rows(kind, V, B, A, K, 11 + A + K)
    steps = torch.stack([torch.zeros_like(gram), gram])
    scan = getattr(gibbs_kernels, f"{kind}_block_scan_v")
    plain = getattr(gibbs_kernels, f"{kind}_block_scan_v_plain")
    before = dict(_cuda.LAUNCHES)
    got, one, ref = scan((steps, 1), pk, A, K), scan(gram, pk, A, K), plain(gram, pk, A, K)
    assert got[0].dtype == got[1].dtype == torch.float64 and got[2].dtype == torch.int32
    assert all(torch.isfinite(x).all() for x in got)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert all(torch.equal(a, b) for a, b in zip(one, ref))
    assert (got[2][:, -1] == 0).all()
    assert _cuda.LAUNCHES == before


@pytest.mark.parametrize("n_t", [1, 2, 4, 5])
def test_cpu_corr_wrappers_take_float64_as_the_plain_versions(n_t):
    """On float64 CPU tensors CM1r's wrapper (corr_rule) and CM1's
    (corr_block_step) are their plain versions: the packed rows, and the
    block-step's u and beta written at its step of the buffer, the other
    step untouched; no launch is counted."""
    rng = np.random.default_rng(20 + n_t)
    V, T, B, n_regions = 2, 2, 24, 3
    p = V * T * B

    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape))

    x = f(p, 30, n_t)
    mpm = torch.einsum("lkt,lku->ltu", x, x).contiguous()
    m = f(n_regions, n_t, n_t)
    var_beta = (m @ m.transpose(1, 2) / n_t * 0.01 + 0.01 * torch.eye(n_t, dtype=torch.float64)).contiguous()
    region = torch.from_numpy(rng.integers(0, n_regions, p).astype(np.int32))
    mask = torch.arange(p) % B < B - 2
    rule = (0.1 * f(p, n_t), f(p, n_t), var_beta, region, mpm, mask, torch.tensor(1.3, dtype=torch.float64))
    before = dict(_cuda.LAUNCHES)
    pk = corr_scan.corr_rule(*rule)
    assert pk.dtype == torch.float64 and torch.isfinite(pk).all()
    assert torch.equal(pk, corr_scan.corr_rule_plain(*rule))
    X = f(V, B, n_t, 50)
    G = torch.einsum("vjtn,vkwn->jtvkw", X, X).contiguous()
    gram = torch.stack([torch.full_like(G, float("nan")), G])
    pk_g = pk.view(V, T, B, -1)
    r0, cb = f(V, B, n_t), f(V, B, n_t)
    sum_y = torch.tensor(2.5, dtype=torch.float64)
    beta, ref = (torch.full((V, T, B, n_t), 7.0, dtype=torch.float64) for _ in range(2))
    u = corr_scan.corr_block_step((gram, 1), pk_g, r0, cb, sum_y, beta)
    ru = corr_scan.corr_block_step_plain(G, pk_g, 1, r0, cb, sum_y, ref)
    assert u.dtype == beta.dtype == torch.float64 and torch.isfinite(u).all()
    assert torch.equal(u, ru) and torch.equal(beta, ref) and (beta[:, 0] == 7.0).all()
    assert _cuda.LAUNCHES == before
