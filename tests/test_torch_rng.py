"""The port's keyed random stream (`KeyedStream`) on the CPU, through its
plain version (the card's kernel, csrc/keyed_rng.cu, is held to it in
tests/test_torch_cuda.py and chip_smoke.py).

The key a KeyedStream folds from a device sweep counter equals
`site_seed(seed, site)`, the 63-bit seed PhiloxStream uses, exactly, for
random sites with paths; draws at a site do not depend on the order of
calls; 10^6 normals and uniforms have the mean and variance of N(0, 1) and
U(0, 1] within five standard errors; gammas pass a two-sample KS test
against scipy.stats.gamma at p > 1e-3 from fixed seeds, over the shapes the
samplers draw (Dirichlet's counts + 1 from 1 up, the residual's
(df + n) / 2 in the thousands, and annotation shapes below 1).
"""
import numpy as np
import pytest
import scipy.stats
import torch

from nextgp_tpu_torch.engine import rng as R
from nextgp_tpu_torch.engine.rng import KeyedStream, Site, site_key_plain, site_seed, site_tail


def _random_sites(rs, n, depth):
    for _ in range(n):
        path = tuple((int(k), int(rs.integers(0, k))) for k in rs.integers(2, 8, size=depth))
        yield (int(rs.integers(0, 2 ** 63)),
               Site(int(rs.integers(-3, 10 ** 7)), int(rs.integers(0, 10)), int(rs.integers(0, 64)),
                    path))


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_plain_key_is_site_seed(depth):
    """The key folded from a counter tensor equals site_seed for 300 random
    sites at each path depth (1,200 in all): seeds, sweeps and indices of
    every size the uint64 arithmetic wraps on."""
    rs = np.random.default_rng(100 + depth)
    for seed, site in _random_sites(rs, 300, depth):
        key = site_key_plain(R._splitmix64(seed & R._MASK64), torch.tensor(site.sweep), site_tail(site))
        assert key.dtype == torch.int64 and int(key) == site_seed(seed, site), (seed, site)


def test_counter_names_the_sweep():
    """A site that carries a counter draws at the counter's sweep, whatever
    its host sweep says; without one at the host sweep."""
    s = KeyedStream(11, "cpu", torch.float64)
    at3 = s.normal(Site(3, 4, 1), (64,))
    assert torch.equal(s.normal(Site(99, 4, 1, counter=torch.tensor(3)), (64,)), at3)
    assert not torch.equal(s.normal(Site(3, 4, 1, counter=torch.tensor(4)), (64,)), at3)


@pytest.mark.parametrize("kind", ["normal", "uniform", "gamma"])
def test_draws_do_not_depend_on_call_order(kind):
    s = KeyedStream(7, "cpu", torch.float64)
    sites = [Site(5, 4, 0, ((4, i),)) for i in range(4)] + [Site(6, 0), Site(5, 1, 2)]
    alpha = torch.linspace(0.2, 40.0, 300, dtype=torch.float64)

    def draw(site):
        return s.gamma(site, alpha) if kind == "gamma" else getattr(s, kind)(site, (300,))

    forward = [draw(x) for x in sites]
    backward = [draw(x) for x in reversed(sites)][::-1]
    assert all(torch.equal(a, b) for a, b in zip(forward, backward))
    assert len({tuple(d[:4].tolist()) for d in forward}) == len(sites)  # distinct sites differ


def test_float32_rounds_the_float64_draws():
    """The stream computes in float64 and rounds to its dtype at the end, as
    the kernel does: uniforms are the same numbers, the rest their
    roundings."""
    s64, s32 = KeyedStream(2, "cpu", torch.float64), KeyedStream(2, "cpu", torch.float32)
    site = Site(1, 4, 0)
    assert torch.equal(s32.uniform(site, (500,)).double(), s64.uniform(site, (500,)))
    assert torch.equal(s32.normal(site, (500,)), s64.normal(site, (500,)).float())
    a = torch.linspace(0.3, 900.0, 500, dtype=torch.float64)
    assert torch.equal(s32.gamma(site, a.float()), s64.gamma(site, a.float().double()).float())


@pytest.mark.parametrize("kind", ["normal", "uniform"])
def test_moments_of_a_million_draws(kind):
    """Mean and variance of 10^6 draws within five standard errors."""
    n = 10 ** 6
    x = getattr(KeyedStream(3, "cpu", torch.float64), kind)(Site(1, 4, 0), (n,))
    mean, var = (0.0, 1.0) if kind == "normal" else (0.5, 1.0 / 12.0)
    m4 = 3.0 if kind == "normal" else 1.0 / 80.0  # fourth central moment
    assert abs(x.mean().item() - mean) < 5 * (var / n) ** 0.5
    assert abs(x.var().item() - var) < 5 * ((m4 - var * var) / n) ** 0.5
    if kind == "uniform":
        assert 0.0 < x.min().item() and x.max().item() <= 1.0


@pytest.mark.parametrize("alpha", [0.3, 1.0, 2.5, 50.0, 5000.0])
def test_gamma_matches_scipy(alpha):
    """Two-sample KS against scipy.stats.gamma(alpha), 20,000 draws each."""
    n = 20_000
    g = KeyedStream(4, "cpu", torch.float64).gamma(
        Site(2, 0), torch.full((n,), alpha, dtype=torch.float64))
    ref = scipy.stats.gamma(alpha).rvs(n, random_state=np.random.default_rng(int(alpha * 10)))
    assert torch.isfinite(g).all() and (g > 0).all()
    assert scipy.stats.ks_2samp(g.numpy(), ref).pvalue > 1e-3


def test_gamma_attempts_and_refusals():
    """Each element records the attempt that accepted; shapes up to 25,000
    (the residual's (df + n) / 2 at 50,000 individuals) accept at the first
    attempt nearly always; a shape that is not positive and finite gives
    NaN rather than a loop without end; a tiny shape gives at least the
    smallest normal number, as torch._standard_gamma does."""
    site = Site(0, 4, 3)
    s = KeyedStream(9, "cpu", torch.float64)
    alpha = torch.tensor([1.0, 3.0, 5000.0, 25000.0, 0.0, -1.0, float("nan"), float("inf"), 1e-6],
                         dtype=torch.float64).repeat_interleave(400)
    g, att = R.keyed_draw_plain(R.GAMMA, s.h0, torch.tensor(0), site_tail(site), alpha.numel(),
                                torch.float64, alpha, iters=True)
    good = alpha.isfinite() & (alpha > 0)
    assert torch.equal(g.isnan(), ~good) and (att[~good] == -1).all() and (att[good] >= 0).all()
    assert (att[(alpha >= 5000) & good] == 0).float().mean() > 0.99
    big = g[alpha == 25000.0]
    assert abs(big.mean().item() / 25000.0 - 1.0) < 5 * (1.0 / (25000.0 * 400)) ** 0.5
    assert (g[alpha == 1e-6] >= torch.finfo(torch.float64).tiny).all()
    torch.testing.assert_close(s.gamma(site, alpha), g, rtol=0, atol=0, equal_nan=True)


# ------------------------------------------------------------ the kernel's gamma shortcuts
# csrc/keyed_rng.cu takes two shortcuts the plain version does not: the
# Marsaglia-Tsang squeeze before the full test, and a warp's lanes shared
# among its pending elements. Both must leave the accepting attempt the plain
# version's sequential loop finds (the card holds the kernel itself to it).


@pytest.mark.parametrize("d", [2.0 / 3.0, 0.7, 1.0, 2.5, 30.0, 983.0 - 1.0 / 3.0, 25_000.0])
def test_squeeze_implies_the_full_test(d):
    """log(1 - 0.0331 x^4) <= 0.5 x^2 + d (1 - v + log v), v = (1 + c x)^3,
    c = 1/sqrt(9d), wherever the squeeze can accept (1 - 0.0331 x^4 > 0)
    and v > 0, for the least d the kernel meets (2/3: alpha = 1, or alpha < 1
    boosted) and above: the squeeze accepts no attempt the full test
    rejects. Equality only at x = 0, where both sides are 0."""
    c = 1.0 / np.sqrt(9.0 * d)
    x = np.linspace(max(-1.0 / c, -(1.0 / 0.0331) ** 0.25) + 1e-9, (1.0 / 0.0331) ** 0.25 - 1e-9,
                    400_001)
    v = (1.0 + c * x) ** 3
    rhs = 0.5 * x * x + d * ((1.0 - v) + np.log(v))
    margin = rhs - np.log1p(-0.0331 * x ** 4)
    assert margin.min() > -1e-15
    assert (margin[np.abs(x) > 0.05] > 0).all()


def _shared_attempts(accepts, first):
    """A model of the kernel's gamma loop for one warp: accepts[e][j] whether
    attempt j of lane e's element accepts (None for a lane without a live
    element). Each lane tries attempt 0; then while k elements are pending
    the warp gives the s-th of them lanes s m .. s m + m - 1, m = 32 // k,
    lane s m + r its attempt next + r, and a pending element takes its
    lowest accepting lane. Returns each lane's accepting attempt (-1: none
    by `first` attempts)."""
    att = [-1 if a is None or not a[0] else 0 for a in accepts]
    done = [a is None or a[0] for a in accepts]
    nxt = [1] * 32
    while not all(done):
        pending = [e for e in range(32) if not done[e]]
        m = 32 // len(pending)
        tried = {e: [nxt[e] + r < first and accepts[e][nxt[e] + r] for r in range(m)]
                 for e in pending}
        for e in pending:
            if any(tried[e]):
                att[e], done[e] = nxt[e] + tried[e].index(True), True
            else:
                nxt[e] += m
                done[e] = nxt[e] >= first
    return att


@pytest.mark.parametrize("p_accept", [0.05, 0.5, 0.95, 0.999])
def test_shared_attempts_take_the_sequential_loops_attempt(p_accept):
    """Over 200 warps of random acceptances (rates from nearly none, where
    most lanes stay pending round after round and 32 // k leaves lanes
    idle, to nearly all), with lanes without a live element and a limit of
    attempts, the shared loop gives every element the first attempt that
    accepts, as the sequential loop does, or none where none does."""
    rs = np.random.default_rng(int(p_accept * 1000))
    for _ in range(200):
        first = int(rs.integers(2, 200))
        accepts = [None if rs.random() < 0.1 else list(rs.random(first) < p_accept)
                   for _ in range(32)]
        seq = [-1 if a is None or not any(a) else a.index(True) for a in accepts]
        assert _shared_attempts(accepts, first) == seq
