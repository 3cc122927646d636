"""Draw sites and random streams for the Gibbs engine.

Every draw names its site: (sweep, stage, index) as in the JAX package's
key derivation `fold_in(fold_in(fold_in(chain_key, sweep), STAGE), index)`
(nextgp_tpu/engine/rng.py), plus the path of `split`s the JAX sampler takes
below that key. A stream turns a site into numbers:

    stream.normal(site, shape)   stream.uniform(site, shape)
    stream.gamma(site, alpha)    # alpha a tensor; the shape is alpha's
    stream.normal_split(site, n, shape, then=())   # (n,) + shape
    stream.gamma_split(site, n, alpha, then=())    # alpha (n, ...)

where row r of a split draw is the plain draw at the site
site.split(n)[r], extended by the splits `then` (the per-region draws of a
correlated marker set, `jax.random.split(kv, n_regions)[r]` in the JAX
package, and the Wishart's split below it).

`PhiloxStream` is the default: torch's generator on the stream's device
(Philox4x32-10 on CUDA, the Mersenne Twister on the CPU) seeded per site
from (seed, site), so a chain is reproducible from its seed and
independent of the order in which sites are drawn. It reseeds a host
generator per draw, so a sweep that uses it cannot be captured in a CUDA
graph. `KeyedStream` derives the same per-site key on the device from the
state's sweep counter (`site.counter`) and draws with a counter-based
Philox keyed by it (csrc/keyed_rng.cu, one launch per draw; its plain
version here on CPU tensors): it is the stream a captured sweep replays.
Tests inject a stream that reproduces the JAX keys with `jax.random`; the
package never imports jax.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Protocol, Tuple

import torch

from ..ops import _cuda

# Stage identifiers, numbered as in the JAX package. A random term's
# variance is drawn from a split of its STAGE_RANDOM site, as the JAX sweep
# does, so STAGE_RANDOM_VAR (3) stays unused there too; GRN (9) is not
# ported yet and keeps its number.
STAGE_VAR_E = 0
STAGE_FIXED = 1
STAGE_RANDOM = 2
STAGE_MARKER = 4


class Site(NamedTuple):
    sweep: int
    stage: int
    index: int = 0
    path: Tuple[Tuple[int, int], ...] = ()  # ((n, i), ...): jax.random.split(key, n)[i]
    # the sweep number as a 0-d int64 tensor on the state's device, which a
    # KeyedStream reads in place of `sweep` (a captured sweep's host number
    # is the capture's); every other stream reads `sweep`
    counter: Optional[torch.Tensor] = None

    def split(self, n: int) -> Tuple["Site", ...]:
        return tuple(self._replace(path=self.path + ((n, i),)) for i in range(n))


class Stream(Protocol):
    def normal(self, site: Site, shape) -> torch.Tensor: ...

    def uniform(self, site: Site, shape) -> torch.Tensor: ...

    def gamma(self, site: Site, alpha: torch.Tensor) -> torch.Tensor: ...

    def normal_split(self, site: Site, n: int, shape, then=()) -> torch.Tensor: ...

    def gamma_split(self, site: Site, n: int, alpha: torch.Tensor, then=()) -> torch.Tensor: ...


def split_site(site: Site, n: int, r: int, then=()) -> Site:
    """Row r's site of a split draw: site.split(n)[r], then the splits
    `then` ((n, i) pairs) below it."""
    return site._replace(path=site.path + ((n, r),) + tuple(then))


class SplitByLoop:
    """normal_split and gamma_split as one plain draw per row."""

    def normal_split(self, site, n, shape, then=()):
        return torch.stack([self.normal(split_site(site, n, r, then), shape) for r in range(n)])

    def gamma_split(self, site, n, alpha, then=()):
        return torch.stack([self.gamma(split_site(site, n, r, then), alpha[r]) for r in range(n)])


_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def site_seed(seed: int, site: Site) -> int:
    """63-bit generator seed for one draw site."""
    h = _splitmix64(seed & _MASK64)
    for v in (site.sweep, site.stage, site.index, *(x for ni in site.path for x in ni)):
        h = _splitmix64(h ^ (v & _MASK64))
    return h >> 1


class PhiloxStream(SplitByLoop):
    """torch generator stream on `device`, reseeded per draw site."""

    def __init__(self, seed: int, device, dtype):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        self._gen = torch.Generator(device=self.device)

    def _at(self, site: Site) -> torch.Generator:
        return self._gen.manual_seed(site_seed(self.seed, site))

    def normal(self, site, shape):
        return torch.randn(shape, generator=self._at(site), device=self.device, dtype=self.dtype)

    def uniform(self, site, shape):
        return torch.rand(shape, generator=self._at(site), device=self.device, dtype=self.dtype)

    def gamma(self, site, alpha):
        return torch._standard_gamma(alpha, generator=self._at(site))


class HostStream(SplitByLoop):
    """Draws made on the host by a float32 CPU PhiloxStream and copied to
    `device` as `dtype`. A chain on the card and a chain on the CPU that each
    take a HostStream of one seed see the same numbers, which is how a kernel
    chain is compared with the plain chain, in float32 or (the same float32
    draws widened) in float64."""

    def __init__(self, seed: int, device, dtype=torch.float32):
        self.cpu = PhiloxStream(seed, "cpu", torch.float32)
        self.device = torch.device(device)
        self.dtype = dtype

    def normal(self, site, shape):
        return self.cpu.normal(site, shape).to(self.device, self.dtype)

    def uniform(self, site, shape):
        return self.cpu.uniform(site, shape).to(self.device, self.dtype)

    def gamma(self, site, alpha):
        return self.cpu.gamma(site, alpha.cpu().float()).to(self.device, self.dtype)


# ------------------------------------------------------------------ keyed draws

UNIFORM, NORMAL, GAMMA = 0, 1, 2
MAX_TAIL = 8  # stage, index and up to three splits
MAX_ATTEMPTS = 1000  # a gamma that has not accepted by then is NaN
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def _i64(x: int) -> int:
    """The int64 whose bits are those of the uint64 x."""
    x &= _MASK64
    return x - (1 << 64) if x >> 63 else x


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits (torch's >> is arithmetic)."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _splitmix64_t(x: torch.Tensor) -> torch.Tensor:
    """_splitmix64 on int64 tensors: adds and multiplies wrap, so the bits
    are those of the uint64 arithmetic."""
    x = x + _i64(0x9E3779B97F4A7C15)
    x = (x ^ _srl(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    x = (x ^ _srl(x, 27)) * _i64(0x94D049BB133111EB)
    return x ^ _srl(x, 31)


def site_tail(site: Site) -> Tuple[int, ...]:
    """What follows the sweep in a site's key: stage, index, the path."""
    return (site.stage, site.index, *(x for ni in site.path for x in ni))


def site_key_plain(h0: int, sweep: torch.Tensor, tail) -> torch.Tensor:
    """site_seed as int64 tensor arithmetic: h0 = _splitmix64(seed), sweep a
    0-d int64 tensor, tail = site_tail(site). Equals site_seed(seed, site).
    A tail value may be an int64 tensor of non-negative values (a split
    draw's row of each element): the key is then one per element."""
    h = _splitmix64_t(sweep.to(torch.int64) ^ _i64(h0))
    for v in tail:
        h = _splitmix64_t(h ^ (v if isinstance(v, torch.Tensor) else _i64(v)))
    return _srl(h, 1)


def _philox_plain(key, c0, c1, c2, c3):
    """Philox4x32-10 on int64 tensors holding 32-bit words; key a 0-d int64.
    A 32 x 32-bit product fits 64 bits, so its wrapped int64 has its bits."""
    k0, k1 = key & _M32, _srl(key, 32)
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        p0, p1 = c0 * _PHILOX_M[0], c2 * _PHILOX_M[1]
        c0, c1, c2, c3 = _srl(p1, 32) ^ c1 ^ k0, p1 & _M32, _srl(p0, 32) ^ c3 ^ k1, p0 & _M32
    return c0, c1, c2, c3


def _unit(w):
    """24 bits k of a word to (k + 1) * 2^-24 in float64: (0, 1], never 0."""
    return (_srl(w, 8) + 1).to(torch.float64) * 2.0 ** -24


def _box_muller(w0, w1):
    return torch.sqrt(-2.0 * torch.log(_unit(w0))) * torch.cos(2.0 * math.pi * _unit(w1))


def keyed_draw_plain(kind, h0, sweep, tail, n, dtype, alpha=None, iters=False, rows=None):
    """Plain version of csrc/keyed_rng.cu: n draws of `kind` (UNIFORM, NORMAL
    or GAMMA with shapes alpha (n,)) at the site keyed by (h0, sweep, tail),
    on sweep's device, as float64 rounded to dtype at the end. iters: also
    return each gamma's accepting attempt (int32, -1 where none accepted;
    None for the other kinds). rows = (count, slot): a split draw, count
    rows of n draws each (alpha (count * n,)), row r keyed with tail[slot]
    = r; its elements are indexed 0 .. n-1 within their row, so row r is
    the draw at that row's site."""
    dev = sweep.device
    count = 1 if rows is None else rows[0]
    e = torch.arange(count * n, dtype=torch.int64, device=dev)
    if rows is None:
        key, i = site_key_plain(h0, sweep, tail), e
    else:
        tail = list(tail)
        tail[rows[1]] = e // n
        key, i = site_key_plain(h0, sweep, tail), e % n
    n = count * n
    lo, hi, zero = i & _M32, _srl(i, 32), torch.zeros_like(i)
    if kind != GAMMA:
        w = _philox_plain(key, lo, zero, zero, hi)
        out = (_unit(w[0]) if kind == UNIFORM else _box_muller(w[0], w[1])).to(dtype)
        return (out, None) if iters else out
    a_in = alpha.reshape(-1).to(torch.float64)
    valid = (a_in > 0) & ~torch.isinf(a_in)
    boost = a_in < 1.0
    a = torch.where(boost, a_in + 1.0, a_in)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    g = torch.full_like(a, float("nan"))
    att = torch.full((n,), -1, dtype=torch.int32, device=dev)
    pending = valid.clone()
    for j in range(MAX_ATTEMPTS):
        if not pending.any():
            break
        w = _philox_plain(key, lo, torch.full_like(i, j), torch.ones_like(i), hi)
        x = _box_muller(w[0], w[1])
        v = 1.0 + c * x
        v3 = v * v * v
        rhs = 0.5 * x * x + d * ((1.0 - v3) + torch.log(v3))
        acc = pending & (v > 0) & (torch.log(_unit(w[2])) < rhs)
        g = torch.where(acc, d * v3, g)
        att = torch.where(acc, torch.full_like(att, j), att)
        pending &= ~acc
    ub = _unit(_philox_plain(key, lo, zero, torch.full_like(i, 2), hi)[0])
    g = torch.where(boost, g * torch.exp(torch.log(ub) / a_in), g)
    out = torch.where(att >= 0, g.to(dtype).clamp_min(torch.finfo(dtype).tiny),
                      torch.full((), float("nan"), dtype=dtype, device=dev))
    return (out, att) if iters else out


def _keyed_kernel(kind, h0, sweep, tail, n, dtype, alpha=None, iters=False, rows=None):
    """csrc/keyed_rng.cu: one launch, dtype (float32 or float64: the same
    numbers stored wider) out, on sweep's device. rows = (count, slot): the
    split-batched entry point, count * n draws."""
    count = 1 if rows is None else rows[0]
    _cuda.require(sweep.is_cuda and sweep.dtype == torch.int64 and sweep.numel() == 1,
                  "keyed_rng: the sweep counter must be one int64 on a CUDA device")
    _cuda.require(dtype in (torch.float32, torch.float64),
                  f"keyed_rng: the kernel draws float32 or float64, not {dtype}")
    _cuda.require(len(tail) <= MAX_TAIL, f"keyed_rng: a site tail of at most {MAX_TAIL} values")
    _cuda.require(n >= 1 and count >= 1, "keyed_rng: at least one draw")
    _cuda.require(rows is None or 0 <= rows[1] < len(tail),
                  "keyed_rng: a split draw's row slot must lie in the tail")
    if kind == GAMMA:
        _cuda.require(alpha.is_cuda and alpha.device == sweep.device and alpha.dtype == dtype
                      and alpha.is_contiguous() and alpha.numel() == count * n,
                      f"keyed_rng: alpha must be rows x n contiguous {dtype} on the counter's "
                      "device")
    out = torch.empty(count * n, dtype=dtype, device=sweep.device)
    att = (torch.empty(count * n, dtype=torch.int32, device=sweep.device)
           if iters and kind == GAMMA else None)
    words = (ctypes.c_ulonglong * MAX_TAIL)(*(v & _MASK64 for v in tail))
    args = (alpha.data_ptr() if kind == GAMMA else None, out.data_ptr(),
            None if att is None else att.data_ptr(), n, _cuda.stream_of(sweep))
    lib, f64 = _cuda.lib(), dtype == torch.float64
    if rows is None:
        fn = lib.ngt_keyed_rng_f64 if f64 else lib.ngt_keyed_rng
        err = fn(sweep.data_ptr(), h0, words, len(tail), kind, *args)
    else:
        fn = lib.ngt_keyed_rng_rows_f64 if f64 else lib.ngt_keyed_rng_rows
        err = fn(sweep.data_ptr(), h0, words, len(tail), rows[1], count, kind, *args)
    _cuda.check(err, "keyed_rng")
    _cuda.LAUNCHES["keyed_rng"] += 1
    return (out, att) if iters else out


def keyed_draw(kind, h0, sweep, tail, n, dtype, alpha=None, iters=False, rows=None):
    """n keyed draws (count * n for a split draw, rows = (count, slot)): the
    kernel for a counter on the card (float32 or float64; it raises on what
    it does not take), the plain version on the CPU."""
    if sweep.is_cuda:
        return _keyed_kernel(kind, h0, sweep, tail, n, dtype, alpha, iters, rows)
    return keyed_draw_plain(kind, h0, sweep, tail, n, dtype, alpha, iters, rows)


def split_tail(site: Site, n: int, then=()):
    """(tail, slot) of a split draw: site_tail of split_site(site, n, r,
    then) with r at index slot (0 there; the draw sets each row's)."""
    head = site_tail(site)
    return head + (n, 0) + tuple(x for ni in then for x in ni), len(head) + 1


class KeyedStream:
    """Draws keyed on the device: site s gets the key site_seed(seed, s),
    folded from the sweep counter the site carries (`site.counter`, a
    device tensor; the host's `site.sweep` where it carries none), and
    Philox4x32-10 numbers under that key indexed by element. A draw is a
    function of (seed, site) alone, whatever the order of calls and whether
    it runs eagerly or in a CUDA-graph replay (`capturable`). Uniforms lie in
    (0, 1], normals are Box-Muller, gammas Marsaglia-Tsang with a retry per
    element until it accepts (alpha < 1 boosted by U^(1/alpha)). On the CPU
    the plain version, in float64 rounded to dtype, defines the numbers; on
    the card one launch per draw (csrc/keyed_rng.cu, float32 or float64
    out: the same numbers stored wider) gives the uniforms' bits and runs
    Box-Muller in float32, a few ulp of float32 from the plain version's
    normals (and so from its gammas, whose acceptance it runs in float64).
    A split draw (normal_split, gamma_split) is one launch for all its rows,
    each row's key folded on the card."""

    capturable = True

    def __init__(self, seed: int, device, dtype):
        self.seed = int(seed)
        self.device = torch.device(device)
        self.dtype = dtype
        self.h0 = _splitmix64(self.seed & _MASK64)

    def _draw(self, kind, site, n, dtype, alpha=None, split=None, then=()):
        sweep = site.counter
        if sweep is None:
            sweep = torch.tensor(site.sweep, dtype=torch.int64, device=self.device)
        if split is None:
            return keyed_draw(kind, self.h0, sweep, site_tail(site), n, dtype, alpha)
        tail, slot = split_tail(site, split, then)
        return keyed_draw(kind, self.h0, sweep, tail, n, dtype, alpha, rows=(split, slot))

    def normal(self, site, shape):
        shape = tuple(shape)
        return self._draw(NORMAL, site, math.prod(shape), self.dtype).view(shape)

    def uniform(self, site, shape):
        shape = tuple(shape)
        return self._draw(UNIFORM, site, math.prod(shape), self.dtype).view(shape)

    def gamma(self, site, alpha):
        a = alpha.contiguous()
        return self._draw(GAMMA, site, a.numel(), a.dtype, a).view(a.shape)

    def normal_split(self, site, n, shape, then=()):
        """All n rows in one draw (one launch on the card)."""
        shape = tuple(shape)
        return self._draw(NORMAL, site, math.prod(shape), self.dtype, split=n,
                          then=then).view((n,) + shape)

    def gamma_split(self, site, n, alpha, then=()):
        """alpha (n, ...): all n rows in one draw (one launch on the card)."""
        a = alpha.contiguous()
        return self._draw(GAMMA, site, a[0].numel(), a.dtype, a.view(-1), split=n,
                          then=then).view(a.shape)
