"""Draw sites and random streams for the Gibbs engine.

Every draw names its site: (sweep, stage, index) as in the JAX package's
key derivation `fold_in(fold_in(fold_in(chain_key, sweep), STAGE), index)`
(nextgp_tpu/engine/rng.py), plus the path of `split`s the JAX sampler takes
below that key. A stream turns a site into numbers:

    stream.normal(site, shape)   stream.uniform(site, shape)
    stream.gamma(site, alpha)    # alpha a tensor; the shape is alpha's

`PhiloxStream` is the default: torch's generator on the stream's device
(Philox4x32-10 on CUDA, the Mersenne Twister on the CPU) seeded per site
from (seed, site), so a chain is reproducible from its seed and
independent of the order in which sites are drawn. Tests inject a stream
that reproduces the JAX keys with `jax.random`; the package never imports
jax.
"""
from __future__ import annotations

from typing import NamedTuple, Protocol, Tuple

import torch

# Stage identifiers, numbered as in the JAX package; the stages of terms
# the port does not carry yet (random effects 2-3, GRN 9) keep their numbers.
STAGE_VAR_E = 0
STAGE_FIXED = 1
STAGE_MARKER = 4


class Site(NamedTuple):
    sweep: int
    stage: int
    index: int = 0
    path: Tuple[Tuple[int, int], ...] = ()  # ((n, i), ...): jax.random.split(key, n)[i]

    def split(self, n: int) -> Tuple["Site", ...]:
        return tuple(self._replace(path=self.path + ((n, i),)) for i in range(n))


class Stream(Protocol):
    def normal(self, site: Site, shape) -> torch.Tensor: ...

    def uniform(self, site: Site, shape) -> torch.Tensor: ...

    def gamma(self, site: Site, alpha: torch.Tensor) -> torch.Tensor: ...


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


class PhiloxStream:
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


class HostStream:
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
