"""Prior constructors the port supports, as plain dataclasses.

Copies of `nextgp_tpu.api.priors.BayesPR`, `BayesB`, `BayesC`, `BayesR` and
`RandomEffect` with the same field names and defaults
(tests/test_torch_guards.py holds them to the originals). They are copied
rather than imported because importing any `nextgp_tpu` submodule runs
`nextgp_tpu/__init__.py`, which imports jax.

Region-size sentinels of BayesPR follow NextGP.jl (runTime.jl:38-42):
  r == 1    -> every SNP its own variance
  r == 99   -> one variance per chromosome (needs a map)
  r == 9999 -> one variance for the whole genome
  other     -> windows of `r` SNPs within each chromosome (needs a map)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Union

ArrayLike = Any


@dataclasses.dataclass(frozen=True)
class BayesPR:
    """Region-variance Bayesian regression (runTime.jl:30-45).

    r: region size sentinel (see module docstring).
    v: prior variance of marker effects (a scalar; a matrix v belongs to
    correlated marker sets, which the port does not carry yet).
    """

    r: int
    v: Union[float, ArrayLike]
    name: str = "BayesPR"


@dataclasses.dataclass(frozen=True)
class BayesB:
    """Per-locus variance + inclusion indicator (runTime.jl:48-61)."""

    pi: float
    v: float
    estimatePi: bool = False
    name: str = "BayesB"


@dataclasses.dataclass(frozen=True)
class BayesC:
    """Common variance + inclusion indicator (runTime.jl:63-76)."""

    pi: float
    v: float
    estimatePi: bool = False
    name: str = "BayesC"


@dataclasses.dataclass(frozen=True)
class BayesR:
    """Multi-class scale-mixture prior (NextGP.jl runTime.jl:78-93).

    pi: per-class probabilities (len == len(class_)).
    class_: variance scales per class, e.g. [0.0, 1e-4, 1e-3, 1e-2].
    v: base variance; class c has variance v * class_[c].
    """

    pi: Sequence[float]
    class_: Sequence[float]
    v: float
    estimatePi: bool = False
    name: str = "BayesR"


@dataclasses.dataclass(frozen=True)
class RandomEffect:
    """Prior for a non-marker random effect or the residual
    (NextGP.jl runTime.jl:135-146). The port uses it for the residual
    prior "e" only: str_="I", or a per-record weight vector (the weighted
    "D" residual, var(e_i) = varE * w_i).
    """

    str_: Any
    v: Union[float, ArrayLike]
    type: int = 1
    name: str = "Random"
    sampler: str = "scan"
