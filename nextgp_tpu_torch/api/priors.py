"""Prior constructors the port supports, as plain dataclasses.

Copies of `nextgp_tpu.api.priors.BayesR` and `RandomEffect` with the same
field names and defaults (tests/test_torch_guards.py holds them to the
originals). They are copied rather than imported because importing any
`nextgp_tpu` submodule runs `nextgp_tpu/__init__.py`, which imports jax.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Union

ArrayLike = Any


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
    prior "e" only, with str_="I"; a weight vector (the "D" residual) is
    not ported yet.
    """

    str_: Any
    v: Union[float, ArrayLike]
    type: int = 1
    name: str = "Random"
    sampler: str = "scan"
