"""Programmatic model specification, the planner's input.

Copies of `nextgp_tpu.api.spec.FixedTerm`, `MarkerTerm` and `ModelSpec`
with the same field names and defaults. The port's planner accepts the
residual ("I" or weighted "D"), fixed terms, summary statistics and marker
sets under any of the seven marker priors (BayesPR, BayesB, BayesC, BayesR,
BayesRCpi, BayesRCplus, BayesLV with a covariate matrix); `random` and
`corr_markers` exist so a spec written for the JAX package carries over, and
`assemble` raises NotImplementedError naming any such term.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..data.ingest import MarkerData
from .priors import RandomEffect


@dataclasses.dataclass
class FixedTerm:
    """One fixed-effect variable (intercept, covariate, or dummy-coded
    factor). `data` is its design matrix; `levels` the column labels."""

    name: str
    data: np.ndarray  # (n,) or (n, k)
    levels: Optional[List[str]] = None

    def matrix(self) -> np.ndarray:
        x = np.asarray(self.data, dtype=np.float64)
        return x[:, None] if x.ndim == 1 else x

    @property
    def n_col(self) -> int:
        return self.matrix().shape[1]


@dataclasses.dataclass
class MarkerTerm:
    """A marker (SNP) set plus its Bayesian alphabet prior."""

    name: str
    data: MarkerData
    prior: Any = None


@dataclasses.dataclass
class ModelSpec:
    y: np.ndarray
    fixed: List[FixedTerm] = dataclasses.field(default_factory=list)
    blocks: List[Tuple[str, ...]] = dataclasses.field(default_factory=list)
    random: List[Any] = dataclasses.field(default_factory=list)
    markers: List[MarkerTerm] = dataclasses.field(default_factory=list)
    corr_markers: List[Any] = dataclasses.field(default_factory=list)
    residual: Optional[RandomEffect] = None  # prior for "e"
    summary_stats: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    block_size: int = 256

    def validate(self):
        n = len(np.asarray(self.y).ravel())
        for t in self.fixed:
            if t.matrix().shape[0] != n:
                raise ValueError(f"fixed term {t.name}: {t.matrix().shape[0]} rows != {n}")
        for t in self.markers:
            if t.data.n_ind != n:
                raise ValueError(f"marker set {t.name}: {t.data.n_ind} rows != {n}")
        names = [t.name for t in self.fixed]
        for blk in self.blocks:
            for b in blk:
                if b not in names:
                    raise ValueError(f"block names unknown fixed term {b}")
        return self
