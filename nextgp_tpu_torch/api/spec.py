"""Programmatic model specification, the planner's input.

Copies of `nextgp_tpu.api.spec.FixedTerm`, `RandomTerm`, `MarkerTerm`,
`CorrMarkerTerm` and `ModelSpec` with the same field names and defaults.
The port's planner accepts the residual ("I" or weighted "D"), fixed terms,
random terms (identity, pedigree A^-1 or genomic G^-1 structure; the
per-level scan or the CG sampler; a correlated group, named by a tuple,
by the per-level scan), summary statistics, marker sets under any of the
seven marker priors (BayesPR, BayesB, BayesC, BayesR, BayesRCpi,
BayesRCplus, BayesLV with a covariate matrix) and correlated marker sets
under BayesPR.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Union

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
class RandomTerm:
    """A non-marker random effect. For a correlated group (NextGP.jl's tuple
    key, mme.jl:207-239) pass a tuple of names and a tuple of matching
    incidence matrices.

    ivstr is the *inverse* covariance structure over levels (identity if
    None): A^-1 of a pedigree (data/pedigree.py), G^-1 of a genomic
    relationship matrix (data/grm.py) or the inverse of a user matrix
    (setVarCovStr!, mme.jl:26-46).
    """

    name: Union[str, Tuple[str, ...]]
    z: Union[np.ndarray, Tuple[np.ndarray, ...], None]
    prior: Optional[RandomEffect] = None
    ivstr: Optional[np.ndarray] = None
    levels: Optional[List] = None
    structure_label: str = "I"
    # the CG sampler's (sampler="cg") representation: a per-row level index
    # instead of a dense incidence, and the sparse A^-1 rows and Henderson
    # factor (data/pedigree.py: a_inverse_padded, a_inverse_factor)
    z_idx: Optional[np.ndarray] = None  # (n,) int, -1 = no effect
    n_levels: Optional[int] = None
    sparse_struct: Optional[dict] = None  # iv_idx, iv_val, sire, dam, dinv_sqrt

    @property
    def correlated(self) -> bool:
        return isinstance(self.name, tuple)


@dataclasses.dataclass
class MarkerTerm:
    """A marker (SNP) set plus its Bayesian alphabet prior."""

    name: str
    data: MarkerData
    prior: Any = None


@dataclasses.dataclass
class CorrMarkerTerm:
    """Correlated marker sets sharing loci (NextGP.jl's tuple key (M1, M2),
    mme.jl:448-489): a joint (co)variance per region across sets. Only the
    BayesPR prior applies (matrix-valued v), as in the reference."""

    names: Tuple[str, ...]
    datas: Tuple[MarkerData, ...]
    prior: Any  # BayesPR with matrix v (nT x nT)


@dataclasses.dataclass
class ModelSpec:
    y: np.ndarray
    fixed: List[FixedTerm] = dataclasses.field(default_factory=list)
    blocks: List[Tuple[str, ...]] = dataclasses.field(default_factory=list)
    random: List[RandomTerm] = dataclasses.field(default_factory=list)
    markers: List[MarkerTerm] = dataclasses.field(default_factory=list)
    corr_markers: List[CorrMarkerTerm] = dataclasses.field(default_factory=list)
    residual: Optional[RandomEffect] = None  # prior for "e"
    summary_stats: Dict[Any, Any] = dataclasses.field(default_factory=dict)
    block_size: int = 256

    def validate(self):
        n = len(np.asarray(self.y).ravel())
        for t in self.fixed:
            if t.matrix().shape[0] != n:
                raise ValueError(f"fixed term {t.name}: {t.matrix().shape[0]} rows != {n}")
        for t in self.random:
            if t.z is None:
                if t.z_idx is None or len(np.asarray(t.z_idx)) != n:
                    raise ValueError(f"random term {t.name}: needs z or a valid z_idx")
                continue
            zs = t.z if isinstance(t.z, tuple) else (t.z,)
            for z in zs:
                if np.asarray(z).shape[0] != n:
                    raise ValueError(f"random term {t.name}: bad row count")
        for t in self.markers:
            if t.data.n_ind != n:
                raise ValueError(f"marker set {t.name}: {t.data.n_ind} rows != {n}")
        for ct in self.corr_markers:
            ps = {d.n_snp for d in ct.datas}
            if len(ps) != 1:
                raise ValueError(f"correlated marker sets {ct.names} must share loci")
            for d in ct.datas:
                if d.n_ind != n:
                    raise ValueError(f"correlated marker sets {ct.names}: bad row count")
        names = [t.name for t in self.fixed]
        for blk in self.blocks:
            for b in blk:
                if b not in names:
                    raise ValueError(f"block names unknown fixed term {b}")
        return self
