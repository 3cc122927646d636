"""Prior constructors the port supports, as plain dataclasses.

Copies of `nextgp_tpu.api.priors.BayesPR`, `BayesB`, `BayesC`, `BayesR`,
`BayesRCpi`, `BayesRCplus`, `BayesLV`, `RandomEffect` (and its alias
`Random`), `SummaryStatistics`, `normalize_annot`, the aliases
`bayes_alias_BayesA` and `bayes_alias_ridge`, `MARKER_PRIORS` and
`is_marker_prior` with the same field names and defaults
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

import numpy as np

ArrayLike = Any


@dataclasses.dataclass(frozen=True)
class BayesPR:
    """Region-variance Bayesian regression (runTime.jl:30-45).

    r: region size sentinel (see module docstring).
    v: prior variance of marker effects (a scalar; an nT x nT matrix for
    correlated marker sets, CorrMarkerTerm).
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
class BayesRCpi:
    """BayesR with SNP annotations; the annotation category is sampled per
    locus (runTime.jl:95-112; sampler functions.jl:291-360)."""

    pi: Sequence[float]
    class_: Sequence[float]
    v: float
    annot: ArrayLike  # (nSNP, nAnnot) 0/1
    estimatePi: bool = False
    name: str = "BayesRCpi"


@dataclasses.dataclass(frozen=True)
class BayesRCplus:
    """BayesR with SNP annotations; every non-zero annotation contributes an
    additive effect component (runTime.jl:113; sampler functions.jl:362-419)."""

    pi: Sequence[float]
    class_: Sequence[float]
    v: float
    annot: ArrayLike
    estimatePi: bool = False
    name: str = "BayesRCplus"


@dataclasses.dataclass(frozen=True)
class BayesLV:
    """Log-linear variance model: log sigma2_j = C_j c + zeta_j
    (runTime.jl:116-133; sampler functions.jl:421-486).

    covariates: the variance-model design — either a prebuilt (nSNP, k)
    matrix, or an R-style RHS formula string (e.g. "1 + x1 + x2") built
    against `covariate_table` at assemble time (api/formula.build_lv_design),
    matching the reference's `BayesLV(v, f::TermOrTerms, covariates::DataFrame,
    varZeta)` front-end (runTime.jl:133; design via modelmatrix at
    mme.jl:426). Columns are used raw (no centering); "1" adds an
    intercept; string/int columns are dummy-coded with the first level
    dropped.
    estimateVarZeta: False = keep varZeta fixed; True = varZeta <- var(resid);
    float f = varZeta <- f * var(logVar)  (functions.jl:479-485).
    """

    v: float
    covariates: ArrayLike
    varZeta: float
    estimateVarZeta: Union[bool, float] = False
    name: str = "BayesLV"
    covariate_table: Any = None  # the table a formula string is built against


@dataclasses.dataclass(frozen=True)
class RandomEffect:
    """Prior for a non-marker random effect or the residual
    (NextGP.jl runTime.jl:135-146).

    str_: for a random term "I" (identity), "A" (pedigree numerator
          inverse) or "G" (genomic): a label, the inverse structure itself
          is the term's `ivstr` (`RandomTerm`); for the residual "I" or a
          per-record weight vector (the weighted "D" residual,
          var(e_i) = varE * w_i).
    v: prior variance (a scalar, or an nT x nT matrix for a correlated
       group).
    type: vanRaden method when str_ == "G" (1 or 2).
    sampler: "scan" = the reference's per-level sequential Gibbs
             (functions.jl:57-72); "cg" = the exact joint draw by perturbed
             conjugate gradient, sparse and scan-free, for large level
             counts ("I"/"A" structures only).
    """

    str_: Any
    v: Union[float, ArrayLike]
    type: int = 1
    name: str = "Random"
    sampler: str = "scan"


# NextGP exports this constructor as `Random` (src/NextGP.jl:10), as the JAX
# package does.
Random = RandomEffect


@dataclasses.dataclass(frozen=True)
class SummaryStatistics:
    """External (GWAS) summary-statistic prior offsets (runTime.jl:149-152),
    folded into per-effect lhs/rhs as 1/v and m/v (mme.jl:144-147, 313-322),
    with Inf/NaN guards for v == 0 entries on marker sets."""

    m: ArrayLike
    v: ArrayLike


def normalize_annot(annot) -> np.ndarray:
    a = np.asarray(annot)
    if a.ndim != 2:
        raise ValueError("annot must be (nSNP, nAnnot)")
    return a.astype(np.int32)


def bayes_alias_BayesA(v: float) -> BayesPR:
    """BayesA == BayesPR with per-SNP regions (reference docs equivalence)."""
    return BayesPR(1, v)


def bayes_alias_ridge(v: float) -> BayesPR:
    """BRR / ridge == BayesPR whole-genome region (runTime.jl:41)."""
    return BayesPR(9999, v)


MARKER_PRIORS = (BayesPR, BayesB, BayesC, BayesR, BayesRCpi, BayesRCplus, BayesLV)


def is_marker_prior(p) -> bool:
    return isinstance(p, MARKER_PRIORS)
