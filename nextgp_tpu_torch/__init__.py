"""nextgp_tpu_torch: the PyTorch/CUDA port of nextgp_tpu.

The slices ported so far: residual (plain "I" or weighted "D") + fixed
effects + random effects (identity, pedigree A^-1 or genomic G^-1
structure, by the per-level scan or by perturbed CG; correlated groups by
their own level scan) + the seven marker methods (BayesPR, BayesB, BayesC,
BayesR, the annotation samplers BayesRCpi and BayesRCplus, and BayesLV)
with summary statistics + correlated marker sets (BayesPR), the GRN
structural-equation sampler (`est_grn`, its Lambda2 scan GRN1), genotypes
stored 2-bit planar-packed where the dosages allow it and int8 or float
otherwise (imputed dosages), V-batched block schedule, and the chains x
shards mesh of ranks on torch.distributed (`parallel/`, as the JAX
package's `parallel/`, which its top level does not export either). The
packed passes,
the in-block scans and the random effects' level scans run through hand-written
CUDA kernels for Hopper (csrc/, built with nvcc at first use) on CUDA
tensors and through their plain PyTorch versions on CPU tensors. The entry
points (`est_grn`, `run_lmem` with its output files, checkpoints and exact resume,
`prep`, `run_chains`, `model_card`), the posterior summaries (`io/`) and
serving (`genomic_values`, `predict`), the readers (text genotype files,
PLINK .bed filesets, map files), the formula front end (`parse_formula`)
and the command line (`python -m nextgp_tpu_torch run|summary|diag|predict|
roofline`) keep the JAX package's names, signatures and file formats. The JAX
package `nextgp_tpu` is the reference the port is held to; this package
never imports it or jax.
"""
from .api.priors import (  # noqa: F401
    BayesB, BayesC, BayesLV, BayesPR, BayesR, BayesRCpi, BayesRCplus, Random, RandomEffect,
    SummaryStatistics,
)
from .api.formula import parse_formula  # noqa: F401
from .api.spec import CorrMarkerTerm, FixedTerm, MarkerTerm, ModelSpec, RandomTerm  # noqa: F401
from .data.grm import make_g, make_g_inverse  # noqa: F401
from .data.ingest import (  # noqa: F401
    MarkerData, from_array, from_device_array, from_float_array, from_packed, read_genotype_file,
    read_plink,
)
from .data.pedigree import build_pedigree, make_a, read_pedigree  # noqa: F401
from .engine.plan import assemble  # noqa: F401
from .engine.rng import KeyedStream, PhiloxStream, Site  # noqa: F401
from .engine.state import state_from_numpy  # noqa: F401
from .engine.sweep import (  # noqa: F401
    collect_sample, make_chain_runner, make_scan_sampler, make_sweep,
)
from .grn.sampler import est_grn  # noqa: F401
from .io.summary import ess_bulk, posterior_stats, split_rhat, summary_mcmc  # noqa: F401
from .predict import genomic_values, genomic_values_state, predict  # noqa: F401
from .runtime import LMEMResult, model_card, prep, run_chains, run_lmem  # noqa: F401

__version__ = "0.1.0"
