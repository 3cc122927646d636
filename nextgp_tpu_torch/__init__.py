"""nextgp_tpu_torch: the PyTorch/CUDA port of nextgp_tpu.

The slice ported so far is the BayesR main path: residual + fixed effects +
BayesR marker sets, genotypes stored 2-bit planar-packed, V-batched block
schedule. Its three passes run through hand-written CUDA kernels for
Hopper (csrc/, built with nvcc at first use) on CUDA tensors and through
their plain PyTorch versions on CPU tensors. The JAX package `nextgp_tpu`
is the reference the port is held to; this package never imports it or
jax.
"""
from .api.priors import BayesR, RandomEffect  # noqa: F401
from .api.spec import FixedTerm, MarkerTerm, ModelSpec  # noqa: F401
from .data.ingest import MarkerData, from_array, from_packed  # noqa: F401
from .engine.plan import assemble  # noqa: F401
from .engine.rng import PhiloxStream, Site  # noqa: F401
from .engine.state import state_from_numpy  # noqa: F401
from .engine.sweep import collect_sample, make_chain_runner, make_sweep  # noqa: F401
from .predict import genomic_values_state  # noqa: F401
from .runtime import LMEMResult, run_lmem  # noqa: F401

__version__ = "0.1.0"
