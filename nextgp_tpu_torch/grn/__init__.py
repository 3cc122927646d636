"""The GRN structural-equation sampler (`est_grn`, `make_grn_step`)."""
from .sampler import GRNPlan, GRNState, est_grn, grn_state_from_numpy, make_grn_step  # noqa: F401
