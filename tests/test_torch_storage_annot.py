"""Unpacked marker storage against the JAX package, in float64 on the CPU:
the annotation methods (BayesRCpi, BayesRCplus), with the models and
checks of test_torch_storage.py (an int8 set under pack2=False and an
imputed float set), at V = 1 and V = 4, 3 sweeps from the JAX package's
keys: continuous fields at rtol 1e-9, delta and the annotation categories
exactly; the rows and Grams as the JAX package lays them out;
`genomic_values_state` at 1e-9.
"""
import pytest

from test_torch_storage import (
    build_both, case_id, check_genomic_values, check_layout, check_three_sweeps,
)

CASES = [(m, V) for m in ("BayesRCpi", "BayesRCplus") for V in (1, 4)]


@pytest.fixture(scope="module", params=CASES, ids=case_id)
def both(request):
    return build_both(*request.param)


def test_unpacked_storage_is_laid_out_as_the_jax_rows(both):
    check_layout(both)


def test_three_sweeps_match(both):
    check_three_sweeps(both)


@pytest.mark.parametrize("marker", [0, 1], ids=["int8", "float"])
def test_genomic_values_state_matches(both, marker):
    check_genomic_values(both, marker)
