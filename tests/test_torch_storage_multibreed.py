"""Unpacked marker storage against the JAX package, in float64 on the CPU:
MultiBreed, with the checks of test_torch_storage.py on two correlated
pairs under BayesPR with one whole-genome region: an int8 pair with
dosages up to 4, which cannot be packed, and an imputed float pair. At
V = 1 and V = 4, 3 sweeps from the JAX package's keys: continuous fields
at rtol 1e-9; the rows and Grams as the JAX package lays them out.
"""
import pytest

from test_torch_storage import build_both, case_id, check_layout, check_three_sweeps

CASES = [("MultiBreed", V) for V in (1, 4)]


@pytest.fixture(scope="module", params=CASES, ids=case_id)
def both(request):
    return build_both(*request.param)


def test_unpacked_storage_is_laid_out_as_the_jax_rows(both):
    check_layout(both)


def test_three_sweeps_match(both):
    check_three_sweeps(both)
