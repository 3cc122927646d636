"""The port's pedigree and GRM builders against the JAX package's.

On a 40-animal pedigree with inbreeding (few founders, parents drawn among
all earlier animals, some unknown), read from a file in a shuffled order:
the ordering, the inbreeding coefficients (the port's pure-Python Meuwissen
& Luo against the JAX package's, which runs its native library where it
loads), dense, COO and padded A^-1, the Henderson factor, the triplets
against the dense A^-1, `make_a` and `incidence_matrix`, all exactly or at
1e-12; `make_g` and `make_g_inverse` (methods 1 and 2) in float64 at 1e-12.
"""
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu.data import grm as jgrm
from nextgp_tpu.data import pedigree as jped
from nextgp_tpu_torch.data import pedigree as tped

Q = 40


def _labels(q=Q, founders=6, seed=7):
    rng = np.random.default_rng(seed)
    ids = [f"x{i}" for i in range(q)]
    sires, dams = ["0"] * q, ["0"] * q
    for i in range(founders, q):
        s, d = rng.integers(0, i, 2)
        if rng.uniform() > 0.1:
            sires[i] = ids[s]
        if s != d and rng.uniform() > 0.1:
            dams[i] = ids[d]
    perm = rng.permutation(q)
    return [ids[i] for i in perm], [sires[i] for i in perm], [dams[i] for i in perm]


@pytest.fixture(scope="module")
def peds(tmp_path_factory):
    path = tmp_path_factory.mktemp("ped") / "ped.txt"
    ids, sires, dams = _labels()
    path.write_text("id sire dam\n" + "".join(f"{a},{s},{d}\n" for a, s, d in zip(ids, sires, dams)))
    return jped.read_pedigree(str(path)), tped.read_pedigree(str(path))


def test_read_and_order(peds):
    j, t = peds
    assert t.ids == j.ids and t.n == j.n == Q
    assert np.array_equal(t.sire, j.sire) and np.array_equal(t.dam, j.dam)
    assert all(s < i for i, s in enumerate(t.sire)) and all(d < i for i, d in enumerate(t.dam))
    assert np.array_equal(t.index_of(["x5", "x0"]), j.index_of(["x5", "x0"]))
    with pytest.raises(ValueError, match="duplicate"):
        tped.build_pedigree(["a", "a"], [None, None], [None, None])
    with pytest.raises(ValueError, match="loop"):
        tped.build_pedigree(["a", "b"], ["b", "a"], [None, None])


def test_inbreeding_matches(peds):
    j, t = peds
    assert (j.inbreeding > 0).sum() >= 3  # the pedigree is inbred
    np.testing.assert_allclose(t.inbreeding, j.inbreeding, rtol=0, atol=1e-12)
    np.testing.assert_allclose(tped.inbreeding_meuwissen_luo(j.sire, j.dam), j.inbreeding, atol=1e-12)
    # F_i = A_ii - 1 from the tabular A
    a = tped.make_a(np.where(t.sire >= 0, t.sire + 1, 0), np.where(t.dam >= 0, t.dam + 1, 0))
    np.testing.assert_allclose(t.inbreeding, np.diag(a) - 1.0, atol=1e-12)


def test_a_inverse_forms_match(peds):
    j, t = peds
    dense = tped.a_inverse(t)
    np.testing.assert_allclose(dense, jped.a_inverse(j), rtol=0, atol=1e-12)
    for out, ref in zip(tped.a_inverse_coo(t), jped.a_inverse_coo(j)):
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    for out, ref in zip(tped.a_inverse_padded(t), jped.a_inverse_padded(j)):
        assert out.dtype == ref.dtype and out.shape == ref.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-12)
    for out, ref in zip(tped.a_inverse_factor(t), jped.a_inverse_factor(j)):
        assert out.dtype == ref.dtype
        np.testing.assert_array_equal(out, ref)


def test_triplets_sum_to_the_dense_inverse(peds):
    """The sparse builder (no dense matrix) against the dense A^-1, and the
    dense A^-1 against the inverse of the tabular A."""
    _, t = peds
    ri, ci, v = tped.a_inverse_triplets(t)
    rebuilt = np.zeros((Q, Q))
    np.add.at(rebuilt, (ri, ci), v)
    dense = tped.a_inverse(t)
    np.testing.assert_allclose(rebuilt, dense, rtol=0, atol=1e-12)
    a = tped.make_a(np.where(t.sire >= 0, t.sire + 1, 0), np.where(t.dam >= 0, t.dam + 1, 0))
    np.testing.assert_allclose(dense @ a, np.eye(Q), atol=1e-10)
    idx, val = tped.a_inverse_padded(t)
    u = np.random.default_rng(1).normal(size=Q)
    np.testing.assert_allclose((val * u[idx]).sum(1), dense @ u, atol=1e-12)
    sire, dam, dsq = tped.a_inverse_factor(t)
    imp = np.eye(Q)
    imp[np.arange(Q)[sire >= 0], sire[sire >= 0]] -= 0.5
    imp[np.arange(Q)[dam >= 0], dam[dam >= 0]] -= 0.5
    np.testing.assert_allclose(imp.T @ np.diag(dsq ** 2) @ imp, dense, atol=1e-12)


def test_make_a_and_incidence_match():
    rng = np.random.default_rng(3)
    sire = np.array([0, 0, 1, 1, 3, 2, 0, 5])
    dam = np.array([0, 0, 2, 0, 2, 4, 6, 3])
    np.testing.assert_array_equal(tped.make_a(sire, dam), jped.make_a(sire, dam))
    np.testing.assert_array_equal(ngt.make_a(sire, dam), ng.make_a(sire, dam))
    lv = rng.integers(0, 5, 30)
    for args in ((lv,), (lv, np.arange(7)), (np.array(["b", "0", "a", "b"]),)):
        tl, tz = tped.incidence_matrix(*args)
        jl, jz = jped.incidence_matrix(*args)
        assert tl == jl
        np.testing.assert_array_equal(tz, jz)


@pytest.mark.parametrize("method", [1, 2])
def test_grm_matches(method):
    rng = np.random.default_rng(method)
    m = rng.integers(0, 3, (30, 200)).astype(float)
    m[:, 7] = 2.0  # a monomorphic locus: method 2 leaves it out
    g = ngt.make_g(m, method=method, device="cpu")
    assert g.dtype == torch.float64 and g.device.type == "cpu"
    np.testing.assert_allclose(g.numpy(), jgrm.make_g(m, method=method), rtol=1e-12, atol=1e-12)
    gi = ngt.make_g_inverse(torch.from_numpy(m), method=method, device="cpu").numpy()
    ref = jgrm.make_g_inverse(m, method=method)
    np.testing.assert_allclose(gi, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    assert np.array_equal(gi, gi.T)
    with pytest.raises(ValueError, match="method"):
        ngt.make_g(m, method=3, device="cpu")


def test_grm_needs_the_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ngt.make_g(np.ones((3, 4)))
    with pytest.raises(NotImplementedError, match="M7c"):
        ngt.make_g("genotypes.txt", device="cpu")
