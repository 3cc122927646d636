"""The port's serving (ROADMAP M11) against the JAX package's, on the CPU.

`genomic_values` and `predict` in host float64 on an int8 and a 2-bit
packed `MarkerData` (the packed rows as a numpy array and as a tensor),
within 1e-12 of the JAX package's, before and after `assemble` (which
reads the panel without consuming it); `genomic_values_state` in float64
off the assembled panel within 1e-9 of `genomic_values`.
"""
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu.ops import pack2 as j_pack2

N, P = 70, 40


def _data():
    rng = np.random.default_rng(100)
    g = rng.integers(0, 3, (N, P)).astype(np.int8)
    return g, rng.normal(0, 0.3, P), rng.integers(0, 3, (9, P))


def _markers(mod, g, form):
    if form == "int8":
        return mod.from_array(g)
    pk = j_pack2.pack2_np(g)
    return mod.from_packed(torch.as_tensor(pk) if form == "tensor" else pk, N,
                           g.mean(0).astype(np.float64))


@pytest.mark.parametrize("form", ["int8", "packed", "tensor"])
def test_genomic_values_and_predict_match(form):
    g, beta, new = _data()
    md_j = _markers(ng, g, "int8" if form == "int8" else "packed")
    md_t = _markers(ngt, g, form)
    ref = ng.genomic_values(md_j, beta, chunk=16)
    out = ngt.genomic_values(md_t, beta, chunk=16)
    np.testing.assert_allclose(out, ref, rtol=1e-12, atol=1e-12 * np.abs(ref).max())
    np.testing.assert_allclose(out, (g - g.mean(0)) @ beta, rtol=1e-12, atol=1e-12)
    ref = ng.predict(md_j, beta, new)
    np.testing.assert_allclose(ngt.predict(md_t, beta, new), ref, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(ngt.predict(md_t, torch.as_tensor(beta), torch.as_tensor(new)), ref,
                               rtol=1e-12, atol=1e-12)
    spec = ngt.ModelSpec(y=np.ones(N), markers=[ngt.MarkerTerm("M", md_t, ngt.BayesC(0.2, 0.05))],
                         block_size=16)
    plan, state = ngt.assemble(spec, device="cpu")
    np.testing.assert_array_equal(ngt.genomic_values(md_t, beta, chunk=16), out)
    np.testing.assert_allclose(ngt.genomic_values_state(plan, state, beta=beta).numpy(), out,
                               rtol=1e-9, atol=1e-9 * np.abs(out).max())
    with pytest.raises(ValueError, match="entries"):
        ngt.genomic_values(md_t, beta[:-1])
    with pytest.raises(ValueError, match="new_genotypes"):
        ngt.predict(md_t, beta, new[:, :-1])
