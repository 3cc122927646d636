"""The port's BayesR scan and its coefficients against the JAX package.

`r_block_pack`: the JAX function always emits float32 (its `_pack` casts),
so its arithmetic is evaluated in float64 by running the unjitted function
with the module's F32 name pointed at float64; the port's float64 result
must agree to 1e-12. The plain `r_block_scan_v` must match the Pallas
kernel in interpret mode (float32, atol 1e-5 on beta and u; delta exact),
sliced and step-indexed, and at V=1 also the single-chain `r_block_scan`.
The CUDA kernel is checked against this plain version on the card by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgp_tpu.ops import gibbs_kernels as jgk
from nextgp_tpu_torch.ops import gibbs_kernels as tgk


def _pack_inputs(rng, p, K):
    mask = np.ones(p, bool)
    mask[-3:] = False
    varc = np.concatenate([[0.0], rng.uniform(1e-3, 1e-1, K - 1)])
    pi = rng.dirichlet(np.ones(K))
    return dict(
        beta_old=rng.normal(0, 0.1, p), z=rng.normal(0, 1, p), unif=rng.uniform(0, 1, p),
        mpm=rng.uniform(10, 50, p) * mask, lss=np.zeros(p), rss=np.zeros(p), mask=mask,
        varc=varc, logpi=np.log(pi), ive=np.float64(0.7), var_e=np.float64(1 / 0.7))


def test_r_block_pack_f64(monkeypatch):
    rng = np.random.default_rng(0)
    args = _pack_inputs(rng, 40, 4)
    monkeypatch.setattr(jgk, "F32", jnp.float64)
    ref = np.asarray(jgk.r_block_pack.__wrapped__(**{k: jnp.asarray(v) for k, v in args.items()}))
    assert ref.dtype == np.float64
    out = tgk.r_block_pack(**{k: torch.as_tensor(v) for k, v in args.items()})
    assert out.dtype == torch.float64 and out.shape == ref.shape == (40, 8 + 16)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-12, atol=1e-12)


def _scan_inputs(rng, T, V, B, K):
    """A Gram with a dominant diagonal and coefficient rows shaped like
    r_block_pack's (q1 > 0 on the non-zero classes, zero for class 0)."""
    a = rng.normal(0, 1, (T, V, B, 3 * B))
    gram = np.einsum("tvbn,tvcn->tbvc", a, a) / (3 * B)  # locus-major (T, B, V, B)
    pk = np.zeros((V, B, 8 + 4 * K))
    pk[..., 0] = rng.normal(0, 2, (V, B))
    pk[..., 1] = rng.normal(0, 0.1, (V, B))
    pk[..., 2] = rng.uniform(0, 1, (V, B))
    pk[..., 3] = rng.uniform(0, 1, (V, B)) > 0.1
    pk[..., 8:8 + K] = rng.normal(0, 1, (V, B, K))
    pk[..., 8 + K + 1:8 + 2 * K] = rng.uniform(0, 0.5, (V, B, K - 1))
    pk[..., 8 + 2 * K + 1:8 + 3 * K] = rng.uniform(0, 0.5, (V, B, K - 1))
    pk[..., 8 + 3 * K + 1:8 + 4 * K] = rng.normal(0, 0.1, (V, B, K - 1))
    return gram.astype(np.float32), pk.astype(np.float32)


def _same(port, ref):
    beta, u, delta = (x.numpy() for x in port)
    rb, ru, rd = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(beta, rb, atol=1e-5)
    np.testing.assert_allclose(u, ru, atol=1e-5)
    np.testing.assert_array_equal(delta, rd)


@pytest.mark.parametrize("V,B,K", [(1, 8, 3), (4, 8, 4)])
def test_r_block_scan_v_matches_interpret(V, B, K):
    T = 2
    gram, pk = _scan_inputs(np.random.default_rng(V * 10 + K), T, V, B, K)
    gram_t, pk_t = torch.from_numpy(gram), torch.from_numpy(pk)
    for t in range(T):
        ref = jgk.r_block_scan_v(jnp.asarray(gram[t]), jnp.asarray(pk), K, interpret=True)
        _same(tgk.r_block_scan_v(gram_t[t], pk_t, K), ref)
        ref = jgk.r_block_scan_v((jnp.asarray(gram), t), jnp.asarray(pk), K, interpret=True)
        _same(tgk.r_block_scan_v((gram_t, t), pk_t, K), ref)
        if V == 1:  # the single-chain kernel is the V=1 case
            ref = jgk.r_block_scan(jnp.asarray(gram[t][:, 0]), jnp.asarray(pk[0]), K,
                                   interpret=True)
            _same([x[0] for x in tgk.r_block_scan_v(gram_t[t], pk_t, K)], ref)


def test_scan_clamps_class_at_cdf_edge():
    """A uniform above the float CDF's last entry must select the last class
    (the min(cls, K-1) clamp), not index past it."""
    K, B = 3, 4
    gram, pk = _scan_inputs(np.random.default_rng(5), 1, 1, B, K)
    pk[..., 2] = 1.0  # every uniform at the top edge
    pk[..., 3] = 1.0
    _, _, delta = tgk.r_block_scan_v(torch.from_numpy(gram[0]), torch.from_numpy(pk), K)
    assert (delta.numpy() == K).all()
