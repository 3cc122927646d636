"""The port's packed format and packed passes against the JAX package.

The bytes of `pack2_np` (and of the device-side `pack2`) must equal the JAX
package's; the plain gather and scatter, in their whole-panel and
step-indexed forms, must match the Pallas kernels run in interpret mode to
float32 rounding (rtol 1e-5: the two sum in different orders). The CUDA
kernels themselves are checked against these plain versions on the card by
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgp_tpu.ops import pack2 as jp2
from nextgp_tpu_torch.ops import pack2 as tp2


def _close(a, b):
    b = np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5 * np.abs(b).max())


@pytest.mark.parametrize("n,p", [(8, 3), (37, 24), (600, 64), (1000, 5)])
def test_pack_bytes_equal(n, p):
    g = np.random.default_rng(n).integers(0, 4, (n, p), dtype=np.int8)
    pk = jp2.pack2_np(g)
    assert tp2.packed_q(n) == jp2.packed_q(n)
    assert np.array_equal(tp2.pack2_np(g), pk)
    assert np.array_equal(tp2.pack2(torch.from_numpy(g)).numpy(), pk)
    np.testing.assert_array_equal(
        tp2.unpack2(torch.from_numpy(pk), torch.float64).numpy(),
        np.asarray(jp2.unpack2(jnp.asarray(pk), jnp.float64)))


def _panel(seed, n, rows):
    rng = np.random.default_rng(seed)
    q = jp2.packed_q(n)
    pk = jp2.pack2_np(rng.integers(0, 3, (n, rows), dtype=np.int8))
    yp = np.concatenate([rng.normal(0, 1, n), np.zeros(4 * q - n)]).astype(np.float32)
    return pk, yp, rng


def test_whole_panel_match_interpret():
    pk, yp, rng = _panel(1, 600, 64)
    u = rng.normal(0, 1, pk.shape[0]).astype(np.float32)
    r_j = jp2.matvec(jnp.asarray(pk), jp2.y_planar(jnp.asarray(yp)), interpret=True)
    r_t = tp2.matvec(torch.from_numpy(pk), tp2.y_planar(torch.from_numpy(yp)))
    _close(r_t.numpy(), r_j)
    d_j = jp2.rank_update(jnp.asarray(pk), jnp.asarray(u), interpret=True)[:4]
    d_t = tp2.rank_update(torch.from_numpy(pk), torch.from_numpy(u))
    assert d_t.shape == (4, pk.shape[1])
    _close(d_t.numpy(), d_j)


def test_step_forms_match_interpret():
    T, rows = 3, 128
    pk, yp, rng = _panel(2, 700, T * rows)
    u = rng.normal(0, 1, rows).astype(np.float32)
    pk_j, pk_t = jnp.asarray(pk), torch.from_numpy(pk)
    y4_j, y4_t = jp2.y_planar(jnp.asarray(yp)), tp2.y_planar(torch.from_numpy(yp))
    for t in range(T):
        _close(tp2.matvec_step(pk_t, t, y4_t, rows).numpy(),
               jp2.matvec_step(pk_j, t, y4_j, rows, interpret=True))
        _close(tp2.rank_update_step(pk_t, t, torch.from_numpy(u)).numpy(),
               jp2.rank_update_step(pk_j, jnp.int32(t), jnp.asarray(u), interpret=True)[:4])


def test_rank_slices_cover_rows():
    """The scatter's row slices depend on the shape only and cover every row."""
    for rows, q in [(16, 128), (24_576, 2_560), (49_152, 2_560), (300, 12_544)]:
        s = tp2.rank_slices(rows, q)
        per = -(-rows // s)
        assert 1 <= s <= 65_535 and per * s >= rows and per * (s - 1) < rows


@pytest.mark.parametrize("rows,q", [(1, 16), (511, 496), (512, 512), (513, 528), (24_576, 2_560),
                                    (24_576, 12_544), (36_864, 12_544), (1000, 25_088)])
def test_rank_grid_covers_the_panel(rows, q):
    """K2's grid depends on the shape only: its column tiles cover the q
    bytes with less than one tile to spare, and its row slices (the kernel
    gives each ceil(rows / slices) rows) cover every row, none empty."""
    tiles, slices = tp2.rank_grid(rows, q)
    assert (tiles - 1) * tp2.RANK_TILE < q <= tiles * tp2.RANK_TILE
    per = -(-rows // slices)
    assert 1 <= slices <= 65_535 and per * slices >= rows and per * (slices - 1) < rows
    assert per <= tp2.RANK_SLICE_ROWS
    assert tp2.rank_grid(rows, q) == (tiles, slices)
