"""2-bit planar genotype packing and the packed gather/scatter passes.

The format is byte-identical to `nextgp_tpu/ops/pack2.py`: with q packed
lanes, byte j of a locus row holds individuals j, j+q, j+2q, j+3q in its
four 2-bit fields,

    packed[:, j] = g[j] | g[j+q] << 2 | g[j+2q] << 4 | g[j+3q] << 6

so plane k of a row is (byte >> 2k) & 3 and the (padded) residual is viewed
planar as (4, q) by a plain reshape. The individual axis is padded to
n4 = 4q with q a multiple of 128; padded genotypes are 0.

Two passes per marker block carry the sweep's device-memory traffic:
  gather  r0[r]    = sum_n unpack(pk)[r, n] * y[n]      (`matvec*`,  K1)
  scatter dy[n]    = sum_r u[r] * unpack(pk)[r, n]      (`rank_update*`, K2)

Each has a plain PyTorch version (`*_plain`) and a CUDA kernel
(csrc/pack2.cu). The tensor's device decides: CPU tensors take the plain
version, CUDA tensors the kernel (which raises on what it does not take).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import cdiv
from . import _cuda

_LANES = 128


def packed_q(n: int) -> int:
    """Packed lane count for n individuals: ceil(n/4) rounded to 128 lanes."""
    return cdiv(cdiv(n, 4), _LANES) * _LANES


def pack2_np(g: np.ndarray) -> np.ndarray:
    """(n, p) int {0..3} -> (p, q) uint8 planar-packed, q = packed_q(n)."""
    n, p = g.shape
    q = packed_q(n)
    gp = np.zeros((4 * q, p), np.uint8)
    gp[:n] = g
    g4 = gp.reshape(4, q, p)
    pk = g4[0] | (g4[1] << 2) | (g4[2] << 4) | (g4[3] << 6)
    return np.ascontiguousarray(pk.T)


def pack2(g: torch.Tensor) -> torch.Tensor:
    """Device-side pack: (n, p) integer dosages in 0..3 -> (p, q) uint8,
    on g's device. Same bytes as `pack2_np`."""
    n, p = g.shape
    q = packed_q(n)
    gp = torch.zeros((4 * q, p), dtype=torch.uint8, device=g.device)
    gp[:n] = g.to(torch.uint8)
    g4 = gp.view(4, q, p)
    pk = g4[0] | (g4[1] << 2) | (g4[2] << 4) | (g4[3] << 6)
    return pk.t().contiguous()


def planes(pk: torch.Tensor, dtype) -> torch.Tensor:
    """(..., R, q) uint8 -> (4, ..., R, q) dosage planes in dtype."""
    return torch.stack([(pk >> (2 * k)) & 3 for k in range(4)]).to(dtype)


def unpack2(pk: torch.Tensor, dtype) -> torch.Tensor:
    """Exact inverse of the planar pack: (..., R, q) uint8 -> (..., R, 4q)."""
    return torch.cat([(pk >> (2 * k)) & 3 for k in range(4)], dim=-1).to(dtype)


def y_planar(yp: torch.Tensor) -> torch.Tensor:
    """(4q,) padded residual -> (4, q) planar view (no copy)."""
    return yp.view(4, -1)


# ------------------------------------------------------------ plain versions


def matvec_plain(pk: torch.Tensor, y4: torch.Tensor) -> torch.Tensor:
    """r0 = unpack(pk) @ y, pk (R, q) uint8, y4 (4, q) -> (R,) in y4's dtype."""
    return torch.einsum("krq,kq->r", planes(pk, y4.dtype), y4)


def rank_update_plain(pk: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """dy = u @ unpack(pk), pk (R, q) uint8, u (R,) -> planar (4, q)."""
    return torch.einsum("r,krq->kq", u, planes(pk, u.dtype))


# ------------------------------------------------------------ kernel wrappers


def _check_panel(pk, vec, name):
    _cuda.require(pk.is_cuda and vec.device == pk.device,
                  f"{name}: panel and vector must be on one CUDA device")
    _cuda.require(pk.dtype == torch.uint8 and pk.dim() == 2 and pk.is_contiguous(),
                  f"{name}: panel must be a contiguous (rows, q) uint8 tensor")
    _cuda.require(vec.dtype == torch.float32 and vec.is_contiguous(),
                  f"{name}: vector must be contiguous float32, got {vec.dtype}")
    _cuda.require(pk.shape[1] % 16 == 0 and pk.data_ptr() % 16 == 0,
                  f"{name}: q must be a multiple of 16 and the panel 16-byte aligned")


def _matvec_kernel(pk_all, row0, rows, y4, blocks=0):
    _check_panel(pk_all, y4, "pack2.matvec")
    q = pk_all.shape[1]
    _cuda.require(y4.shape == (4, q) and y4.data_ptr() % 16 == 0,
                  f"pack2.matvec: y4 must be an aligned (4, {q}) tensor, got {tuple(y4.shape)}")
    _cuda.require(0 < rows and 0 <= row0 and row0 + rows <= pk_all.shape[0],
                  "pack2.matvec: step rows out of range")
    _cuda.require(isinstance(blocks, int) and 0 <= blocks < 2 ** 31,
                  "pack2.matvec: blocks must be 0 (as many as are resident) or a grid size")
    out = torch.empty(rows, dtype=torch.float32, device=pk_all.device)
    err = _cuda.lib().ngt_pack2_matvec(pk_all.data_ptr() + row0 * q, y4.data_ptr(), out.data_ptr(),
                                       rows, q, blocks, _cuda.stream_of(pk_all))
    _cuda.check(err, "pack2.matvec")
    _cuda.LAUNCHES["pack2_matvec"] += 1
    return out


RANK_TILE = 512  # K2's column tile: packed bytes, 16 a lane
RANK_SLICE_ROWS = 512  # K2's rows per slice: 64 a warp


def rank_slices(rows: int, q: int) -> int:
    """Row slices of the ladder's dense scatter (`micro.dense_scatter`),
    which keeps K2's earlier design: a 4-byte column word per thread, 128 a
    block, partials added by a second pass. About 1024 blocks in all, each
    slice at least 32 rows. Depends on the shape only, so the summation
    order (and the result) is the same on every run and card."""
    col_blocks = cdiv(q // 4, 128)
    return max(1, min(cdiv(rows, 32), cdiv(1024, col_blocks)))


def rank_grid(rows: int, q: int) -> tuple[int, int]:
    """K2's grid, (column tiles, row slices): a block adds RANK_SLICE_ROWS
    rows of one RANK_TILE-byte column tile. A function of the shape alone, so
    the summation order (and the result) is the same on every run and card."""
    return cdiv(q, RANK_TILE), cdiv(rows, RANK_SLICE_ROWS)


_TICKETS = {}  # (device, stream) -> int32 tickets of K2's column tiles, 0 between launches


def tickets(store, device, stream, tiles):
    """At least `tiles` int32 tickets from `store` (a dict of its kernel's
    own, keyed by device and stream), 0 between launches: each launch that
    takes them leaves them 0."""
    key = (device, stream)
    t = store.get(key)
    if t is None or t.numel() < tiles:
        t = store[key] = torch.zeros(max(tiles, 64), dtype=torch.int32, device=device)
    return t


def _rank_kernel(pk_all, row0, u):
    _check_panel(pk_all, u, "pack2.rank_update")
    rows = u.shape[0]
    q = pk_all.shape[1]
    _cuda.require(u.dim() == 1 and 0 < rows and 0 <= row0 and row0 + rows <= pk_all.shape[0],
                  "pack2.rank_update: u must be (rows,) within the panel")
    tiles, slices = rank_grid(rows, q)
    _cuda.require(slices <= 65_535, f"pack2.rank_update: {rows} rows need more than 65,535 slices")
    dev, stream = pk_all.device, _cuda.stream_of(pk_all)
    out = torch.empty((4, q), dtype=torch.float32, device=dev)
    partial = tick = None
    if slices > 1:
        partial = torch.empty((slices, 4, q), dtype=torch.float32, device=dev)
        tick = tickets(_TICKETS, dev, stream, tiles)
    err = _cuda.lib().ngt_pack2_rank_update(
        pk_all.data_ptr() + row0 * q, u.data_ptr(), None if partial is None else partial.data_ptr(),
        out.data_ptr(), None if tick is None else tick.data_ptr(), rows, q, slices, stream)
    _cuda.check(err, "pack2.rank_update")
    _cuda.LAUNCHES["pack2_rank_update"] += 1
    return out


# ------------------------------------------------------------ entry points


def matvec(pk: torch.Tensor, y4: torch.Tensor) -> torch.Tensor:
    """r0 = unpack(pk) @ y4planar over the whole (R, q) panel -> (R,)."""
    if pk.is_cuda:
        return _matvec_kernel(pk, 0, pk.shape[0], y4)
    return matvec_plain(pk, y4)


def matvec_step(pk_all: torch.Tensor, t: int, y4: torch.Tensor, rows: int) -> torch.Tensor:
    """r0 for step t: unpack(pk_all[t*rows:(t+1)*rows]) @ y4planar. On CUDA
    the step is a pointer offset; no slice is made."""
    if pk_all.is_cuda:
        return _matvec_kernel(pk_all, t * rows, rows, y4)
    return matvec_plain(pk_all[t * rows:(t + 1) * rows], y4)


def rank_update(pk: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """dy = u @ unpack(pk) over the whole panel, planar (4, q)."""
    if pk.is_cuda:
        return _rank_kernel(pk, 0, u)
    return rank_update_plain(pk, u)


def rank_update_step(pk_all: torch.Tensor, t: int, u: torch.Tensor) -> torch.Tensor:
    """dy for step t: u @ unpack(pk_all[t*rows:(t+1)*rows]), rows = len(u),
    planar (4, q)."""
    rows = u.shape[0]
    if pk_all.is_cuda:
        return _rank_kernel(pk_all, t * rows, u)
    return rank_update_plain(pk_all[t * rows:(t + 1) * rows], u)
