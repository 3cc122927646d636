"""The measurement ladder's kernels: streaming passes over a genotype panel.

Counterparts of the Pallas kernels in the JAX repository's measurement
scripts (`scripts/micro_load32.py`, `micro_matvec.py`, `micro_fused.py`,
`micro_frontier.py`); `nextgp_tpu_torch.micro` runs them as those scripts do.

    gather_width   packed gather with 1-byte or 4-byte loads   (mv8 / mv32)
                   on K1's body
    read_step      read-only pass, per-row byte sums           (make_dma_step)
    dense_gather   int8 dosages, out[l] = sum_n mt[l, n] y[n]  (pl_r0)
    dense_scatter  int8 dosages, out[n] = sum_l u[l] mt[l, n]  (pl_corr)
    fused_step     gather of step t1 and scatter of step t in one launch, on
                   K1's and K2's bodies (make_fused_step)

The scripts' other kernels compute what K1 and K2 compute (`pl_r0p`,
`pl_r0p8`, `pl_corrp`, `make_gather_step`, `make_scatter_step`), so the
ladder launches `pack2.matvec*` and `pack2.rank_update*` at their shapes.

Each function has a plain PyTorch version (`*_plain`) and a CUDA kernel
(csrc/micro.cu). The tensor's device decides: CPU tensors take the plain
version, CUDA tensors the kernel, which raises on what it does not take.
"""
from __future__ import annotations

import torch

from ..utils import cdiv
from . import _cuda, pack2
from .gibbs_kernels import SMEM_BYTES

_WIDTH = {torch.uint8: 1, torch.int32: 4}  # bytes per load of `gather_width`


def y_words(y4: torch.Tensor, width: int) -> torch.Tensor:
    """(4, q) planar y -> the (4*width, q/width) layout `gather_width` takes
    for words of `width` bytes: row 4b + k holds y4[k, width*j + b], the
    factor of field k of byte b of word j (little-endian)."""
    q = y4.shape[1]
    return y4.reshape(4, q // width, width).permute(2, 0, 1).reshape(4 * width, q // width)


# ------------------------------------------------------------ plain versions


def gather_width_plain(pk: torch.Tensor, yw: torch.Tensor) -> torch.Tensor:
    """out[r] = sum_j sum_m ((pk[r, j] >> 2m) & 3) * yw[m, j], one matrix-vector
    product per two-bit field m."""
    out = torch.zeros(pk.shape[0], dtype=yw.dtype, device=pk.device)
    for m in range(yw.shape[0]):
        out += ((pk >> (2 * m)) & 3).to(yw.dtype) @ yw[m]
    return out


def read_step_plain(pk_all: torch.Tensor, t: int, rows: int) -> torch.Tensor:
    """Per-row byte sums of step t, int32."""
    return pk_all[t * rows:(t + 1) * rows].sum(dim=1, dtype=torch.int32)


def dense_gather_plain(mt: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return mt.to(y.dtype) @ y


def dense_scatter_plain(mt: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    return u @ mt.to(u.dtype)


def fused_step_plain(pk_all, t, t1, u, y4):
    """(r0 of step t1, dy of step t), each by its own plain pass."""
    rows = u.shape[0]
    return (pack2.matvec_plain(pk_all[t1 * rows:(t1 + 1) * rows], y4),
            pack2.rank_update_plain(pk_all[t * rows:(t + 1) * rows], u))


# ------------------------------------------------------------ kernel wrappers


def gather_blocks(rows: int, device) -> int:
    """The grid of read_step and dense_gather over `rows` rows (K1's before
    its redesign): one warp per four rows, eight warps a block, at most four
    blocks per SM."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return min(cdiv(cdiv(rows, 4), 8), 4 * sms)


def _check_vec(vec, like, shape, name):
    _cuda.require(vec.device == like.device and vec.dtype == torch.float32
                  and vec.is_contiguous() and tuple(vec.shape) == tuple(shape),
                  f"{name}: needs a contiguous float32 {tuple(shape)} tensor on the panel's "
                  f"device, got {vec.dtype} {tuple(vec.shape)}")


def gather_width(pk: torch.Tensor, yw: torch.Tensor, blocks: int = 0) -> torch.Tensor:
    """The packed gather with one word per thread per load. pk: (R, q) uint8
    (one byte a load) with yw (4, q), or the same bytes viewed as (R, q/4)
    int32 (one 4-byte word a load) with yw (16, q/4) = y_words(y4, 4); yw is
    read as given, through L1, so q has no limit. On the card K1's body runs
    with loads of that width. blocks: the grid, or 0 for as many blocks as
    are resident (K1's rule); a row's sum, and so the result, does not
    depend on it."""
    if not pk.is_cuda:
        return gather_width_plain(pk, yw)
    name = "micro.gather_width"
    _cuda.require(pk.dtype in _WIDTH and pk.dim() == 2 and pk.is_contiguous() and pk.shape[0] > 0,
                  f"{name}: panel must be a contiguous (rows, words) uint8 or int32 tensor")
    width = _WIDTH[pk.dtype]
    rows, nword = pk.shape
    _check_vec(yw, pk, (4 * width, nword), name)
    _cuda.require(isinstance(blocks, int) and 0 <= blocks < 2 ** 31,
                  f"{name}: blocks must be 0 (as many as are resident) or a grid size")
    out = torch.empty(rows, dtype=torch.float32, device=pk.device)
    err = _cuda.lib().ngt_gather_width(pk.data_ptr(), yw.data_ptr(), out.data_ptr(), rows, nword,
                                       width, blocks, _cuda.stream_of(pk))
    _cuda.check(err, name)
    _cuda.LAUNCHES[f"gather_width{width}"] += 1
    return out


def _check_bytes(mat, dtype, name):
    _cuda.require(mat.dtype == dtype and mat.dim() == 2 and mat.is_contiguous(),
                  f"{name}: panel must be a contiguous 2-d {dtype} tensor")
    _cuda.require(mat.shape[1] % 16 == 0 and mat.data_ptr() % 16 == 0,
                  f"{name}: the row length must be a multiple of 16 and the panel 16-byte aligned")


def read_step(pk_all: torch.Tensor, t: int, rows: int, blocks: int | None = None) -> torch.Tensor:
    """Read-only pass over step t's rows: out[r] = sum_j pk_all[t*rows + r, j]
    as int32 (q * 255 must stay below 2^31). blocks: the grid (default
    `gather_blocks`')."""
    if not pk_all.is_cuda:
        return read_step_plain(pk_all, t, rows)
    name = "micro.read_step"
    _check_bytes(pk_all, torch.uint8, name)
    q = pk_all.shape[1]
    _cuda.require(0 < rows and 0 <= t and (t + 1) * rows <= pk_all.shape[0],
                  f"{name}: step rows out of range")
    _cuda.require(q * 255 < 2 ** 31, f"{name}: a row's sum could pass int32")
    blocks = gather_blocks(rows, pk_all.device) if blocks is None else blocks
    _cuda.require(isinstance(blocks, int) and 0 < blocks < 2 ** 31, f"{name}: blocks must be > 0")
    out = torch.empty(rows, dtype=torch.int32, device=pk_all.device)
    err = _cuda.lib().ngt_read_step(pk_all.data_ptr() + t * rows * q, out.data_ptr(), rows, q,
                                    blocks, _cuda.stream_of(pk_all))
    _cuda.check(err, name)
    _cuda.LAUNCHES["read_step"] += 1
    return out


def dense_gather(mt: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """out[l] = sum_n mt[l, n] * y[n], mt (L, N) int8 dosages, y (N,). The
    grid is `gather_blocks`'."""
    if not mt.is_cuda:
        return dense_gather_plain(mt, y)
    name = "micro.dense_gather"
    _check_bytes(mt, torch.int8, name)
    rows, n = mt.shape
    _check_vec(y, mt, (n,), name)
    _cuda.require(rows > 0 and y.data_ptr() % 16 == 0, f"{name}: needs rows and an aligned y")
    _cuda.require(4 * n <= SMEM_BYTES,
                  f"{name}: {4 * n} bytes of y exceed a block's shared memory")
    out = torch.empty(rows, dtype=torch.float32, device=mt.device)
    err = _cuda.lib().ngt_dense_gather(mt.data_ptr(), y.data_ptr(), out.data_ptr(), rows, n,
                                       gather_blocks(rows, mt.device), _cuda.stream_of(mt))
    _cuda.check(err, name)
    _cuda.LAUNCHES["dense_gather"] += 1
    return out


def dense_scatter(mt: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """out[n] = sum_l u[l] * mt[l, n], mt (L, N) int8 dosages, u (L,). Row
    slices and a fixed-order second pass: bit-reproducible for a shape."""
    if not mt.is_cuda:
        return dense_scatter_plain(mt, u)
    name = "micro.dense_scatter"
    _check_bytes(mt, torch.int8, name)
    rows, n = mt.shape
    _check_vec(u, mt, (rows,), name)
    _cuda.require(rows > 0, f"{name}: needs rows")
    slices = pack2.rank_slices(rows, n)  # a 4-byte column word per thread
    partial = torch.empty((slices, n), dtype=torch.float32, device=mt.device)
    out = torch.empty(n, dtype=torch.float32, device=mt.device)
    err = _cuda.lib().ngt_dense_scatter(mt.data_ptr(), u.data_ptr(), partial.data_ptr(),
                                        out.data_ptr(), rows, n, slices, _cuda.stream_of(mt))
    _cuda.check(err, name)
    _cuda.LAUNCHES["dense_scatter"] += 1
    return out


_TICKETS = {}  # (device, stream) -> the fused step's own tile tickets (not K2's)


def fused_gather_blocks(rows: int) -> int:
    """The fused step's blocks that gather: one per 32 rows (a row group of
    K1's four per warp), so that a gather block streams about as many bytes
    as a scatter block (K2's 512 rows of a 512-byte tile) and the two roles
    interleave over the whole launch. A function of the shape alone."""
    return cdiv(rows, 32)


def fused_step(pk_all: torch.Tensor, t: int, t1: int, u: torch.Tensor, y4: torch.Tensor,
               gather_blocks: int | None = None):
    """One launch for both panel passes: r0 = unpack(step t1) @ y4planar and
    dy = u @ unpack(step t), steps of rows = len(u). Returns (r0 (rows,),
    dy planar (4, q)). The gather reads y4 as given, not y4 + dy: this is
    the overlap of the two passes, not a step of the sweep. On the card the
    gather blocks run K1's body and the scatter blocks K2's, so r0 has the
    bits of K1 on step t1 and dy those of K2 on step t. gather_blocks: the
    blocks that gather (default `fused_gather_blocks`); the rest are K2's
    grid. It moves no bit."""
    if not pk_all.is_cuda:
        return fused_step_plain(pk_all, t, t1, u, y4)
    name = "micro.fused_step"
    _check_bytes(pk_all, torch.uint8, name)
    q = pk_all.shape[1]
    rows = u.shape[0] if u.dim() == 1 else 0
    _check_vec(u, pk_all, (rows,), name)
    _check_vec(y4, pk_all, (4, q), name)
    _cuda.require(rows > 0 and all(0 <= s and (s + 1) * rows <= pk_all.shape[0] for s in (t, t1)),
                  f"{name}: step rows out of range")
    _cuda.require(y4.data_ptr() % 16 == 0, f"{name}: y4 must be 16-byte aligned")
    gather = fused_gather_blocks(rows) if gather_blocks is None else gather_blocks
    tiles, slices = pack2.rank_grid(rows, q)
    _cuda.require(isinstance(gather, int) and 0 < gather and tiles * slices + gather < 2 ** 31,
                  f"{name}: gather_blocks must be > 0 and the grid below 2^31 blocks")
    dev, stream = pk_all.device, _cuda.stream_of(pk_all)
    r0 = torch.empty(rows, dtype=torch.float32, device=dev)
    dy = torch.empty((4, q), dtype=torch.float32, device=dev)
    partial = tick = None
    if slices > 1:
        partial = torch.empty((slices, 4, q), dtype=torch.float32, device=dev)
        tick = pack2.tickets(_TICKETS, dev, stream, tiles)
    base = pk_all.data_ptr()
    err = _cuda.lib().ngt_fused_step(
        base + t * rows * q, base + t1 * rows * q, u.data_ptr(), y4.data_ptr(), r0.data_ptr(),
        None if partial is None else partial.data_ptr(), dy.data_ptr(),
        None if tick is None else tick.data_ptr(), rows, q, slices, gather, stream)
    _cuda.check(err, name)
    _cuda.LAUNCHES["fused_step"] += 1
    return r0, dy
