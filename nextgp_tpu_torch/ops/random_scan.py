"""The level scan of an uncorrelated random effect (RE1, csrc/level_scan.cu).

Counterpart of the `lax.scan` over levels in the JAX package's
`sample_random_uni` (nextgp_tpu/engine/samplers/random_effects.py:29-37;
NextGP.jl's sampleU, functions.jl:57-72). It replaces no Pallas kernel: the
JAX package runs the loop as one compiled scan on the device, and written
as plain PyTorch on the card it would be q dependent steps of several
launches each. `level_scan` launches the kernel for CUDA tensors (float32;
it raises on what the kernel does not take) and runs the plain version for
CPU tensors. Both run the levels in groups of `GROUP`: the strict upper
triangle's sums first, then per group the earlier groups' new values into
its rows (the segments more than `LOOKAHEAD` groups back, then the rest of
the window but the last group, then the last group), then its levels in
order with right-looking in-group sums.

`level_scan_system` states the same function as one unit lower-triangular
system (a Gauss-Seidel pass with fixed coefficients is one), which
`torch.linalg.solve_triangular` solves in one call: a yardstick on the card
and on no sweep path.
"""
from __future__ import annotations

import torch

from . import _cuda

GROUP = 32  # levels per group: one warp's chain in the kernel
LOOKAHEAD = 5  # csrc/level_scan.cu's kLook


def _rule(ivstr, yi, zpz, z, ive, ivu):
    """What does not depend on the levels before: u[i] = c[i] - b[i] * pre[i]
    with a = 1 / lhs, c = yi * a + z * sqrt(a), b = ivu * a."""
    a = 1.0 / (zpz * ive + torch.diagonal(ivstr) * ivu)
    return yi * a + z * torch.sqrt(a), ivu * a


def level_scan_plain(ivstr, yi, zpz, z, u, ive, ivu, tile=GROUP):
    """The level scan in the kernel's order: returns the new u (q,).

    For each level i in order, with the levels before i at their new values
    and those after i at their old ones:
        rhs  = yi[i] - ivu * sum_{k != i} ivstr[i, k] u[k]
        lhs  = zpz[i] * ive + ivstr[i, i] * ivu
        u[i] = rhs / lhs + z[i] * sqrt(1 / lhs)
    computed as the kernel does, u[i] = c[i] - b[i] * pre[i] (_rule; pre
    the sum above). `tile` sets the group (the kernel's is GROUP; its
    look-ahead is LOOKAHEAD groups); the result is the same up to the order
    of the sums."""
    q = u.shape[0]
    u = u.clone()
    c, b = _rule(ivstr, yi, zpz, z, ive, ivu)
    pre = torch.triu(ivstr, diagonal=1) @ u
    for s in range(0, q, tile):
        e = min(s + tile, q)
        w0, l0 = max(0, s - LOOKAHEAD * tile), max(0, s - tile)
        acc = pre[s:e] + ivstr[s:e, :w0] @ u[:w0]  # far: the owners' sums
        acc = acc + ivstr[s:e, w0:l0] @ u[w0:l0]  # the window
        acc = acc + ivstr[s:e, l0:s] @ u[l0:s]  # the last group, carried by the chain
        for j in range(s, e):
            uj = c[j] - b[j] * acc[j - s]
            u[j] = uj
            acc[j - s + 1:] += ivstr[j + 1:e, j] * uj
    return u


def level_scan_system(ivstr, yi, zpz, z, u, ive, ivu):
    """The level scan as a unit lower-triangular system M u_new = rhs:
    M = I + diag(b) tril(ivstr, -1), rhs = c - b * (triu(ivstr, 1) u_old)."""
    c, b = _rule(ivstr, yi, zpz, z, ive, ivu)
    mat = torch.eye(u.shape[0], dtype=ivstr.dtype, device=ivstr.device)
    mat = mat + b[:, None] * torch.tril(ivstr, diagonal=-1)
    return mat, (c - b * (torch.triu(ivstr, diagonal=1) @ u))[:, None]


def level_scan_kernel(ivstr, yi, zpz, z, u, ive, ivu):
    """RE1 on the card: one call, two launches, new u (q,)."""
    q = u.shape[0]
    vecs = (yi, zpz, z, u)
    _cuda.require(all(t.is_cuda and t.dtype == torch.float32 for t in (ivstr, *vecs, ive, ivu)),
                  "level_scan: every input must be float32 on a CUDA device")
    _cuda.require(len({t.device for t in (ivstr, *vecs, ive, ivu)}) == 1,
                  "level_scan: every input must be on one device")
    _cuda.require(ivstr.shape == (q, q) and ivstr.is_contiguous() and q >= 1,
                  f"level_scan: ivstr must be a contiguous ({q}, {q}) matrix")
    _cuda.require(all(t.shape == (q,) and t.is_contiguous() for t in vecs),
                  f"level_scan: yi, zpz, z and u must be contiguous ({q},) vectors")
    _cuda.require(ive.numel() == 1 and ivu.numel() == 1, "level_scan: ive and ivu are scalars")
    lib = _cuda.lib()
    out = u.clone()
    scratch = torch.empty(lib.ngt_level_scan_scratch_words(q), dtype=torch.float32, device=u.device)
    ive, ivu = ive.contiguous(), ivu.contiguous()
    err = lib.ngt_level_scan(
        ivstr.data_ptr(), q, yi.data_ptr(), zpz.data_ptr(), z.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), ive.data_ptr(), ivu.data_ptr(), _cuda.stream_of(u))
    _cuda.check(err, "level_scan")
    _cuda.LAUNCHES["level_scan"] += 1
    return out


def level_scan(ivstr, yi, zpz, z, u, ive, ivu):
    """The new u of one level scan: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if u.is_cuda:
        return level_scan_kernel(ivstr, yi, zpz, z, u, ive, ivu)
    return level_scan_plain(ivstr, yi, zpz, z, u, ive, ivu)
