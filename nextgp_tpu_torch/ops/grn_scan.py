"""The GRN sampler's SNP scan: GRN1 (csrc/grn_scan.cu) and its plain version.

Counterpart of the `lax.scan` of `gene_scan`, vmapped over genes, in the
JAX package's GRN step (nextgp_tpu/grn/sampler.py:169-188): Lambda2's
single-site Gibbs pass over every SNP of every gene against the residual.
It replaces no Pallas kernel: the JAX package runs the loop as one compiled
scan on the device, and written as plain PyTorch on the card it would be S
dependent steps of several launches each.

For gene g (a row of r0, z, bold) and SNP q in order, with u holding the
new minus old effects of the SNPs before q:
    rhs     = r0[g, q] + gram[q] . (u with bold[g, q] at q)
    bnew[q] = rhs / gram[q, q] + z[g, q] sqrt(var_e / gram[q, q])
    u[q]    = bold[g, q] - bnew[q]
so that d = u solves tril(gram) D' = -(R0 + Z o sqrt(var_e diag(gram)))':
one forward substitution with G right-hand sides on one triangle, which
`grn_scan_system` hands to `torch.linalg.solve_triangular` (a yardstick on
the card and in the tests, on no sampler path). `grn_scan` launches the
kernel for CUDA tensors (float32 or float64; it raises on what the kernel
does not take) and runs the plain version for CPU tensors. All of them read
only gram's lower triangle. The kernel reads it as `grn_layout` packs it,
once a chain (`make_grn_step`); a call without a layout packs its own.
"""
from __future__ import annotations

import dataclasses

import torch

from . import _cuda

TILE = 32  # GRN1's SNPs a tile


@dataclasses.dataclass(frozen=True)
class GRNLayout:
    """tril(gram) as GRN1 walks it (`grn_layout`): `buf`, one flat tensor on
    gram's device in gram's type, for a scan over `n_snps` SNPs."""

    buf: torch.Tensor
    n_snps: int


def layout_words(S: int) -> int:
    """Words of a layout of S SNPs: the row blocks' tiles left of the
    diagonal, two chain tiles a tile, and the reciprocals and their roots."""
    nt = -(-S // TILE)
    return TILE * TILE * nt * (nt - 1) // 2 + 2 * TILE * TILE * nt + 2 * TILE * nt


def grn_layout(gram) -> GRNLayout:
    """Pack gram's lower triangle for GRN1, once a chain (gram is constant
    over it). With nt = ceil(S / 32) tiles, Sp = 32 nt, L = tril(gram) padded
    with zeros to (Sp, Sp), and a tile (i, k) = L[32 i:32 i + 32, 32 k:32 k
    + 32], the buffer holds, in order:
      - for each row block i = 1 .. nt - 1, its tiles k = 0 .. i - 1, each
        as [m][r][e] = tile[r, v m + e], v = 16 bytes / the word (a row's
        16-byte words, lane r's, consecutive across r);
      - for each i = 0 .. nt - 1, the diagonal tile (i, i) and the tile below
        it (i + 1, i) (zeros for the last), each as [s][r] = tile[r, s];
      - 1 / gram[q, q] and then its square root, for q < Sp (0 past S).
    Entries are gram's own, and the reciprocals are IEEE divides."""
    S = gram.shape[0]
    nt = -(-S // TILE)
    sp = TILE * nt
    v = 16 // gram.element_size()
    low = gram.new_zeros(sp, sp)
    low[:S, :S] = torch.tril(gram)
    tiles = low.view(nt, TILE, nt, TILE)  # [i, r, k, c]
    parts = [tiles[i, :, :i].reshape(TILE, i, TILE // v, v).permute(1, 2, 0, 3).reshape(-1)
             for i in range(1, nt)]
    idx = torch.arange(nt, device=gram.device)
    below = torch.cat([tiles[idx[1:], :, idx[:-1]], gram.new_zeros(1, TILE, TILE)])
    chain = torch.stack([tiles[idx, :, idx], below], dim=1).transpose(2, 3)  # (nt, 2, s, r)
    rinv = gram.new_zeros(sp)
    rinv[:S] = 1.0 / torch.diagonal(gram)
    buf = torch.cat(parts + [chain.reshape(-1), rinv, torch.sqrt(rinv)])
    return GRNLayout(buf=buf, n_snps=S)


def grn_scan_plain(gram, r0, z, bold, var_e):
    """The JAX scan's loop, SNP by SNP, all genes at once, in the JAX order
    of operations: gram (S, S), r0, z, bold (G, S), var_e a 0-d tensor ->
    (bnew, d), each (G, S), d = bold - bnew."""
    S = gram.shape[0]
    u = torch.zeros_like(r0)
    bnew = torch.empty_like(r0)
    for q in range(S):
        u[:, q] = bold[:, q]
        rhs = r0[:, q] + u[:, :q + 1] @ gram[q, :q + 1]
        lhs = gram[q, q]
        b = rhs / lhs + z[:, q] * torch.sqrt(var_e / lhs)
        bnew[:, q] = b
        u[:, q] = bold[:, q] - b
    return bnew, u


def grn_system(gram, r0, z, var_e):
    """The scan as one lower-triangular system tril(gram) D' = rhs:
    (tril(gram) (S, S), rhs (S, G)); its solution transposed is d."""
    rhs = -(r0 + z * torch.sqrt(var_e * torch.diagonal(gram)))
    return torch.tril(gram), rhs.T.contiguous()


def grn_scan_system(gram, r0, z, bold, var_e):
    """(bnew, d) through one torch.linalg.solve_triangular with G
    right-hand sides."""
    mat, rhs = grn_system(gram, r0, z, var_e)
    d = torch.linalg.solve_triangular(mat, rhs, upper=False).T
    return bold - d, d


_SMEM_SNPS: dict = {}  # (device, f64) -> ngt_grn_scan_smem_snps, read once a process


def smem_snps(device, f64: int) -> int:
    """The most SNPs whose d's GRN1 keeps in shared memory on device (24,384
    in float64, 53,440 in float32 on an H100); past it a call takes scratch."""
    key = (device, f64)
    if key not in _SMEM_SNPS:
        with torch.cuda.device(device):
            n = _cuda.lib().ngt_grn_scan_smem_snps(f64)
        _cuda.require(n > 0, "grn_scan: no CUDA device to plan the launch on")
        _SMEM_SNPS[key] = n
    return _SMEM_SNPS[key]


def scratch_words(G: int, S: int, smem: int) -> int:
    """Scratch words of a call: none up to smem SNPs (`smem_snps`), else a
    row of d's (S padded to a tile) a gene."""
    return 0 if S <= smem else G * TILE * -(-S // TILE)


def grn_scan_kernel(gram, r0, z, bold, var_e, layout=None):
    """GRN1 on the card: one launch, (bnew, d). layout: `grn_layout(gram)`
    (made here when None)."""
    ins = (gram, r0, z, bold, var_e)
    _cuda.require(all(t.is_cuda for t in ins) and len({t.device for t in ins}) == 1,
                  "grn_scan: every input must be on one CUDA device")
    dtype = r0.dtype
    _cuda.require(dtype in (torch.float32, torch.float64) and all(t.dtype == dtype for t in ins),
                  "grn_scan: every input must be float32, or every input float64")
    G, S = r0.shape if r0.dim() == 2 else (0, 0)
    _cuda.require(G >= 1 and S >= 1 and gram.shape == (S, S) and gram.is_contiguous(),
                  f"grn_scan: gram must be a contiguous ({S}, {S}) matrix and r0 (G, S) with G, S >= 1")
    _cuda.require(all(t.shape == (G, S) and t.is_contiguous() for t in (r0, z, bold)),
                  f"grn_scan: r0, z and bold must be contiguous ({G}, {S}) matrices")
    _cuda.require(var_e.numel() == 1, "grn_scan: var_e is one value")
    if layout is None:
        layout = grn_layout(gram)
    buf = layout.buf
    _cuda.require(layout.n_snps == S and buf.dtype == dtype and buf.device == r0.device and buf.is_contiguous()
                  and buf.numel() == layout_words(S),
                  f"grn_scan: the layout must be grn_layout of this ({S}, {S}) gram, in {dtype} on {r0.device}")
    f64 = int(dtype == torch.float64)
    words = scratch_words(G, S, smem_snps(r0.device, f64))
    scratch = torch.empty(words, dtype=dtype, device=r0.device) if words else None
    bnew, d = torch.empty_like(r0), torch.empty_like(r0)
    var_e = var_e.contiguous()
    err = _cuda.lib().ngt_grn_scan(buf.data_ptr(), r0.data_ptr(), z.data_ptr(), bold.data_ptr(),
                                   var_e.data_ptr(), bnew.data_ptr(), d.data_ptr(),
                                   None if scratch is None else scratch.data_ptr(), G, S, f64,
                                   _cuda.stream_of(r0))
    _cuda.check(err, "grn_scan")
    _cuda.LAUNCHES["grn_scan"] += 1
    return bnew, d


def grn_scan(gram, r0, z, bold, var_e, layout=None):
    """(bnew, d) of one SNP scan: the kernel for CUDA tensors (on layout,
    `grn_layout(gram)`, where given), the plain version for CPU tensors."""
    if r0.is_cuda:
        return grn_scan_kernel(gram, r0, z, bold, var_e, layout)
    return grn_scan_plain(gram, r0, z, bold, var_e)
