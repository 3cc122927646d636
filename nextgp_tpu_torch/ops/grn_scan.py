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
only gram's lower triangle.
"""
from __future__ import annotations

import torch

from . import _cuda


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


def grn_scan_kernel(gram, r0, z, bold, var_e):
    """GRN1 on the card: one launch, (bnew, d)."""
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
    lib = _cuda.lib()
    words = lib.ngt_grn_scan_scratch_words(G, S)
    scratch = torch.empty(words, dtype=dtype, device=r0.device) if words else None
    bnew, d = torch.empty_like(r0), torch.empty_like(r0)
    var_e = var_e.contiguous()
    err = lib.ngt_grn_scan(gram.data_ptr(), r0.data_ptr(), z.data_ptr(), bold.data_ptr(),
                           var_e.data_ptr(), bnew.data_ptr(), d.data_ptr(),
                           None if scratch is None else scratch.data_ptr(), G, S,
                           int(dtype == torch.float64), _cuda.stream_of(r0))
    _cuda.check(err, "grn_scan")
    _cuda.LAUNCHES["grn_scan"] += 1
    return bnew, d


def grn_scan(gram, r0, z, bold, var_e):
    """(bnew, d) of one SNP scan: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if r0.is_cuda:
        return grn_scan_kernel(gram, r0, z, bold, var_e)
    return grn_scan_plain(gram, r0, z, bold, var_e)
