"""The level scans of the random effects: RE1, an uncorrelated effect's, and
RE2, a correlated group's (both csrc/level_scan.cu).

Counterpart of the `lax.scan` over levels in the JAX package's
`sample_random_uni` (nextgp_tpu/engine/samplers/random_effects.py:29-37;
NextGP.jl's sampleU, functions.jl:57-72). It replaces no Pallas kernel: the
JAX package runs the loop as one compiled scan on the device, and written
as plain PyTorch on the card it would be q dependent steps of several
launches each. `level_scan` launches the kernel for CUDA tensors (its
float32 instance, or its float64 one where every input is float64,
counted as `level_scan_f64`; it raises on what the kernel does not take)
and runs the plain version for CPU tensors. Both run the levels in groups
of `GROUP`: the strict upper triangle's sums first, then per group the
earlier groups' new values into its rows (the segments more than
`LOOKAHEAD` groups back, then the rest of the window but the last group,
then the last group), then its levels in order with right-looking
in-group sums.

`level_scan_system` states the same function as one unit lower-triangular
system (a Gauss-Seidel pass with fixed coefficients is one), which
`torch.linalg.solve_triangular` solves in one call: a yardstick on the card
and on no sweep path.

RE2 (`corr_level_scan`) is the counterpart of the `lax.scan` over levels in
the JAX package's `sample_random_corr` (random_effects.py:120-133;
NextGP.jl's tuple sampleU, functions.jl:75-88), nT effects per level. What
does not depend on u, the per-level rule (m_i, W_i) with u[:, i] = m_i -
W_i s_i, is computed for every level before the chain, so that the chain
carries an nT x nT matvec a level: for nT <= 4 by the kernel's prep launch
(one thread a level), above it and in the plain version by
`corr_level_rule` (batched torch.linalg calls, without host checks); the
kernel then runs RE1's design with nT channels (csrc/level_scan.cu, `re2`),
in float32 or, where every input is float64, in float64 (counted as
`corr_level_scan_f64`). It replaces no Pallas kernel.

`level_scan_smem_bytes` states the shared memory a block of each
instance's scan launch takes, as csrc/level_scan.cu lays it out; the
wrappers hold it against the card's opt-in limit (read once a process)
before they launch.
"""
from __future__ import annotations

import torch

from . import _cuda

GROUP = 32  # levels per group: one warp's chain in the kernel
LOOKAHEAD = 5  # csrc/level_scan.cu's kLook
SMEM_LIMIT = 232_448  # csrc/level_scan.cu's kSmemLimit: the shared memory an H100 block may opt in to
MAX_SLOTS = 7  # csrc/level_scan.cu's kMaxSlots: the chain's ring of group bands, at most
FAST_NT = 4  # csrc/level_scan.cu's re2::kFastNT: the largest nT of RE2's cooperative form


def level_scan_smem_bytes(n_t=0, itemsize=4):
    """Shared memory one block of the scan launch takes, as csrc/level_scan.cu
    lays it out: RE1's (n_t = 0) or RE2's cooperative form's at n_t <= 4 (0
    for the generic form, which takes none), in the float32 instance
    (itemsize 4) or the float64 one (8). The chain's block holds a ring of
    slots, each a group's band (L + 1 blocks of 32 rows, 36 elements apart
    in float32 and 34 in float64), its (c, b) or rule rows, the quads' e,
    up and win; then L + 2 groups of new u and 32 counters. The ring takes
    the most slots, up to MAX_SLOTS, that fit SMEM_LIMIT. An owner warp
    holds four staged blocks and 16 row blocks' sums; a block, four warps.
    The need is the larger of the two sides."""
    if n_t > FAST_NT:
        return 0
    stride = 36 if itemsize == 4 else 34
    blk = (LOOKAHEAD + 1) * 32 * stride
    ch = max(n_t, 1)
    slot = blk + (64 + 64 + 64 if n_t == 0 else 32 * (n_t + n_t * n_t) + 48 * n_t * n_t + 64 * n_t)
    chain = [itemsize * (s * slot + (LOOKAHEAD + 2) * 32 * ch) + 128 for s in range(MAX_SLOTS, 2, -1)]
    fits = [c for c in chain if c <= SMEM_LIMIT]
    owners = 4 * itemsize * (4 * 32 * stride + 16 * 32 * ch)
    return max(fits[0] if fits else chain[-1], owners)


_OPTIN: dict = {}  # CUDA device -> the shared memory a block may opt in to, read once a process


def _require_smem(name, n_t, t):
    """Raise, naming the instance, where the scan launch's shared memory
    exceeds what t's card lets a block opt in to."""
    need = level_scan_smem_bytes(n_t, t.element_size())
    if t.device not in _OPTIN:
        with torch.cuda.device(t.device):
            _OPTIN[t.device] = _cuda.lib().ngt_smem_optin_bytes()
    inst = f"{name}{'_f64' if t.dtype == torch.float64 else ''}" + (f" at nT = {n_t}" if n_t else "")
    _cuda.require(need <= _OPTIN[t.device],
                  f"{inst}: needs {need:,} bytes of shared memory a block, the card lets a block "
                  f"opt in to {_OPTIN[t.device]:,}")


def _real_of(name, tensors):
    """float32 or float64: the one type of every input on one CUDA device,
    else a ValueError."""
    dt = tensors[0].dtype
    _cuda.require(all(t.is_cuda for t in tensors) and dt in (torch.float32, torch.float64)
                  and all(t.dtype == dt for t in tensors),
                  f"{name}: every input must be float32, or every one float64, on a CUDA device")
    _cuda.require(len({t.device for t in tensors}) == 1, f"{name}: every input must be on one device")
    return dt


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
    """RE1 on the card: one call, two launches, new u (q,). Every input
    float32 (the float32 instance) or every one float64 (the float64
    instance, counted as `level_scan_f64`)."""
    q = u.shape[0]
    vecs = (yi, zpz, z, u)
    dt = _real_of("level_scan", (ivstr, *vecs, ive, ivu))
    _cuda.require(ivstr.shape == (q, q) and ivstr.is_contiguous() and q >= 1,
                  f"level_scan: ivstr must be a contiguous ({q}, {q}) matrix")
    _cuda.require(all(t.shape == (q,) and t.is_contiguous() for t in vecs),
                  f"level_scan: yi, zpz, z and u must be contiguous ({q},) vectors")
    _cuda.require(ive.numel() == 1 and ivu.numel() == 1, "level_scan: ive and ivu are scalars")
    lib, f64 = _cuda.lib(), dt == torch.float64
    _require_smem("level_scan", 0, u)
    out = u.clone()
    scratch = torch.empty(lib.ngt_level_scan_scratch_words(q), dtype=dt, device=u.device)
    ive, ivu = ive.contiguous(), ivu.contiguous()
    err = (lib.ngt_level_scan_f64 if f64 else lib.ngt_level_scan)(
        ivstr.data_ptr(), q, yi.data_ptr(), zpz.data_ptr(), z.data_ptr(), out.data_ptr(),
        scratch.data_ptr(), ive.data_ptr(), ivu.data_ptr(), _cuda.stream_of(u))
    _cuda.check(err, "level_scan")
    _cuda.LAUNCHES["level_scan_f64" if f64 else "level_scan"] += 1
    return out


def level_scan(ivstr, yi, zpz, z, u, ive, ivu):
    """The new u of one level scan: the kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if u.is_cuda:
        return level_scan_kernel(ivstr, yi, zpz, z, u, ive, ivu)
    return level_scan_plain(ivstr, yi, zpz, z, u, ive, ivu)


# ------------------------------------------------------------------ RE2


def corr_level_rule(ivstr, yi, zpz, z, var_e, ivu):
    """The per-level rule of the correlated level scan, for every level at
    once: cov_i = sym(inv(zpz_i / varE + A[i, i] iVarU)),
    m_i = cov_i yi[:, i] / varE + chol(cov_i) z_i and W_i = cov_i iVarU, so
    that u[:, i] = m_i - W_i s_i (s_i = sum_{k != i} A[i, k] u[:, k]).
    yi (nT, q), zpz (q, nT, nT), z (q, nT), ivu (nT, nT) -> m (q, nT),
    W (q, nT, nT). A non-positive-definite level gives NaN, with no host
    check (a captured sweep cannot sync)."""
    lhs = zpz / var_e + torch.diagonal(ivstr)[:, None, None] * ivu
    cov = torch.linalg.inv_ex(lhs, check_errors=False)[0]
    cov = (cov + cov.transpose(-1, -2)) / 2.0
    chol = torch.linalg.cholesky_ex(cov, check_errors=False)[0]
    m = (cov @ (yi.T / var_e)[..., None] + chol @ z[..., None])[..., 0]
    return m, cov @ ivu


def corr_level_scan_plain(ivstr, yi, zpz, z, u, var_e, ivu):
    """The correlated level scan: the loop of the JAX package's
    sample_random_corr in the rule's form. For each level i in order, with
    the levels before i at their new values and those after at their old:
    s = sum_{k != i} ivstr[i, k] u[:, k], u[:, i] = m_i - W_i s.
    u (nT, q) -> the new u (nT, q)."""
    m, W = corr_level_rule(ivstr, yi, zpz, z, var_e, ivu)
    up = u @ torch.triu(ivstr, diagonal=1).T  # the levels after i, at their old values
    u = u.clone()
    for i in range(u.shape[1]):
        s = up[:, i] + u[:, :i] @ ivstr[i, :i]
        u[:, i] = m[i] - W[i] @ s
    return u


def corr_level_scan_with(lib, ivstr, yi, zpz, z, u, var_e, ivu):
    """One RE2 call through `lib` (the port's library, or another build of
    csrc/level_scan.cu with its C interface): for nT <= 4 the rule is built
    in the kernel's prep launch, above it by corr_level_rule here; the new u
    (nT, q). Every input float32, or every one float64 (the float64
    instance, `ngt_corr_level_scan_f64`)."""
    n_t, q = u.shape
    dt = _real_of("corr_level_scan", (ivstr, yi, zpz, z, u, var_e, ivu))
    _cuda.require(ivstr.shape == (q, q) and ivstr.is_contiguous() and q >= 1,
                  f"corr_level_scan: ivstr must be a contiguous ({q}, {q}) matrix")
    _cuda.require(yi.shape == (n_t, q) and zpz.shape == (q, n_t, n_t) and z.shape == (q, n_t)
                  and ivu.shape == (n_t, n_t) and var_e.numel() == 1,
                  "corr_level_scan: yi (nT, q), zpz (q, nT, nT), z (q, nT), ivu (nT, nT), var_e a scalar")
    _require_smem("corr_level_scan", n_t, u)
    rule = None
    if lib.ngt_corr_level_scan_takes_rule(n_t):
        m, W = corr_level_rule(ivstr, yi, zpz, z, var_e, ivu)
        rule = torch.zeros((-(-q // GROUP) * GROUP, n_t + n_t * n_t), dtype=dt, device=u.device)
        rule[:q, :n_t] = m
        rule[:q, n_t:] = W.reshape(q, -1)
    yi, zpz, z, u_old, var_e, ivu = (t.contiguous() for t in (yi, zpz, z, u, var_e, ivu))
    out = torch.empty_like(u_old)
    scratch = torch.empty(lib.ngt_corr_level_scan_scratch_words(q, n_t), dtype=dt, device=u.device)
    entry = lib.ngt_corr_level_scan_f64 if dt == torch.float64 else lib.ngt_corr_level_scan
    err = entry(ivstr.data_ptr(), q, n_t, yi.data_ptr(), zpz.data_ptr(), z.data_ptr(), var_e.data_ptr(),
                ivu.data_ptr(), None if rule is None else rule.data_ptr(), u_old.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), _cuda.stream_of(u))
    _cuda.check(err, "corr_level_scan")
    return out


def corr_level_scan_kernel(ivstr, yi, zpz, z, u, var_e, ivu):
    """RE2 on the card: one call (two launches for nT <= 4, RE1's prep, which
    also builds the per-level rule, and its cooperative look-ahead launch;
    the generic form, after the rule batched here, 2 ceil(q / 1024)); the new
    u (nT, q). float64 inputs run the float64 instance, counted as
    `corr_level_scan_f64`."""
    out = corr_level_scan_with(_cuda.lib(), ivstr, yi, zpz, z, u, var_e, ivu)
    _cuda.LAUNCHES["corr_level_scan_f64" if out.dtype == torch.float64 else "corr_level_scan"] += 1
    return out


def corr_level_scan(ivstr, yi, zpz, z, u, var_e, ivu):
    """The new u (nT, q) of one correlated level scan: the kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if u.is_cuda:
        return corr_level_scan_kernel(ivstr, yi, zpz, z, u, var_e, ivu)
    return corr_level_scan_plain(ivstr, yi, zpz, z, u, var_e, ivu)


def corr_level_scan_system(ivstr, yi, zpz, z, u, var_e, ivu):
    """The correlated level scan as one unit lower-triangular system of
    q nT unknowns (level-major): u_i + W_i sum_{k<i} A[i, k] u_k =
    m_i - W_i sum_{k>i} A[i, k] u_old_k, which torch.linalg.solve_triangular
    solves in one call (a yardstick on the card, on no sweep path). Returns
    (matrix, rhs (q nT, 1)); the solution reshaped (q, nT) and transposed is
    the new u."""
    n_t, q = u.shape
    m, W = corr_level_rule(ivstr, yi, zpz, z, var_e, ivu)
    low = torch.tril(ivstr, diagonal=-1)
    mat = (W[:, :, None, :] * low[:, None, :, None]).reshape(q * n_t, q * n_t)
    mat.diagonal().add_(1.0)
    up = u @ torch.triu(ivstr, diagonal=1).T  # (nT, q)
    rhs = m - (W @ up.T[..., None])[..., 0]
    return mat, rhs.reshape(-1, 1)
