"""The in-block single-site Gibbs scans, V chains at a time.

Counterpart of `nextgp_tpu/ops/gibbs_kernels.py` for the methods the port
carries. Per method, a coefficient pack (a plain tensor function in both
packages) and a sequential scan with a plain PyTorch version and a CUDA
kernel:

    BayesR       r_block_pack      r_block_scan_v     K3, csrc/r_scan.cu
    BayesPR      gauss_block_pack  gauss_block_scan_v K6, csrc/gauss_bc_scan.cu
    BayesB/C     bc_block_pack     bc_block_scan_v    K8, csrc/gauss_bc_scan.cu
    BayesB/C+D   bc_block_pack     bc_block_scan_wv   K10, csrc/gauss_bc_scan.cu
    BayesRCpi    rcpi_block_pack   rcpi_block_scan_v  K12, csrc/rc_scan.cu
    BayesRCplus  rcplus_block_pack rcplus_block_scan_v K14, csrc/rc_scan.cu

Every kernel is a rule class on one skeleton, `csrc/scan_skeleton.cuh`
(one block per chain, right-looking sums, a warp per group of 32 loci); K8
and K10 are one B/C rule over one Gram and over two.

V=1 is each scan's single-chain form (`r_block_scan`, `gauss_block_scan`,
`bc_block_scan`, `bc_block_scan_w`, `rcpi_block_scan`, `rcplus_block_scan`
in the JAX package). BayesLV runs the Gaussian scan with per-locus
variances.

Everything per locus that does not depend on the chain state is computed
up front by the pack, so one locus of a scan costs one Gram-row dot product
(two for the weighted B/C scan) and a few scalar steps (see the JAX module's
docstring for the algebra). Packed coefficient rows:
    gauss (8):     [adj, bold, b, c, pad*4]
    bc (8):        [adj, bold, q0, q1, w, b, c, adj_raw]
    r (8 + 4K):    [adj, bold, unif, mask, pad*4 | q0(K), q1(K), b(K), c(K)]
    rcpi (8 + 8AK):   [adj, bold, ua, uv, mask, pad*3 | aprob, g1, g2, anz (each
                      per annotation, repeated K times), q0, q1, b, c (A x K)]
    rcplus (8 + 6AK): [adj, bold, mask, pad*5 | ua, anz (per annotation,
                      repeated K times), q0, q1, b, c (A x K)]
The annotation methods keep the JAX packs' row layouts, so a per-annotation
value sits at every K-th slot of its section; the scans read it there once.
The caller adds r0 to slot 0 per block (the restore of beta_old is folded
into `adj`), and for the weighted B/C scan the raw r0 to slot 7. Unlike the
JAX packs, which always emit float32, the packs here keep their input's
dtype.
"""
from __future__ import annotations

import torch

from . import _cuda
from .dists import categorical_from_probs

SMEM_BYTES = 227 * 1024  # what one thread block may use on Hopper


def _pack8(*cols):
    pk = torch.stack(cols, dim=1)
    pad = 8 - pk.shape[1]
    return torch.cat([pk, pk.new_zeros((pk.shape[0], pad))], dim=1) if pad else pk


def gauss_block_pack(r0_extra, beta_old, z, ivb, mpm, lss, rss, mask, ive):
    """Gaussian (BayesPR) coefficients for all p loci -> (p, 8):
    beta = c + b * pre. r0_extra: an additive offset already known before
    the sweep."""
    lhs = mpm * ive + lss + ivb
    invlhs = 1.0 / lhs
    zero = torch.zeros((), dtype=beta_old.dtype, device=beta_old.device)
    b = torch.where(mask, ive * invlhs, zero)
    c = torch.where(mask, rss * invlhs + z * torch.sqrt(invlhs), zero)
    return _pack8(r0_extra + mpm * beta_old, beta_old, b, c)


def bc_block_pack(beta_old, z, unif, vb, ivb, mpm, lss, rss, mask, ive, var_e, lp0, lp1, common,
                  mpm_raw=None):
    """BayesB/C coefficients -> (p, 8). The indicator u < 1/(1+exp(ld0-ld1))
    becomes q0 + q1*rrr^2 < w = log((1-u)/u) (functions.jl:171-173). Padded
    loci get q0 = +inf and are never included; vb = 0 gives ivb = inf and so
    b = c = 0. mpm_raw (weighted models only): the raw m'm diagonal; slot 7
    then carries the raw restore mpm_raw * beta_old."""
    one = torch.ones((), dtype=beta_old.dtype, device=beta_old.device)
    mpm_safe = torch.where(mask, mpm, one)
    v0 = mpm_safe * var_e
    v1 = mpm_safe * mpm_safe * vb + v0
    q0 = -0.5 * (torch.log(v0) - torch.log(v1)) + lp0 - lp1
    q0 = torch.where(mask, q0, torch.full_like(q0, float("inf")))
    q1 = -0.5 * (1.0 / v0 - 1.0 / v1)
    w = torch.log1p(-unif) - torch.log(unif)
    lhs = mpm_safe * ive + lss + ivb
    invlhs = 1.0 / lhs
    b = ive * invlhs
    rss_eff = 0.0 if common else rss  # BayesC omits rhs_ss (functions.jl:219)
    c = rss_eff * invlhs + z * torch.sqrt(invlhs)
    cols = (mpm * beta_old, beta_old, q0, q1, w, b, c)
    if mpm_raw is not None:
        cols = cols + (mpm_raw * beta_old,)
    return _pack8(*cols)


def _class_coeffs(mpm, lss, mask, varc, logpi, ive):
    """Per locus and variance class: q0, q1 of logl = q0 + q1 * pre^2 and
    1/lhs (0 for a null class, varc = 0). varc and logpi are (K,) or (A, K);
    the results are (p, K) or (p, A, K)."""
    nz = varc > 0
    one = torch.ones((), dtype=mpm.dtype, device=mpm.device)
    zero = torch.zeros((), dtype=mpm.dtype, device=mpm.device)
    per_locus = (slice(None),) + (None,) * varc.ndim
    varc_s = torch.where(nz, varc, one)
    mpm_safe = torch.where(mask, mpm, one)
    lhs = torch.where(nz, mpm_safe[per_locus] * ive + lss[per_locus] + 1.0 / varc_s, zero)
    lhs_s = torch.where(nz, lhs, one)
    invlhs = torch.where(nz, 1.0 / lhs_s, zero)
    q0 = torch.where(nz, -0.5 * torch.log(varc_s * lhs_s), zero) + logpi
    q1 = 0.5 * invlhs * ive * ive
    return q0, q1, invlhs


def r_block_pack(beta_old, z, unif, mpm, lss, rss, mask, varc, logpi, ive, var_e):
    """BayesR coefficients for all p loci -> (p, 8 + 4K) in beta_old's dtype:
    logl_k = q0_k + q1_k * pre^2, beta = c_k + b_k * pre, with rss folded
    into the additive slot (rhs = (r0 + dot + mpm*bold + rss*varE) * iVarE)."""
    dtype = beta_old.dtype
    zero = torch.zeros((), dtype=dtype, device=beta_old.device)
    q0, q1, invlhs = _class_coeffs(mpm, lss, mask, varc, logpi, ive)
    bco = torch.where(mask[:, None], ive * invlhs, zero)
    cco = torch.where(mask[:, None], z[:, None] * torch.sqrt(invlhs), zero)
    adj = mpm * beta_old + rss * var_e
    head = torch.stack([adj, beta_old, unif, mask.to(dtype)], dim=1)
    pad = torch.zeros((beta_old.shape[0], 4), dtype=dtype, device=beta_old.device)
    return torch.cat([head, pad, q0, q1, bco, cco], dim=1)


def _rc_rows(head, per_annot, per_class, K):
    """[head (8) | per-annotation (p, A) sections, each value repeated K
    times | per-class (p, A, K) sections, flattened]."""
    p = head.shape[0]
    return torch.cat([head] + [x.to(head.dtype).repeat_interleave(K, dim=1) for x in per_annot]
                     + [x.reshape(p, -1) for x in per_class], dim=1)


def rcpi_block_pack(beta_old, z, ua, uv, g1, g2, aprob, anz, mpm, lss, rss, mask, varc, logpi,
                    ive, var_e):
    """BayesRCpi coefficients -> (p, 8 + 8AK). ua, uv: the annotation and
    class uniforms (p,); g1, g2 (p, A): the gammas of the annotation-prob
    Dirichlet (shape annot_input, and annot_input + 1 for the annotation
    drawn); aprob (p, A), anz (p, A) bool; varc, logpi (A, K)."""
    dtype = beta_old.dtype
    K = varc.shape[1]
    zero = torch.zeros((), dtype=dtype, device=beta_old.device)
    q0, q1, invlhs = _class_coeffs(mpm, lss, mask, varc, logpi, ive)
    on = mask[:, None, None]
    bco = torch.where(on, ive * invlhs, zero)
    cco = torch.where(on, z[:, None, None] * torch.sqrt(invlhs), zero)
    head = _pack8(mpm * beta_old + rss * var_e, beta_old, ua, uv, mask.to(dtype))
    return _rc_rows(head, (aprob, g1, g2, anz), (q0, q1, bco, cco), K)


def rcplus_block_pack(beta_old, z, ua, anz, mpm, lss, rss, mask, varc, logpi, ive, var_e):
    """BayesRCplus coefficients -> (p, 8 + 6AK). z, ua (p, A): one normal
    and one uniform per annotation component; anz (p, A) bool. b and c are
    zero for a null class and for a component that is not active (padded
    locus or zero annotation), which the scan's nz output relies on. Slot 0
    carries rss * var_e only: the scan excludes the locus's own coefficient
    and adds it back per component through the Gram diagonal."""
    dtype = beta_old.dtype
    K = varc.shape[1]
    zero = torch.zeros((), dtype=dtype, device=beta_old.device)
    q0, q1, invlhs = _class_coeffs(mpm, lss, mask, varc, logpi, ive)
    active = (mask[:, None] & anz)[:, :, None]
    bco = torch.where(active, ive * invlhs, zero)
    cco = torch.where(active, z[:, :, None] * torch.sqrt(invlhs), zero)
    head = _pack8(rss * var_e, beta_old, mask.to(dtype))
    return _rc_rows(head, (ua, anz), (q0, q1, bco, cco), K)


def r_block_scan_v_plain(gram, pk, n_classes):
    """Plain version of the scan. gram (B, V, B) locus-major, pk (V, B, W)
    -> beta (V, B), u (V, B), delta (V, B) int32."""
    K = n_classes
    V, B, _ = pk.shape
    u = torch.zeros((V, B), dtype=pk.dtype, device=pk.device)
    beta = torch.zeros_like(u)
    delta = torch.zeros((V, B), dtype=torch.int32, device=pk.device)
    for j in range(B):
        s = pk[:, j]  # (V, W)
        pre = s[:, 0] + (gram[j] * u).sum(-1)
        logl = s[:, 8:8 + K] + s[:, 8 + K:8 + 2 * K] * (pre * pre)[:, None]
        logl = logl - logl.max(dim=-1, keepdim=True).values
        e = torch.exp(logl)
        cls = categorical_from_probs(s[:, 2], e / e.sum(dim=-1, keepdim=True)).long()
        bco = s[:, 8 + 2 * K:8 + 3 * K].gather(1, cls[:, None])[:, 0]
        cco = s[:, 8 + 3 * K:8 + 4 * K].gather(1, cls[:, None])[:, 0]
        bnew = cco + bco * pre
        beta[:, j] = bnew
        u[:, j] = s[:, 1] - bnew
        delta[:, j] = torch.where(s[:, 3] != 0, cls + 1, 0).to(torch.int32)
    return beta, u, delta


def gauss_block_scan_v_plain(gram, pk):
    """Plain version of the Gaussian scan. gram (B, V, B) locus-major,
    pk (V, B, 8) -> beta (V, B), u (V, B)."""
    V, B, _ = pk.shape
    u = torch.zeros((V, B), dtype=pk.dtype, device=pk.device)
    beta = torch.zeros_like(u)
    for j in range(B):
        s = pk[:, j]
        pre = s[:, 0] + (gram[j] * u).sum(-1)
        bnew = s[:, 3] + s[:, 2] * pre
        beta[:, j] = bnew
        u[:, j] = s[:, 1] - bnew
    return beta, u


def gauss_block_system(gram, pk):
    """The Gaussian scan as V unit lower-triangular systems M_v u_v = rhs_v
    (a Gauss-Seidel pass with fixed coefficients): M_v = I + diag(b_v)
    tril(G_v, -1), rhs_v = bold_v - c_v - b_v * s0_v (pk slots 1, 3, 2, 0),
    G_v[j, i] = gram[j, v, i]. A masked locus (b = c = 0) is an identity
    row. gram (B, V, B), pk (V, B, 8) -> (V, B, B), (V, B, 1). One batched
    torch.linalg.solve_triangular gives u (beta = bold - u): a yardstick on
    the card (chip_smoke.py); no sweep path runs it."""
    s0, bold, b, c = pk[..., 0], pk[..., 1], pk[..., 2], pk[..., 3]
    eye = torch.eye(pk.shape[1], dtype=pk.dtype, device=pk.device)
    mat = eye + b[..., None] * torch.tril(gram.permute(1, 0, 2), diagonal=-1)
    return mat, (bold - c - b * s0)[..., None]


def _bc_plain(gram, graw, pk):
    V, B, _ = pk.shape
    u = torch.zeros((V, B), dtype=pk.dtype, device=pk.device)
    beta = torch.zeros_like(u)
    delta = torch.zeros((V, B), dtype=torch.int32, device=pk.device)
    zero = torch.zeros((), dtype=pk.dtype, device=pk.device)
    for j in range(B):
        s = pk[:, j]
        pre = s[:, 0] + (gram[j] * u).sum(-1)
        prer = pre if graw is None else s[:, 7] + (graw[j] * u).sum(-1)
        inc = s[:, 2] + s[:, 3] * prer * prer < s[:, 4]
        bnew = torch.where(inc, s[:, 6] + s[:, 5] * pre, zero)
        beta[:, j] = bnew
        u[:, j] = s[:, 1] - bnew
        delta[:, j] = inc.to(torch.int32)
    return beta, u, delta


def bc_block_scan_v_plain(gram, pk):
    """Plain version of the B/C scan. gram (B, V, B), pk (V, B, 8) ->
    beta (V, B), u (V, B), delta (V, B) int32 (1 = included)."""
    return _bc_plain(gram, None, pk)


def bc_block_scan_wv_plain(gram, graw, pk):
    """Plain version of the weighted B/C scan: the weighted Gram gram sets
    beta, the raw Gram graw (with slot 7) decides the indicator."""
    return _bc_plain(gram, graw, pk)


def _sections(s, first, count, A, K):
    """`count` consecutive A*K-wide sections of the rows s (V, W), from
    slot `first`, each as (V, A, K)."""
    AK = A * K
    return [s[:, first + k * AK:first + (k + 1) * AK].reshape(-1, A, K) for k in range(count)]


def _pick(x, idx):
    """x (V, n), idx (V,) -> x[v, idx[v]]."""
    return x.gather(1, idx[:, None])[:, 0]


def rcpi_block_scan_v_plain(gram, pk, n_annot, n_classes):
    """Plain version of the BayesRCpi scan. gram (B, V, B) locus-major, pk
    (V, B, 8 + 8AK) -> beta, u (V, B), delta, acat (V, B) int32 (1-based, 0
    on padded loci), aprob (V, B, A).

    Per locus: the annotation is drawn from aprob_a * sum_k exp(logl_ak)
    over the non-zero annotations, then the class within it; both inverse
    CDFs are clamped to their last entry. The new annotation probabilities
    are the normalized gammas (g2 at the drawn annotation, g1 elsewhere).
    A padded locus has no non-zero annotation, so its sums are 0 and its
    probabilities NaN: every comparison with them is false (annotation and
    class 0), and the selects keep beta = 0 and the old aprob."""
    A, K = n_annot, n_classes
    V, B, _ = pk.shape
    dtype, device = pk.dtype, pk.device
    zero = torch.zeros((), dtype=dtype, device=device)
    u = torch.zeros((V, B), dtype=dtype, device=device)
    beta = torch.zeros_like(u)
    delta = torch.zeros((V, B), dtype=torch.int32, device=device)
    acat = torch.zeros_like(delta)
    aprob_out = torch.zeros((V, B, A), dtype=dtype, device=device)
    annots = torch.arange(A, device=device)
    for j in range(B):
        s = pk[:, j]
        pre = s[:, 0] + (gram[j] * u).sum(-1)
        aprob, g1, g2, anz = (x[:, :, 0] for x in _sections(s, 8, 4, A, K))
        q0, q1, bco, cco = _sections(s, 8 + 4 * A * K, 4, A, K)
        on = s[:, 4] != 0
        logl = q0 + q1 * (pre * pre)[:, None, None]
        logl = logl - logl.reshape(V, -1).max(dim=-1).values[:, None, None]
        e = torch.where((anz != 0)[:, :, None], torch.exp(logl), zero)
        rowsum = e.sum(-1)
        pa = aprob * rowsum
        a_sel = categorical_from_probs(s[:, 2], pa / pa.sum(-1, keepdim=True)).long()
        row = e[torch.arange(V, device=device), a_sel]  # (V, K)
        cls = categorical_from_probs(s[:, 3], row / row.sum(-1, keepdim=True)).long()
        idx = a_sel * K + cls
        bnew = _pick(cco.reshape(V, -1), idx) + _pick(bco.reshape(V, -1), idx) * pre
        gam = torch.where(annots[None, :] == a_sel[:, None], g2, g1) * anz
        aprob_out[:, j] = torch.where(on[:, None], gam / gam.sum(-1, keepdim=True), aprob)
        beta[:, j] = bnew
        u[:, j] = s[:, 1] - bnew
        delta[:, j] = torch.where(on, cls + 1, 0).to(torch.int32)
        acat[:, j] = torch.where(on, a_sel + 1, 0).to(torch.int32)
    return beta, u, delta, acat, aprob_out


def rcplus_block_scan_v_plain(gram, pk, n_annot, n_classes):
    """Plain version of the BayesRCplus scan. gram (B, V, B) locus-major, pk
    (V, B, 8 + 6AK) -> beta, u (V, B), delta (V, B) int32 (the class of the
    last active annotation), and per annotation cls (V, B, A) int32
    (1-based, 0 where inactive), bs (V, B, A) the component drawn, nz
    (V, B, A) int32 (1 where a non-null class of an active component was
    drawn, read off b > 0).

    The locus effect is the sum of one component per annotation; after each
    component the rhs is refreshed through the Gram diagonal g_jj, read
    from the row: pre_a = base + g_jj * (beta_old - components so far)."""
    A, K = n_annot, n_classes
    V, B, _ = pk.shape
    dtype, device = pk.dtype, pk.device
    u = torch.zeros((V, B), dtype=dtype, device=device)
    beta = torch.zeros_like(u)
    delta = torch.zeros((V, B), dtype=torch.int32, device=device)
    cls_out = torch.zeros((V, B, A), dtype=torch.int32, device=device)
    bs_out = torch.zeros((V, B, A), dtype=dtype, device=device)
    nz_out = torch.zeros_like(cls_out)
    for j in range(B):
        s = pk[:, j]
        base = s[:, 0] + (gram[j] * u).sum(-1)  # u[:, j] is 0: own coefficient excluded
        gjj = gram[j][:, j]
        on = s[:, 2] != 0
        ua, anz = (x[:, :, 0] for x in _sections(s, 8, 2, A, K))
        q0, q1, bco, cco = _sections(s, 8 + 2 * A * K, 4, A, K)
        ujc = s[:, 1]
        total = torch.zeros_like(ujc)
        dj = torch.zeros((V,), dtype=torch.int64, device=device)
        for a in range(A):
            prea = base + gjj * ujc
            logl = q0[:, a] + q1[:, a] * (prea * prea)[:, None]
            e = torch.exp(logl - logl.max(dim=-1, keepdim=True).values)
            cls = categorical_from_probs(ua[:, a], e / e.sum(-1, keepdim=True)).long()
            bsel = _pick(bco[:, a], cls)
            bs = _pick(cco[:, a], cls) + bsel * prea
            active = (anz[:, a] != 0) & on
            ujc = ujc - bs
            total = total + bs
            dj = torch.where(active, cls + 1, dj)
            cls_out[:, j, a] = torch.where(active, cls + 1, 0).to(torch.int32)
            bs_out[:, j, a] = bs
            nz_out[:, j, a] = (bsel > 0).to(torch.int32)
        beta[:, j] = total
        u[:, j] = ujc
        delta[:, j] = dj.to(torch.int32)
    return beta, u, delta, cls_out, bs_out, nz_out


def _launch(name, grams, pk, width, more_outs, *extra):
    """Launch one V-batched scan kernel, `ngt_<name>` in float32 or its
    float64 instance `ngt_<name>_f64` where the Grams and pk are all
    float64 (counted as `<name>_f64`); anything else (float16, or float32
    beside float64) raises. grams: the step-indexed ((T, B, V, B), t) pairs
    the kernel reads. more_outs: (trailing shape, dtype) of each output
    after beta and u (V, B), all (V, B, ...); a float32 there is the scan's
    own type. Returns (beta, u, *more)."""
    tensors = [g for g, _ in grams] + [pk]
    _cuda.require(all(x.is_cuda and x.device == pk.device for x in tensors),
                  f"{name}: gram and pk must be on one CUDA device")
    f64 = all(x.dtype == torch.float64 for x in tensors)
    _cuda.require(f64 or all(x.dtype == torch.float32 for x in tensors),
                  f"{name}: gram and pk must be float32, or both float64")
    _cuda.require(all(x.is_contiguous() for x in tensors), f"{name}: gram and pk must be contiguous")
    T, B, V, B2 = grams[0][0].shape
    _cuda.require(B == B2 and all(g.shape == (T, B, V, B) and 0 <= t < T for g, t in grams),
                  f"{name}: gram must be (T, B, V, B) and 0 <= t < T")
    _cuda.require(pk.shape == (V, B, width), f"{name}: pk must be ({V}, {B}, {width})")
    _cuda.require(B <= 1024, f"{name}: needs B <= 1024")
    real = pk.dtype
    outs = [torch.empty((V, B) + tuple(tail), dtype=real if dtype == torch.float32 else dtype,
                        device=pk.device)
            for tail, dtype in [((), torch.float32)] * 2 + list(more_outs)]
    ptrs = [g.data_ptr() + t * B * V * B * pk.element_size() for g, t in grams]
    err = getattr(_cuda.lib(), f"ngt_{name}_f64" if f64 else f"ngt_{name}")(
        *ptrs, pk.data_ptr(), *(o.data_ptr() for o in outs), V, B, *extra, _cuda.stream_of(pk))
    _cuda.check(err, f"gibbs_kernels.{name}")
    _cuda.LAUNCHES[name + "_f64" if f64 else name] += 1
    return tuple(outs)


def _step(gram_t, on_cuda):
    """(gram, t) for a locus-major (B, V, B) block or a step-indexed pair:
    the kernels take the pair (a single block is step 0 of a one-step
    array), the plain versions a (B, V, B) block."""
    gram, t = gram_t if isinstance(gram_t, tuple) else (gram_t, None)
    if on_cuda:
        return (gram[None], 0) if t is None else (gram, t)
    return gram if t is None else gram[t]


_DELTA = [((), torch.int32)]  # the one extra output of K3, K8 and K10


def _skeleton_words(B, grams):
    """Shared memory of the scans' skeleton (`csrc/scan_skeleton.cuh`) in
    elements of the scan's type: the chain's u's, one per thread of the
    block, and two rotating slots of `grams` diagonal 32 x 33 Gram tiles."""
    return 32 * -(-B // 32) + 2 * grams * 32 * 33


R_LANE_MAX_K = 8  # csrc/r_scan.cu's kLaneMaxK: the largest K whose rule runs in one lane


def r_scan_smem_bytes(B, K, itemsize=4):
    """Shared memory one block of K3 needs, as `csrc/r_scan.cu` lays it
    out after the skeleton's: for the rule in one lane's registers
    (K <= R_LANE_MAX_K) two groups' whole coefficient rows (2 x 32 rows of
    8 + 4K elements), above that two rows and K elements of the serial
    rule's scratch. itemsize: 4 for the float32 instance, 8 for float64,
    whose every element (the skeleton's too) takes 8 bytes."""
    W = 8 + 4 * K
    return itemsize * (_skeleton_words(B, 1) + (2 * 32 * W if K <= R_LANE_MAX_K else 2 * W + K))


def r_block_scan_v(gram_t, pk, n_classes):
    """V-batched BayesR scan (K3). gram_t is the locus-major (B, V, B) Gram
    block or the step-indexed pair ((T, B, V, B), t); pk (V, B, 8 + 4K).
    Returns beta (V, B), u (V, B), delta (V, B) int32. The kernel stages
    each group's coefficients as it goes, so no chain's rows need fit shared
    memory and K has no cap; sums and comparisons as in rcpi_block_scan_v.
    It has a float32 and a float64 instance (gram and pk in one of them)."""
    K = n_classes
    if pk.is_cuda:
        _cuda.require(K >= 1, "r_block_scan_v: needs K >= 1")
        B = pk.shape[1]
        _cuda.require(r_scan_smem_bytes(B, K, pk.element_size()) <= SMEM_BYTES,
                      f"r_block_scan_v: B={B}, K={K}: two coefficient rows exceed shared memory")
        return _launch("r_block_scan_v", [_step(gram_t, True)], pk, 8 + 4 * K, _DELTA, K)
    return r_block_scan_v_plain(_step(gram_t, False), pk, K)


def scan8_smem_bytes(B, grams, itemsize=4):
    """Shared memory one block of K6, K8 (grams = 1) or K10 (grams = 2)
    needs, as `csrc/gauss_bc_scan.cu` lays it out after the skeleton's: two
    groups' rows (2 x 32 rows of 8 elements). itemsize: 4 for the float32
    instances, 8 for float64, whose every element takes 8 bytes: 14,592 and
    23,040 bytes at B = 1,024 in float32, 29,184 and 46,080 in float64."""
    return itemsize * (_skeleton_words(B, grams) + 2 * 32 * 8)


def _scan8(name, grams, pk, more_outs):
    """K6, K8 and K10: the float32 instance, or the float64 one where the
    Gram(s) and pk are all float64 (counted as `<name>_f64`)."""
    B = pk.shape[1]
    _cuda.require(scan8_smem_bytes(B, len(grams), pk.element_size()) <= SMEM_BYTES,
                  f"{name}: B={B}: the scan's shared memory exceeds a block's")
    return _launch(name, grams, pk, 8, more_outs)


def gauss_block_scan_v(gram_t, pk):
    """V-batched Gaussian scan (K6), BayesPR and BayesLV. gram_t as for
    r_block_scan_v; pk (V, B, 8). Returns beta (V, B), u (V, B). The kernel
    stages each group's 32 rows as it goes (scan8_smem_bytes). It has a
    float32 and a float64 instance (gram and pk in one of them)."""
    if pk.is_cuda:
        return _scan8("gauss_block_scan_v", [_step(gram_t, True)], pk, [])
    return gauss_block_scan_v_plain(_step(gram_t, False), pk)


def bc_block_scan_v(gram_t, pk):
    """V-batched BayesB/C scan (K8): K10's rule with one Gram, whose sum
    both draws the indicator and gives beta. Returns beta, u, delta (V, B);
    shared memory and instances as for gauss_block_scan_v."""
    if pk.is_cuda:
        return _scan8("bc_block_scan_v", [_step(gram_t, True)], pk, _DELTA)
    return bc_block_scan_v_plain(_step(gram_t, False), pk)


def bc_block_scan_wv(gram_t, graw_t, pk):
    """V-batched weighted BayesB/C scan (K10): two Gram streams, the
    weighted gram_t and the raw graw_t, each a (B, V, B) block or a
    step-indexed pair; the raw sum draws the indicator, the weighted one
    gives beta. Returns beta, u, delta (V, B). The kernel's shared memory
    (the skeleton's with two Grams and two groups' rows, scan8_smem_bytes)
    fits whatever B the scans take, in float32 and in float64 (both Grams
    and pk float64)."""
    if pk.is_cuda:
        return _scan8("bc_block_scan_wv", [_step(gram_t, True), _step(graw_t, True)], pk, _DELTA)
    return bc_block_scan_wv_plain(_step(gram_t, False), _step(graw_t, False), pk)


def rc_scan_smem_bytes(B, A, K, sections, itemsize=4):
    """Shared memory one block of K12 (sections = 8) or K14 (6) needs, as
    `csrc/rc_scan.cu` lays it out after the skeleton's: up to A * K = 32 (the
    rule on a warp), two groups' coefficients at 6 elements per lane and
    locus whatever A and K are, and above that the serial rule's scratch
    (A * K + A) and two coefficient rows of 8 + sections * A * K elements.
    itemsize: 4 for the float32 instances, 8 for float64, whose every
    element (the skeleton's too) takes 8 bytes: 61,696 and 123,392 bytes at
    B = 1,024 with the rule on a warp."""
    words = _skeleton_words(B, 1)
    if A * K <= 32:
        words += 2 * 32 * 6 * 32
    else:
        words += A * K + A + 2 * (8 + sections * A * K)
    return itemsize * words


def _rc_launch(name, gram_t, pk, A, K, sections, more_outs):
    """K12 and K14: rows of 8 + sections*A*K elements, which the kernel reads
    from device memory ahead of the locus they belong to, so no chain's rows
    need fit shared memory whatever B is. The float32 instance, or the
    float64 one where the Gram and pk are both float64 (counted as
    `<name>_f64`)."""
    _cuda.require(A >= 1 and K >= 1, f"{name}: needs A >= 1 and K >= 1")
    B = pk.shape[1]
    _cuda.require(rc_scan_smem_bytes(B, A, K, sections, pk.element_size()) <= SMEM_BYTES,
                  f"{name}: B={B}, A={A}, K={K}: two coefficient rows exceed shared memory")
    return _launch(name, [_step(gram_t, True)], pk, 8 + sections * A * K, more_outs, A, K)


def rcpi_block_scan_v(gram_t, pk, n_annot, n_classes):
    """V-batched BayesRCpi scan (K12). gram_t as for r_block_scan_v; pk
    (V, B, 8 + 8AK). Returns beta, u (V, B), delta, acat (V, B) int32 and
    the new annotation probabilities (V, B, A). The kernel reads the Gram
    elements the plain version reads (row j, columns below j), sums them in
    ascending column order, and compares `cum < u * total` where the plain
    version compares `cum / total < u`: results agree to rounding, and a
    draw can differ only where a uniform lies within rounding of a CDF
    edge. A * K <= 32 runs the rule on a warp, above that on one thread.
    It has a float32 and a float64 instance (gram and pk in one of them)."""
    A, K = n_annot, n_classes
    if pk.is_cuda:
        return _rc_launch("rcpi_block_scan_v", gram_t, pk, A, K, 8,
                          [((), torch.int32), ((), torch.int32), ((A,), torch.float32)])
    return rcpi_block_scan_v_plain(_step(gram_t, False), pk, A, K)


def rcplus_block_scan_v(gram_t, pk, n_annot, n_classes):
    """V-batched BayesRCplus scan (K14). gram_t as for r_block_scan_v; pk
    (V, B, 8 + 6AK). Returns beta, u, delta (V, B) and cls, bs, nz
    (V, B, A) (cls, nz int32). Sums, comparisons and instances as in
    rcpi_block_scan_v."""
    A, K = n_annot, n_classes
    if pk.is_cuda:
        return _rc_launch("rcplus_block_scan_v", gram_t, pk, A, K, 6,
                          [((), torch.int32), ((A,), torch.int32), ((A,), torch.float32), ((A,), torch.int32)])
    return rcplus_block_scan_v_plain(_step(gram_t, False), pk, A, K)
