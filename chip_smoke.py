"""Run the PyTorch/CUDA port's marker methods on one NVIDIA GPU and check them.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

Phases (any failed check raises and the script exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), CUDA and nvcc
  2. build the kernels from nextgp_tpu_torch/csrc (one nvcc per source, sm_90a)
  3. each kernel against its plain PyTorch version on the card, at the main
     paths' shapes, with its median time beside the plain version's: K1
     gather, K2 scatter, K3 BayesR scan, K6 Gaussian scan, K8 B/C scan, K10
     weighted B/C scan, and K1 at 100,000 individuals (y past shared memory)
  4. the paths at full size on one simulated 10,000 x 49,152 panel, 2-bit
     packed once and shared, V=96, 100 sweeps of run_lmem each: BayesR with
     estimatePi, BayesC, BayesC with a weighted ("D") residual, and BayesPR
     (one whole-genome region); per-path launch counts, residual drift, pi,
     EBV correlation with the planted signal, steady sweep time and a
     profiled window. Then BayesC, BayesC+D and BayesPR again at V=1, the
     reference-sequential block order: with V=96 every step updates half the
     loci against one residual, which overshoots under these dense priors
     (PERF.md), so BayesC's EBV limit is held at V=1
  5. kernel chain against plain chain on a small model, from identical
     draws, for BayesR, BayesB, BayesC, BayesC+D and BayesPR; two kernel
     runs from one seed must give bit-identical beta
The last three lines are the card line, the kernels JSON and the result JSON.
There is no CPU path: without a CUDA device the script fails.
"""
import json
import statistics
import subprocess
import time

import numpy as np
import torch

import nextgp_tpu_torch as ngt
from nextgp_tpu_torch.engine.rng import HostStream, PhiloxStream
from nextgp_tpu_torch.engine.samplers.markers import _gram_raw_diag
from nextgp_tpu_torch.ops import _cuda, gibbs_kernels, pack2

N, P, BLOCK, V_MAIN = 10_000, 49_152, 256, 96
N_CHAIN, N_BURN, N_THIN = 100, 50, 5
N_BIG, ROWS_BIG = 100_000, 1000  # K1 past its shared-memory stage of y
PRIOR_R = dict(pi=[0.9, 0.05, 0.03, 0.02], class_=[0.0, 1e-4, 1e-3, 1e-2], v=1.0, estimatePi=True)
PI_BC, V_BC, V_PR = 0.95, 0.05, 0.05  # scripts/bench_methods.py:43-58
# path -> (prior, weighted residual, its scan kernel, K1 launches per block-step)
PATHS = {
    "BayesR": (ngt.BayesR(**PRIOR_R), False, "r_block_scan_v", 1),
    "BayesC": (ngt.BayesC(PI_BC, V_BC, estimatePi=True), False, "bc_block_scan_v", 1),
    "BayesC+D": (ngt.BayesC(PI_BC, V_BC, estimatePi=True), True, "bc_block_scan_wv", 2),
    "BayesPR": (ngt.BayesPR(9999, V_PR), False, "gauss_block_scan_v", 1),
}
# (path, V) -> EBV correlation limit; every other run prints its correlation
EBV_LIMITS = {("BayesR", V_MAIN): 0.95, ("BayesC", 1): 0.95}
TOL_PASS = 1e-5  # K1, K2: relative to the output's scale (f32 sums in another order)
TOL_SCAN = 1e-4  # K3, K6, K8, K10: beta and u, relative to their scale; delta exact
CDF_MARGIN = 1e-5  # K3 inputs keep every uniform this far from a CDF edge
BC_MARGIN = 1e-4  # K8/K10 inputs keep every w this far (relative) from its threshold
DEV = torch.device("cuda")


def check(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def median_ms(fn, reps):
    fn()  # warm up
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def rel_err(out, ref):
    return (out - ref).abs().max().item(), ref.abs().max().item()


# ------------------------------------------------------------------ phase 1


def device_phase():
    check(torch.cuda.is_available(), "no CUDA device: the port's main path needs the card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0 and smi.stdout.strip(), f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_cuda._nvcc(), "--version"], capture_output=True, text=True, timeout=60)
    print(f"[1 device] {card} | torch {torch.__version__}, CUDA {torch.version.cuda} | "
          f"{nvcc.stdout.strip().splitlines()[-1]} | cards: {torch.cuda.device_count()}")
    return card


# ------------------------------------------------------------------ phase 2


def build_phase():
    t0 = time.perf_counter()
    so = _cuda.build()
    _cuda.lib()
    print(f"[2 build] {time.perf_counter() - t0:.2f} s -> {so.relative_to(so.parents[3])}")
    for line in (so.parent / "ptxas.log").read_text().splitlines():
        if "Compiling entry" in line or "Used" in line:
            print("  ptxas:", line.strip())


# ------------------------------------------------------------------ data


def simulate():
    """10,000 x 49,152 dosages on the card, 500 expected causal loci with
    N(0, 0.1^2) effects and N(0, 1) noise (as bench.py does); packed once
    with the port's packer. Returns spec_for(path) and the planted signal."""
    g = torch.Generator(device=DEV).manual_seed(0)
    geno = torch.randint(0, 3, (N, P), generator=g, device=DEV, dtype=torch.int8)
    bt = torch.where(torch.rand(P, generator=g, device=DEV) < 500.0 / P,
                     torch.randn(P, generator=g, device=DEV) * 0.1, 0.0)
    sig = geno.float() @ bt
    sig = sig - sig.mean()
    y = (sig + torch.randn(N, generator=g, device=DEV)).double().cpu().numpy()
    center = geno.sum(0, dtype=torch.int64).double() / N
    md = ngt.from_packed(pack2.pack2(geno), N, center)
    del geno
    weights = np.random.default_rng(3).uniform(0.5, 2.0, N)

    def spec_for(path):
        prior, weighted = PATHS[path][:2]
        return ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(N))],
                             markers=[ngt.MarkerTerm("M1", md, prior)],
                             residual=ngt.RandomEffect(weights, 1.0) if weighted else None,
                             block_size=BLOCK)
    return spec_for, sig


# ------------------------------------------------------------------ phase 3


def locus_pre(gram_t, pk_t, u, slot):
    """Each locus's pre (slot 0) or pre_raw (slot 7) in a scan that ended
    with correction vector u: u[i] is final once locus i ran, so locus j
    saw u masked to i < j."""
    B = gram_t.shape[0]
    tri = torch.tril(torch.ones(B, B, dtype=gram_t.dtype, device=DEV), diagonal=-1)
    return pk_t[:, :, slot] + torch.einsum("jvi,vi,ji->vj", gram_t, u, tri)


def cdf_near(gram_t, pk_t, u, K):
    """Loci whose uniform lies within CDF_MARGIN of an inner CDF edge (K3)."""
    pre = locus_pre(gram_t, pk_t, u, 0)
    logl = pk_t[:, :, 8:8 + K] + pk_t[:, :, 8 + K:8 + 2 * K] * (pre * pre)[..., None]
    cum = torch.cumsum(torch.softmax(logl, dim=-1), dim=-1)[..., :K - 1]
    return (cum - pk_t[:, :, 2:3]).abs().min(dim=-1).values < CDF_MARGIN


def bc_near(gram_t, pk_t, u, slot):
    """Loci whose w lies within BC_MARGIN (relative) of the indicator's
    threshold q0 + q1*pre^2 (K8: pre, K10: pre_raw from the raw Gram)."""
    pre = locus_pre(gram_t, pk_t, u, slot)
    quad = pk_t[:, :, 3] * pre * pre
    gap = (pk_t[:, :, 2] + quad - pk_t[:, :, 4]).abs()
    return gap < BC_MARGIN * (1.0 + pk_t[:, :, 2].abs() + quad.abs())


class Step0:
    """Step t = 0 of a marker set, as the sweep drives it: the coefficient
    rows of one step with r0 (and, weighted, r0_raw) from the real data."""

    def __init__(self, st):
        self.ms = st.markers[0]
        self.T, self.V, self.B, q = self.ms.mt.shape
        self.mt_rows = self.ms.mt.view(-1, q)
        self.y = torch.zeros(4 * q, dtype=st.ycorr.dtype, device=DEV)
        self.y[:N] = st.ycorr
        self.dw = None
        if st.e.d_inv is not None:
            self.dw = torch.zeros_like(self.y)
            self.dw[:N] = st.e.d_inv

    def gather(self, yv):
        r0 = pack2.matvec_step(self.mt_rows, 0, pack2.y_planar(yv), self.V * self.B)
        return r0.view(self.V, self.B) - self.ms.center[0] * yv.sum()

    def rows(self, pk, raw=False):
        pk_t = pk.view(self.V, self.T, self.B, -1)[:, 0].clone()
        pk_t[:, :, 0] += self.gather(self.y if self.dw is None else self.dw * self.y)
        if raw:
            pk_t[:, :, 7] += self.gather(self.y)
        return pk_t

    def redraw(self, unif, near, gen):
        """New uniforms for the step-0 loci flagged in near (V, B)."""
        idx = torch.nonzero(near.reshape(-1))[:, 0]  # (v, b) -> global locus v*T*B + b
        glob = (idx // self.B) * self.T * self.B + idx % self.B
        unif[glob] = torch.rand(glob.numel(), generator=gen, dtype=unif.dtype, device=DEV)


def held_scan(name, report, kern, plain, make_rows, unif, gen, step, near, note):
    """Redraw the uniforms of loci near a decision edge until none is, then
    hold the kernel against its plain version: delta exact, u and beta
    within TOL_SCAN of their scale."""
    for _ in range(20):
        pk_t = make_rows(unif)
        ref = plain(pk_t)
        close = near(pk_t, ref[1])
        if not close.any():
            break
        step.redraw(unif, close, gen)
    check(not close.any(), f"{name}: could not keep the inputs away from decision edges")
    got = kern(pk_t)
    check(torch.equal(got[2], ref[2]), f"{name}: delta differs from the plain version")
    e_u, s_u = rel_err(got[1], ref[1])
    check(e_u <= TOL_SCAN * s_u, f"{name}: u differs by {e_u:.3e} (scale {s_u:.3e})")
    e_b, s_b = rel_err(got[0], ref[0])
    report(name, e_b, s_b, TOL_SCAN, median_ms(lambda: kern(pk_t), 20), median_ms(lambda: plain(pk_t), 3),
           f" (beta; u max_abs_err {e_u:.3e} of scale {s_u:.3e}; {note}; delta exact, "
           f"counts {torch.bincount(got[2].reshape(-1)).tolist()})")


def big_gather(report):
    """K1 at 100,000 individuals (q = 25,088): 16*q bytes of y exceed a
    block's shared memory, so the gather reads a transposed copy of y from
    device memory; step t = 1 of 1,000-row steps."""
    g = torch.Generator(device=DEV).manual_seed(4)
    pk = pack2.pack2(torch.randint(0, 3, (N_BIG, 3 * ROWS_BIG), generator=g, device=DEV,
                                   dtype=torch.int8))
    q = pk.shape[1]
    check(q == pack2.packed_q(N_BIG) and 16 * q > pack2.Y_STAGE_BYTES, f"q = {q} at n = {N_BIG}")
    y = torch.zeros(4 * q, device=DEV)
    y[:N_BIG] = torch.randn(N_BIG, generator=g, device=DEV)
    y4 = pack2.y_planar(y)
    sl = pk[ROWS_BIG:2 * ROWS_BIG]
    got = pack2.matvec_step(pk, 1, y4, ROWS_BIG)
    check(torch.equal(got, pack2.matvec_step(pk, 1, y4, ROWS_BIG)), "K1 at 100k: not bit-reproducible")
    e, s = rel_err(got, pack2.matvec_plain(sl, y4))
    report("pack2_matvec_100k", e, s, TOL_PASS,
           median_ms(lambda: pack2.matvec_step(pk, 1, y4, ROWS_BIG), 20),
           median_ms(lambda: pack2.matvec_plain(sl, y4), 5),
           f" ({ROWS_BIG} x {q} step, n = {N_BIG:,}; y {16 * q:,} bytes read from device memory)")


def kernels_phase(spec_for):
    plan, st = ngt.assemble(spec_for("BayesR"), vshards=V_MAIN)
    ms, mp = st.markers[0], plan.markers[0]
    T, V, B, q = ms.mt.shape
    rows, K = V * B, mp.n_classes
    check(V == V_MAIN and q == pack2.packed_q(N), f"layout (T, V, B, q) = {(T, V, B, q)}")
    mt_rows = ms.mt.view(-1, q)
    g = torch.Generator(device=DEV).manual_seed(1)
    dt = st.ycorr.dtype  # float32 on the card
    step = Step0(st)
    y4 = pack2.y_planar(step.y)
    u = torch.randn(rows, generator=g, dtype=dt, device=DEV) * 0.01
    u_all = torch.randn(T * rows, generator=g, dtype=dt, device=DEV) * 0.01
    sl = slice(rows, 2 * rows)  # step t = 1: a real offset into the panel
    out = {}

    def report(name, err, scale, tol, ms_k, ms_p, note=""):
        print(f"[3 kernels] {name}: max_abs_err {err:.3e} (scale {scale:.3e}, tol {tol:g} x scale), "
              f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms{note}")
        check(err <= tol * scale, f"{name} disagrees with its plain version")
        out[name] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p)

    e, s = rel_err(pack2.matvec_step(mt_rows, 1, y4, rows), pack2.matvec_plain(mt_rows[sl], y4))
    report("pack2_matvec", e, s, TOL_PASS,
           median_ms(lambda: pack2.matvec_step(mt_rows, 1, y4, rows), 20),
           median_ms(lambda: pack2.matvec_plain(mt_rows[sl], y4), 5), f" ({rows} x {q} step)")
    e, s = rel_err(pack2.rank_update_step(mt_rows, 1, u), pack2.rank_update_plain(mt_rows[sl], u))
    report("pack2_rank_update", e, s, TOL_PASS,
           median_ms(lambda: pack2.rank_update_step(mt_rows, 1, u), 20),
           median_ms(lambda: pack2.rank_update_plain(mt_rows[sl], u), 5), f" ({rows} x {q} step)")
    e, s = rel_err(pack2.rank_update(mt_rows, u_all), pack2.rank_update_plain(mt_rows, u_all))
    report("pack2_rank_update_panel", e, s, TOL_PASS,
           median_ms(lambda: pack2.rank_update(mt_rows, u_all), 20),
           median_ms(lambda: pack2.rank_update_plain(mt_rows, u_all), 5),
           f" ({T * rows} x {q} whole panel, serving)")
    big_gather(report)

    # the scans at step t=0 with the coefficients of a first sweep on the real data
    gen = torch.Generator(device=DEV).manual_seed(2)
    var_e = st.ycorr.var()
    ive = 1.0 / var_e
    unif = torch.rand(mp.p_pad, generator=gen, dtype=dt, device=DEV)
    z = torch.randn(mp.p_pad, generator=gen, dtype=dt, device=DEV)
    flat = dict(mpm=ms.mpm.reshape(-1), lss=ms.lhs_ss.reshape(-1), rss=ms.rhs_ss.reshape(-1),
                mask=ms.mask.reshape(-1))
    gram0 = ms.gram[0]

    varc = ms.var_beta[0] * ms.v_class
    held_scan(
        "r_block_scan_v", report,
        lambda pk_t: gibbs_kernels.r_block_scan_v((ms.gram, 0), pk_t, K),
        lambda pk_t: gibbs_kernels.r_block_scan_v_plain(gram0, pk_t, K),
        lambda un: step.rows(gibbs_kernels.r_block_pack(ms.beta, z, un, **flat, varc=varc,
                                                        logpi=ms.log_pi, ive=ive, var_e=var_e)),
        unif, gen, step, lambda pk_t, uu: cdf_near(gram0, pk_t, uu, K), f"V={V}, B={B}, K={K}")

    ivb = torch.full_like(ms.beta, 1.0 / V_PR)
    pk_t = step.rows(gibbs_kernels.gauss_block_pack(torch.zeros_like(ms.beta), ms.beta, z, ivb,
                                                    flat["mpm"], flat["lss"], flat["rss"],
                                                    flat["mask"], ive))
    got = gibbs_kernels.gauss_block_scan_v((ms.gram, 0), pk_t)
    ref = gibbs_kernels.gauss_block_scan_v_plain(gram0, pk_t)
    e_u, s_u = rel_err(got[1], ref[1])
    check(e_u <= TOL_SCAN * s_u, f"gauss_block_scan_v: u differs by {e_u:.3e} (scale {s_u:.3e})")
    e_b, s_b = rel_err(got[0], ref[0])
    report("gauss_block_scan_v", e_b, s_b, TOL_SCAN,
           median_ms(lambda: gibbs_kernels.gauss_block_scan_v((ms.gram, 0), pk_t), 20),
           median_ms(lambda: gibbs_kernels.gauss_block_scan_v_plain(gram0, pk_t), 3),
           f" (beta; u max_abs_err {e_u:.3e} of scale {s_u:.3e}; V={V}, B={B})")

    vb = torch.full_like(ms.beta, V_BC)
    lp0, lp1 = np.log(1.0 - PI_BC), np.log(PI_BC)

    def bc_rows(stp, m, un, mpm_raw=None):
        return stp.rows(gibbs_kernels.bc_block_pack(
            m.beta, z, un, vb, 1.0 / vb, m.mpm.reshape(-1), m.lhs_ss.reshape(-1),
            m.rhs_ss.reshape(-1), m.mask.reshape(-1), ive, var_e, lp0, lp1, True,
            mpm_raw=mpm_raw), raw=mpm_raw is not None)

    held_scan(
        "bc_block_scan_v", report,
        lambda pk_t: gibbs_kernels.bc_block_scan_v((ms.gram, 0), pk_t),
        lambda pk_t: gibbs_kernels.bc_block_scan_v_plain(gram0, pk_t),
        lambda un: bc_rows(step, ms, un), unif, gen, step,
        lambda pk_t, uu: bc_near(gram0, pk_t, uu, 0), f"V={V}, B={B}")
    del plan, st, step

    _, st_w = ngt.assemble(spec_for("BayesC+D"), vshards=V_MAIN)
    mw = st_w.markers[0]
    step_w = Step0(st_w)
    raw_diag = _gram_raw_diag(mw)
    held_scan(
        "bc_block_scan_wv", report,
        lambda pk_t: gibbs_kernels.bc_block_scan_wv((mw.gram, 0), (mw.gram_raw, 0), pk_t),
        lambda pk_t: gibbs_kernels.bc_block_scan_wv_plain(mw.gram[0], mw.gram_raw[0], pk_t),
        lambda un: bc_rows(step_w, mw, un, raw_diag), unif, gen, step_w,
        lambda pk_t, uu: bc_near(mw.gram_raw[0], pk_t, uu, 7),
        f"V={V}, B={B}, weighted and raw Gram")
    return out


# ------------------------------------------------------------------ phase 4


def slice_phase(path, spec, sig, card, V):
    """One path through run_lmem at full size, launch counts read from 0."""
    _, _, scan, gathers = PATHS[path]
    ebv_limit = EBV_LIMITS.get((path, V))
    _cuda.reset_launches()
    res = ngt.run_lmem(spec, n_chain=N_CHAIN, n_burn=N_BURN, n_thin=N_THIN, seed=7, vshards=V)
    launches = dict(_cuda.LAUNCHES)
    plan, st = res.plan, res.state
    T = plan.markers[0].n_blocks // plan.markers[0].vshards
    check(plan.markers[0].vshards == V, f"{path}: V = {plan.markers[0].vshards}, asked for {V}")
    path = f"{path} V={V}"
    print(f"[4 {path}] {N} x {P}, V={plan.markers[0].vshards} (T={T} block-steps), "
          f"{N_CHAIN} sweeps: {res.sweeps_per_sec:.2f} sweeps/s on {card}")
    print(f"[4 {path}] launches in run_lmem: {launches}")
    expect = {name: 0 for name in launches}
    expect.update({"pack2_matvec": gathers * N_CHAIN * T, "pack2_rank_update": N_CHAIN * T,
                   scan: N_CHAIN * T})
    check(launches == expect, f"{path}: launches {launches}, expected {expect}")
    beta = st.markers[0].beta
    check(torch.isfinite(beta).all().item() and torch.isfinite(st.ycorr).all().item(),
          f"{path}: non-finite beta or ycorr")
    check(res.draws["betaM1"].shape == ((N_CHAIN - N_BURN) // N_THIN, P), f"{path}: draws shape")
    gv = ngt.genomic_values_state(plan, st)
    drift = ((st.ycorr - (st.y - st.fixed[0].b[0] - gv)).abs().max() / st.y.abs().max()).item()

    def ebv_corr(g):
        ebv = g[:2048] - g[:2048].mean()
        tru = sig[:2048].to(ebv.dtype) - sig[:2048].mean()
        return (torch.dot(ebv, tru) / (ebv.norm() * tru.norm())).item()

    corr_draw = ebv_corr(gv)
    corr = ebv_corr(ngt.genomic_values_state(plan, st, beta=res.posterior_mean("betaM1")))
    pi = st.markers[0].pi_hat
    limit = "printed only" if ebv_limit is None else f"limit {ebv_limit}"
    print(f"[4 {path}] ycorr drift {drift:.3e} of max|y| (limit 1e-2); EBV corr over 2,048 "
          f"individuals {corr:.4f} from the posterior mean of {res.draws['betaM1'].shape[0]} kept "
          f"draws ({limit}), {corr_draw:.4f} from the last draw; varE {st.e.var_e.item():.4f}; "
          f"pi {None if pi is None else pi.tolist()}; var_beta[:4] "
          f"{st.markers[0].var_beta[:4].tolist()}")
    check(drift < 1e-2, f"{path}: ycorr drifted from y - Xb - Mc beta")
    check(ebv_limit is None or corr >= ebv_limit,
          f"{path}: EBV correlation with the planted signal below {ebv_limit}")
    check(pi is None or abs(pi.sum().item() - 1.0) < 1e-5, f"{path}: pi does not sum to 1")
    return launches, res


def timing_window(path, res, n_timed=50, n_sweeps=10):
    """Steady-state sweep time (each sweep timed to the device finishing
    it), then kernel time by name and the device's busy share over a
    profiled window."""
    from torch.profiler import ProfilerActivity, profile

    sweep = ngt.make_sweep(res.plan)
    stream = PhiloxStream(8, DEV, res.plan.dtype)
    st = sweep(res.state, stream)
    torch.cuda.synchronize()
    times = []
    for _ in range(n_timed):
        t0 = time.perf_counter()
        st = sweep(st, stream)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    q = np.percentile(times, [25, 50, 75, 90])
    print(f"[4 {path} timing] {n_timed} sweeps timed one by one: median {q[1]:.4f} ms/sweep "
          f"(quartiles {q[0]:.4f}, {q[2]:.4f}; p90 {q[3]:.4f}), {1e3 / q[1]:.2f} sweeps/s")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_sweeps):
            st = sweep(st, stream)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType

    events = prof.key_averages()
    kernels = sorted(((e.key, e.self_device_time_total / 1e3, e.count) for e in events
                      if e.device_type == DeviceType.CUDA), key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in events
                   if e.device_type == DeviceType.CPU), key=lambda r: -r[1])
    busy = sum(r[1] for r in kernels)
    launched = sum(r[2] for r in kernels)
    print(f"[4 {path} profile] {n_sweeps} sweeps, profiler on: wall {wall_ms:.3f} ms "
          f"({wall_ms / n_sweeps:.4f} ms/sweep), {launched / n_sweeps:.1f} kernels/sweep, "
          f"device busy {busy:.3f} ms ({100 * busy / wall_ms:.1f}%)")
    for key, ms_, cnt in kernels[:10]:
        print(f"  device {ms_ / n_sweeps:9.4f} ms/sweep  x{cnt / n_sweeps:<5.1f} {key[:80]}")
    for key, ms_, cnt in host[:8]:
        print(f"  host   {ms_ / n_sweeps:9.4f} ms/sweep  x{cnt / n_sweeps:<5.1f} {key[:80]}")


# ------------------------------------------------------------------ phase 5


def chain_phase():
    n, p, block, sweeps = 512, 1024, 128, 3
    rng = np.random.default_rng(7)
    g = rng.integers(0, 3, (n, p))
    y = (g - g.mean(0)) @ rng.normal(0, 0.1, p) + rng.normal(0, 1, n)
    weights = rng.uniform(0.5, 2.0, n)
    methods = {"BayesR": (ngt.BayesR(**PRIOR_R), False),
               "BayesB": (ngt.BayesB(PI_BC, V_BC, estimatePi=True), False),
               "BayesC": (ngt.BayesC(PI_BC, V_BC, estimatePi=True), False),
               "BayesC+D": (ngt.BayesC(PI_BC, V_BC, estimatePi=True), True),
               "BayesPR": (ngt.BayesPR(9999, V_PR), False)}

    for name, (prior, weighted) in methods.items():
        spec = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))],
                             markers=[ngt.MarkerTerm("M1", ngt.from_array(g), prior)],
                             residual=ngt.RandomEffect(weights, 1.0) if weighted else None,
                             block_size=block)

        def run(device, V):
            plan, st = ngt.assemble(spec, device=device, dtype=torch.float32, vshards=V)
            sweep, draws = ngt.make_sweep(plan), HostStream(11, device)
            for _ in range(sweeps):
                st = sweep(st, draws)
            return st.markers[0].beta.cpu().numpy(), st.ycorr.cpu().numpy()

        for V in (1, 4):
            bk, yk = run(DEV, V)
            bp, yp = run("cpu", V)
            cb, cy = np.corrcoef(bk, bp)[0, 1], np.corrcoef(yk, yp)[0, 1]
            dy = np.abs(yk - yp).max() / np.abs(yp).max()
            bk2, _ = run(DEV, V)
            print(f"[5 chain] {name} V={V}: corr(beta) {cb:.6f}, corr(ycorr) {cy:.6f}, "
                  f"max|dycorr|/scale {dy:.3e} (limits 0.999, 0.999, 0.05); two kernel runs "
                  f"{'bit-identical' if np.array_equal(bk, bk2) else 'DIFFER'}")
            check(cb > 0.999 and cy > 0.999 and dy < 0.05,
                  f"kernel chain departs from plain chain, {name} V={V}")
            check(np.array_equal(bk, bk2), f"two kernel runs from one seed differ, {name} V={V}")


SOURCES = {  # kernel -> (source, the TPU kernel it replaces)
    "pack2_matvec": ("nextgp_tpu_torch/csrc/pack2.cu", "nextgp_tpu/ops/pack2.py:302"),
    "pack2_rank_update": ("nextgp_tpu_torch/csrc/pack2.cu", "nextgp_tpu/ops/pack2.py:329"),
    "r_block_scan_v": ("nextgp_tpu_torch/csrc/r_scan.cu", "nextgp_tpu/ops/gibbs_kernels.py:518"),
    "gauss_block_scan_v": ("nextgp_tpu_torch/csrc/gauss_bc_scan.cu",
                           "nextgp_tpu/ops/gibbs_kernels.py:389"),
    "bc_block_scan_v": ("nextgp_tpu_torch/csrc/gauss_bc_scan.cu",
                        "nextgp_tpu/ops/gibbs_kernels.py:422"),
    "bc_block_scan_wv": ("nextgp_tpu_torch/csrc/gauss_bc_scan.cu",
                         "nextgp_tpu/ops/gibbs_kernels.py:457"),
}


def main():
    card = device_phase()
    build_phase()
    spec_for, sig = simulate()
    timings = kernels_phase(spec_for)
    launches = {name: 0 for name in SOURCES}  # summed over the V=96 paths
    for path in PATHS:
        counted, res = slice_phase(path, spec_for(path), sig, card, V_MAIN)
        for name in SOURCES:
            launches[name] += counted[name]
        timing_window(path, res)
        del res
    for path in ("BayesC", "BayesC+D", "BayesPR"):
        slice_phase(path, spec_for(path), sig, card, 1)
    chain_phase()
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
                    **timings[name]) for name, (src, rep) in SOURCES.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
