"""Run the PyTorch/CUDA port's BayesR main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py        # from the repository root; one CUDA card, nvcc

Phases (any failed check raises and the script exits non-zero):
  1. device: the card's name and power limit (nvidia-smi), CUDA and nvcc
  2. build the kernels from nextgp_tpu_torch/csrc (nvcc, sm_90a)
  3. each kernel against its plain PyTorch version on the card, at the main
     path's shapes, with its median time beside the plain version's
  4. the slice at full size: 10,000 x 49,152 BayesR with estimatePi, 2-bit
     packed, V=96, 100 sweeps of run_lmem; launch counts, residual drift,
     EBV correlation with the planted signal, and a profiled window
  5. kernel chain against plain chain on a small model, from identical
     draws; two kernel runs from one seed must give bit-identical beta
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
from nextgp_tpu_torch.ops import _cuda, gibbs_kernels, pack2

N, P, BLOCK, V_MAIN = 10_000, 49_152, 256, 96
N_CHAIN, N_BURN, N_THIN = 100, 50, 5
PRIOR = dict(pi=[0.9, 0.05, 0.03, 0.02], class_=[0.0, 1e-4, 1e-3, 1e-2], v=1.0, estimatePi=True)
TOL_PASS = 1e-5  # K1, K2: relative to the output's scale (f32 sums in another order)
TOL_SCAN = 1e-4  # K3: beta and u, relative to their scale; delta exact
CDF_MARGIN = 1e-5  # K3 inputs keep every uniform this far from a CDF edge
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
    N(0, 0.1^2) effects and N(0, 1) noise (as bench.py does); packed with
    the port's packer."""
    g = torch.Generator(device=DEV).manual_seed(0)
    geno = torch.randint(0, 3, (N, P), generator=g, device=DEV, dtype=torch.int8)
    bt = torch.where(torch.rand(P, generator=g, device=DEV) < 500.0 / P,
                     torch.randn(P, generator=g, device=DEV) * 0.1, 0.0)
    sig = geno.float() @ bt
    sig = sig - sig.mean()
    y = sig + torch.randn(N, generator=g, device=DEV)
    center = geno.sum(0, dtype=torch.int64).double() / N
    md = ngt.from_packed(pack2.pack2(geno), N, center)
    spec = ngt.ModelSpec(y=y.double().cpu().numpy(), fixed=[ngt.FixedTerm("int", np.ones(N))],
                         markers=[ngt.MarkerTerm("M1", md, ngt.BayesR(**PRIOR))], block_size=BLOCK)
    return spec, sig


# ------------------------------------------------------------------ phase 3


def cdf_margin(gram_t, pk_t, u, K):
    """Distance of each locus's uniform from its nearest inner CDF edge in a
    scan that ended with correction vector u (u[i] is final once locus i
    ran, so locus j saw u masked to i < j)."""
    B = gram_t.shape[0]
    tri = torch.tril(torch.ones(B, B, dtype=gram_t.dtype, device=DEV), diagonal=-1)
    pre = pk_t[:, :, 0] + torch.einsum("jvi,vi,ji->vj", gram_t, u, tri)
    logl = pk_t[:, :, 8:8 + K] + pk_t[:, :, 8 + K:8 + 2 * K] * (pre * pre)[..., None]
    cum = torch.cumsum(torch.softmax(logl, dim=-1), dim=-1)[..., :K - 1]
    return (cum - pk_t[:, :, 2:3]).abs().min(dim=-1).values


def kernels_phase(spec):
    plan, st = ngt.assemble(spec, vshards=V_MAIN)
    ms, mp = st.markers[0], plan.markers[0]
    T, V, B, q = ms.mt.shape
    rows, K = V * B, mp.n_classes
    check(V == V_MAIN and q == pack2.packed_q(N), f"layout (T, V, B, q) = {(T, V, B, q)}")
    mt_rows = ms.mt.view(-1, q)
    g = torch.Generator(device=DEV).manual_seed(1)
    dt = st.ycorr.dtype  # float32 on the card
    yp = torch.zeros(4 * q, dtype=dt, device=DEV)
    yp[:N] = st.ycorr
    y4 = pack2.y_planar(yp)
    u = torch.randn(rows, generator=g, dtype=dt, device=DEV) * 0.01
    u_all = torch.randn(T * rows, generator=g, dtype=dt, device=DEV) * 0.01
    step = slice(rows, 2 * rows)  # step t = 1: a real offset into the panel
    out = {}

    def report(name, err, scale, tol, ms_k, ms_p, note=""):
        print(f"[3 kernels] {name}: max_abs_err {err:.3e} (scale {scale:.3e}, tol {tol:g} x scale), "
              f"kernel {ms_k:.4f} ms, plain {ms_p:.4f} ms{note}")
        check(err <= tol * scale, f"{name} disagrees with its plain version")
        out[name] = dict(max_abs_err=err, ms=ms_k, plain_ms=ms_p)

    e, s = rel_err(pack2.matvec_step(mt_rows, 1, y4, rows), pack2.matvec_plain(mt_rows[step], y4))
    report("pack2_matvec", e, s, TOL_PASS,
           median_ms(lambda: pack2.matvec_step(mt_rows, 1, y4, rows), 20),
           median_ms(lambda: pack2.matvec_plain(mt_rows[step], y4), 5), f" ({rows} x {q} step)")
    e, s = rel_err(pack2.rank_update_step(mt_rows, 1, u), pack2.rank_update_plain(mt_rows[step], u))
    report("pack2_rank_update", e, s, TOL_PASS,
           median_ms(lambda: pack2.rank_update_step(mt_rows, 1, u), 20),
           median_ms(lambda: pack2.rank_update_plain(mt_rows[step], u), 5), f" ({rows} x {q} step)")
    e, s = rel_err(pack2.rank_update(mt_rows, u_all), pack2.rank_update_plain(mt_rows, u_all))
    report("pack2_rank_update_panel", e, s, TOL_PASS,
           median_ms(lambda: pack2.rank_update(mt_rows, u_all), 20),
           median_ms(lambda: pack2.rank_update_plain(mt_rows, u_all), 5),
           f" ({T * rows} x {q} whole panel, serving)")

    # K3 at step t=0 with the coefficients of a first sweep on the real data
    gen = torch.Generator(device=DEV).manual_seed(2)
    var_e = st.ycorr.var()
    varc = ms.var_beta[0] * ms.v_class
    unif = torch.rand(mp.p_pad, generator=gen, dtype=dt, device=DEV)
    z = torch.randn(mp.p_pad, generator=gen, dtype=dt, device=DEV)
    r0 = pack2.matvec_step(mt_rows, 0, y4, rows).view(V, B) - ms.center[0] * yp.sum()
    for _ in range(20):
        pk = gibbs_kernels.r_block_pack(ms.beta, z, unif, ms.mpm.reshape(-1), ms.lhs_ss.reshape(-1),
                                        ms.rhs_ss.reshape(-1), ms.mask.reshape(-1), varc, ms.log_pi,
                                        1.0 / var_e, var_e)
        pk_t = pk.view(V, T, B, -1)[:, 0].clone()
        pk_t[:, :, 0] += r0
        ref = gibbs_kernels.r_block_scan_v_plain(ms.gram[0], pk_t, K)
        near = cdf_margin(ms.gram[0], pk_t, ref[1], K) < CDF_MARGIN
        if not near.any():
            break
        idx = torch.nonzero(near.reshape(-1))[:, 0]  # (v, b) of step 0 -> global locus v*T*B + b
        glob = (idx // B) * T * B + idx % B
        unif[glob] = torch.rand(glob.numel(), generator=gen, dtype=dt, device=DEV)
    check(not near.any(), "could not keep the scan's uniforms away from CDF edges")
    got = gibbs_kernels.r_block_scan_v((ms.gram, 0), pk_t, K)
    check(torch.equal(got[2], ref[2]), "r_block_scan_v: delta differs from the plain version")
    e_u, s_u = rel_err(got[1], ref[1])
    check(e_u <= TOL_SCAN * s_u, f"r_block_scan_v: u differs by {e_u:.3e} (scale {s_u:.3e})")
    e_b, s_b = rel_err(got[0], ref[0])
    report("r_block_scan_v", e_b, s_b, TOL_SCAN,
           median_ms(lambda: gibbs_kernels.r_block_scan_v((ms.gram, 0), pk_t, K), 20),
           median_ms(lambda: gibbs_kernels.r_block_scan_v_plain(ms.gram[0], pk_t, K), 3),
           f" (beta; u max_abs_err {e_u:.3e} of scale {s_u:.3e}; V={V}, B={B}, K={K}; delta "
           f"exact, classes {torch.bincount(got[2].reshape(-1)).tolist()})")
    return out


# ------------------------------------------------------------------ phase 4


def slice_phase(spec, sig, card):
    _cuda.reset_launches()
    res = ngt.run_lmem(spec, n_chain=N_CHAIN, n_burn=N_BURN, n_thin=N_THIN, seed=7, vshards=V_MAIN)
    launches = dict(_cuda.LAUNCHES)
    plan, st = res.plan, res.state
    T = plan.markers[0].n_blocks // plan.markers[0].vshards
    print(f"[4 slice] {N} x {P} BayesR, V={plan.markers[0].vshards} (T={T} block-steps), "
          f"{N_CHAIN} sweeps: {res.sweeps_per_sec:.2f} sweeps/s on {card}")
    print(f"[4 slice] launches in run_lmem: {launches}")
    for name, n in launches.items():
        check(n == N_CHAIN * T, f"{name} launched {n} times, expected {N_CHAIN * T}")
    beta = st.markers[0].beta
    check(torch.isfinite(beta).all().item() and torch.isfinite(st.ycorr).all().item(),
          "non-finite beta or ycorr")
    check(res.draws["betaM1"].shape == ((N_CHAIN - N_BURN) // N_THIN, P), "draws shape")
    gv = ngt.genomic_values_state(plan, st)
    drift = ((st.ycorr - (st.y - st.fixed[0].b[0] - gv)).abs().max() / st.y.abs().max()).item()

    def ebv_corr(g):
        ebv = g[:2048] - g[:2048].mean()
        tru = sig[:2048].to(ebv.dtype) - sig[:2048].mean()
        return (torch.dot(ebv, tru) / (ebv.norm() * tru.norm())).item()

    corr_draw = ebv_corr(gv)
    corr = ebv_corr(ngt.genomic_values_state(plan, st, beta=res.posterior_mean("betaM1")))
    pi = st.markers[0].pi_hat
    print(f"[4 slice] ycorr drift {drift:.3e} of max|y| (limit 1e-2); EBV corr over 2,048 "
          f"individuals {corr:.4f} from the posterior mean of {res.draws['betaM1'].shape[0]} kept "
          f"draws (limit 0.95), {corr_draw:.4f} from the last draw; varE {st.e.var_e.item():.4f}; "
          f"pi {pi.tolist()}")
    check(drift < 1e-2, "ycorr drifted from y - Xb - Mc beta")
    check(corr >= 0.95, "EBV correlation with the planted signal below 0.95")
    check(abs(pi.sum().item() - 1.0) < 1e-5, "pi does not sum to 1")
    return launches, res


def timing_window(res, n_timed=50, n_sweeps=10):
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
    print(f"[4 timing] {n_timed} sweeps timed one by one: median {q[1]:.4f} ms/sweep "
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
    print(f"[4 profile] {n_sweeps} sweeps, profiler on: wall {wall_ms:.3f} ms "
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
    spec = ngt.ModelSpec(y=y, fixed=[ngt.FixedTerm("int", np.ones(n))],
                         markers=[ngt.MarkerTerm("M1", ngt.from_array(g), ngt.BayesR(**PRIOR))],
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
        print(f"[5 chain] V={V}: corr(beta) {cb:.6f}, corr(ycorr) {cy:.6f}, "
              f"max|dycorr|/scale {dy:.3e} (limits 0.999, 0.999, 0.05)")
        check(cb > 0.999 and cy > 0.999 and dy < 0.05, f"kernel chain departs from plain chain, V={V}")
        bk2, _ = run(DEV, V)
        check(np.array_equal(bk, bk2), f"two kernel runs from one seed differ, V={V}")
        print(f"[5 chain] V={V}: two kernel runs bit-identical")


def main():
    card = device_phase()
    build_phase()
    spec, sig = simulate()
    timings = kernels_phase(spec)
    launches, res = slice_phase(spec, sig, card)
    timing_window(res)
    chain_phase()
    sources = {"pack2_matvec": ("nextgp_tpu_torch/csrc/pack2.cu", "nextgp_tpu/ops/pack2.py:302"),
               "pack2_rank_update": ("nextgp_tpu_torch/csrc/pack2.cu", "nextgp_tpu/ops/pack2.py:329"),
               "r_block_scan_v": ("nextgp_tpu_torch/csrc/r_scan.cu",
                                  "nextgp_tpu/ops/gibbs_kernels.py:518")}
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
                    **timings[name]) for name, (src, rep) in sources.items()]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
