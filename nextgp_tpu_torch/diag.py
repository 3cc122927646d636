"""Observability: trace capture, roofline estimates, run metrics.

Counterpart of `nextgp_tpu/diag.py`. The sweep's stages carry
`torch.profiler.record_function` scopes (engine/sweep.py), so a trace
attributes host and device time to `gibbs.var_e` / `gibbs.fixed.*` /
`gibbs.marker.<set>`, and this module adds:

  * trace(...)        — context manager around torch.profiler.profile
  * roofline(...)     — analytic bytes/flops per sweep vs device peaks
  * SweepMeter        — wall-clock sweeps/s + ETA tracking for run loops

The read bandwidth this card reaches on the sweep's access pattern is
measured by `python -m nextgp_tpu_torch.micro frontier`, which prints it
beside the data sheet's figure; `roofline` divides by the data sheet's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Optional

import torch

from .engine.plan import SweepPlan

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str = "nextgp_trace"):
    """Profile the enclosed block on the host and, where there is a card, on
    the device; yields the profiler (its `key_averages()` are valid once the
    block has ended) and writes a Chrome trace to `log_dir/trace.json` (view
    with chrome://tracing or Perfetto). Stage attribution comes from the
    sweep's scopes."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# device peaks for roofline estimates (per card, dense) — the data sheet's figures
_DEVICE_PEAKS = {
    # name: (bf16 TFLOP/s, f32 TFLOP/s outside the tensor cores, device-memory GB/s)
    "h100": (989.0, 67.0, 3350.0),  # NVIDIA H100 SXM data sheet
    "cpu": (1.0, 0.5, 50.0),
}


@dataclasses.dataclass
class RooflineReport:
    bytes_per_sweep: float
    flops_per_sweep: float
    intensity: float  # flops/byte
    t_bandwidth_s: float  # device-memory-bound lower bound
    t_compute_s: float  # f32-rate lower bound
    bound: str
    sweeps_per_sec_roof: float

    def __str__(self) -> str:
        return (
            f"roofline: {self.bytes_per_sweep / 1e9:.2f} GB + "
            f"{self.flops_per_sweep / 1e12:.3f} TFLOP per sweep "
            f"(AI {self.intensity:.1f}); {self.bound}-bound; "
            f"roof {self.sweeps_per_sec_roof:.1f} sweeps/s"
        )


def cg_work(nnz: int, q: int, dtype, iterations: int):
    """(bytes, operations) of a CG term's solve (CG1) of `iterations`
    iterations over q rows with nnz live entries of K. Bytes: the live
    entries (an int32 index and a value each) and the rows' live lengths,
    read once a solve (CG1 keeps them on chip or streams its own compact
    copy); then each iteration reads diag, p, r and x of a row and writes x,
    r and p. Operations: a multiply and an add a live entry and ~12 a row,
    each iteration."""
    s = torch.finfo(dtype).bits // 8
    return (nnz * (4 + s) + 4 * q + iterations * 7 * s * q,
            iterations * (2 * nnz + 12 * q))


def _random_bytes(rp, n: int, dtype, cg_iterations: Optional[int]) -> float:
    """Bytes one random term's stage reads per sweep. The per-level scan
    reads Z twice (the old u added back, the new u taken out), Z' once and
    the (q, q) structure twice (the level scan, RE1 or RE2, reads all of it;
    the quadratic form u'Ku for the variance); a correlated group's nT
    incidences each as often. A CG term: cg_iterations iterations of its
    solve (cg_work over the live entries of K); its iterations depend on the
    data (`make_sweep`'s `cg_iterations` gives a sweep's, a device tensor),
    so a plan with a CG term needs them given."""
    if rp.sampler == "cg":
        if cg_iterations is None:
            raise ValueError(
                f"roofline: random term {rp.name} is solved by CG, whose iterations depend on the "
                "data; pass cg_iterations (a sweep's, from make_sweep's cg_iterations)")
        return float(cg_work(int(rp.iv_len.sum()), rp.q, dtype, cg_iterations)[0])
    return (torch.finfo(dtype).bits // 8) * (3.0 * rp.n_t * n * rp.q + 2.0 * rp.q * rp.q)


def roofline(plan: SweepPlan, device: str = "h100", n_shards: int = 1,
             cg_iterations: Optional[int] = None) -> RooflineReport:
    """Analytic per-sweep traffic/flops of the blocked marker sweep.

    Per marker set: mt is read twice per sweep (r0 matvec + correction
    rank-B update), the Gram blocks once, plus the in-block scan (p x B
    MACs) — the formula of `nextgp_tpu.diag.roofline`, unchanged; a
    correlated marker set the same per (locus, set) row with nT x nT Gram
    blocks. Per random term (which that formula does not count): the bytes
    its stage reads (`_random_bytes`; a CG term's for cg_iterations
    iterations of its solve, which a plan with a CG term must give: it
    raises ValueError without them).
    """
    if device not in _DEVICE_PEAKS:
        raise ValueError(
            f"unknown device {device!r}; one of {sorted(_DEVICE_PEAKS)}")
    _, f32_tflops, hbm = _DEVICE_PEAKS[device]
    n = plan.n
    bytes_total = 0.0
    flops = 0.0
    for mp in plan.markers:
        p_local = mp.p_pad / max(1, n_shards)
        itemsize = 0.25 if mp.packed else 1  # pack2 / int8
        bytes_total += 2 * p_local * n * itemsize  # two passes over mt
        bytes_total += p_local * mp.block * 4  # Gram blocks (f32)
        flops += 2 * 2 * p_local * n  # matvec + rank-B update MACs
        flops += 2 * p_local * mp.block  # in-block Gram-row dots
    for cp in plan.corr_markers:  # the same per (locus, set) row, and nT x nT Gram blocks
        p_local = cp.p_pad * cp.n_t / max(1, n_shards)
        bytes_total += 2 * p_local * n * 0.25 + p_local * cp.block * cp.n_t * 4
        flops += 2 * 2 * p_local * n + 2 * p_local * cp.block * cp.n_t
    bytes_total += 20 * 4 * n  # ycorr/fixed traffic (minor)
    bytes_total += sum(_random_bytes(rp, n, plan.dtype, cg_iterations) for rp in plan.random)
    t_bw = bytes_total / (hbm * 1e9)
    t_fl = flops / (f32_tflops * 1e12)
    bound = "bandwidth" if t_bw >= t_fl else "compute"
    t = max(t_bw, t_fl)
    return RooflineReport(
        bytes_per_sweep=bytes_total,
        flops_per_sweep=flops,
        intensity=flops / max(bytes_total, 1.0),
        t_bandwidth_s=t_bw,
        t_compute_s=t_fl,
        bound=bound,
        sweeps_per_sec_roof=1.0 / t if t > 0 else float("inf"),
    )


class SweepMeter:
    """Wall-clock throughput tracker (replaces @showprogress, samplers.jl:29)."""

    def __init__(self, total_sweeps: Optional[int] = None):
        self.total = total_sweeps
        self.done = 0
        self.t0 = time.perf_counter()

    def tick(self, n_sweeps: int = 1) -> None:
        self.done += n_sweeps

    @property
    def sweeps_per_sec(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.done / dt if dt > 0 else 0.0

    @property
    def eta_s(self) -> Optional[float]:
        if not self.total or self.done == 0:
            return None
        return (self.total - self.done) / max(self.sweeps_per_sec, 1e-9)

    def status(self) -> str:
        eta = self.eta_s
        tail = f", ETA {eta:.0f}s" if eta is not None else ""
        return f"{self.done} sweeps @ {self.sweeps_per_sec:.1f}/s{tail}"
