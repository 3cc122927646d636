"""The measurement ladder: what the panel passes reach on this card.

    python -m nextgp_tpu_torch.micro [load32|matvec|fused|frontier|all]

Counterpart of the JAX repository's `scripts/micro_load32.py`,
`micro_matvec.py`, `micro_fused.py` and `micro_frontier.py`, on the port's
kernels (`ops/micro.py`, `ops/pack2.py`). Each experiment makes its panel on
the device from a seed, checks every kernel it times against the plain
version on an anchor of 512 rows (a full unpack of the large panel would be
30 GB), times each case as whole walks over T steps of the panel (CUDA
events around a walk, median of `--reps` walks after a warm-up) and prints
one JSON line:

  frontier  a read-only pass in several grids (the card's achieved read
            bandwidth for K1's access pattern, beside the data sheet's), K1
            and K2 over T fresh steps, and the two-pass floor of a sweep
  fused     the sequential K2 -> K1 pair against `fused_step` (K1's and
            K2's bodies in one launch), timed in the order pair, fused,
            fused, pair; WIN below 0.95x, LOSS above 1.05x; then the fused
            step at other splits of its blocks between the two roles
  load32    the packed gather with 16-byte (K1), 4-byte and 1-byte loads,
            all three on K1's body: what the width of a load costs
  matvec    dense int8 gather and scatter against the packed K1' and K2' on
            the same dosages

Sizes default to the scripts' (50,000 individuals: q = 12,544; steps of
36,864 loci; T = 16: a 7.4 GB panel). The card's L2 holds 50 MB, so a panel
smaller than four times that is timed on rotating copies that together
exceed it; the line says how many. The ladder runs on the card; `--device
cpu` runs the plain versions (for tests: times then say nothing about a
card). Nothing runs at import.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from .ops import micro as K
from .ops import pack2
from .utils import cdiv

ANCHOR = 512  # rows every kernel is checked on
TOL = 1e-5  # of the output's scale: f32 sums of the same products in another order
L2_BYTES = 50e6  # the H100's L2
DATASHEET_GB_S = 3350.0  # the H100 SXM data sheet's device-memory rate
READ_GRIDS = (1, 2, 4, 8, 16)  # read_step's blocks per SM (its default grid is 4 per SM)


def card_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        raise RuntimeError(f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def walk_ms(walk, device, reps):
    """Times of `reps` walks in ms, after one warm-up walk: CUDA events on
    the card, the host clock on the CPU."""
    walk()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            walk()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            walk()
            times.append((time.perf_counter() - t0) * 1e3)
    return times


def _case(times, launches, panel_bytes):
    """One case's record: a pass is one walk over all of the panel's bytes."""
    ms = statistics.median(times)
    return {"ms_per_pass": ms, "ms_per_launch": ms / launches, "gb_s": panel_bytes / ms / 1e6}


def hold(name, out, ref):
    """Raise unless out matches ref: integers exactly, floats to TOL of
    ref's scale."""
    if not out.dtype.is_floating_point:
        if not torch.equal(out, ref):
            raise RuntimeError(f"{name}: differs from its plain version")
        return
    err, scale = (out - ref).abs().max().item(), ref.abs().max().item()
    if not err <= TOL * scale:
        raise RuntimeError(f"{name}: differs from its plain version by {err:.3e} "
                           f"(scale {scale:.3e}, tolerance {TOL:g} x scale)")


def _same_bits(name, a, b):
    if not torch.equal(a, b):
        raise RuntimeError(f"{name}: two runs on the same inputs differ")


def panel(n_rows, q, device, gen, high=255):
    """Packed bytes uniform in 0..high-1 (scripts/micro_frontier.py:160-161)."""
    return torch.randint(0, high, (n_rows, q), generator=gen, device=device, dtype=torch.uint8)


def copies(x):
    """x and, on the card, as many clones as make the set at least four times
    the L2."""
    n = cdiv(int(4 * L2_BYTES), x.numel() * x.element_size()) if x.is_cuda else 1
    return [x] + [x.clone() for _ in range(n - 1)]


def _header(name, device, **sizes):
    return {"experiment": name, **sizes, "device": str(device), "card": card_line(device)}


def _gen(device, seed):
    return torch.Generator(device=device).manual_seed(seed)


def step_inputs(rows, q, T, device, seed):
    gen = _gen(device, seed)
    return (panel(T * rows, q, device, gen), torch.randn((rows,), generator=gen, device=device),
            torch.randn((4, q), generator=gen, device=device))


# ------------------------------------------------------------------ experiments


def frontier(rows, q, T, device, seed=0, reps=5):
    """scripts/micro_frontier.py: the read-only roof, K1 and K2 over T steps."""
    pk_all, u, y4 = step_inputs(rows, q, T, device, seed)
    a = min(ANCHOR, rows)
    hold("read_step", K.read_step(pk_all, 0, rows)[:a], K.read_step_plain(pk_all, 0, a))
    hold("pack2.matvec_step", pack2.matvec_step(pk_all, 0, y4, rows)[:a],
         pack2.matvec_plain(pk_all[:a], y4))
    dy = pack2.rank_update_step(pk_all, 0, u[:a])
    hold("pack2.rank_update_step", dy, pack2.rank_update_plain(pk_all[:a], u[:a]))
    _same_bits("pack2.rank_update_step", dy, pack2.rank_update_step(pk_all, 0, u[:a]))

    nbytes = T * rows * q
    rec = _header("frontier", device, rows=rows, q=q, T=T, panel_gb=nbytes / 1e9)
    cases = rec["cases"] = {}
    if device.type == "cuda":
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        for per_sm in READ_GRIDS:
            blocks = min(per_sm * sms, cdiv(cdiv(rows, 4), 8))
            cases[f"read blocks={blocks}"] = _case(walk_ms(
                lambda: [K.read_step(pk_all, t, rows, blocks) for t in range(T)], device, reps),
                T, nbytes)
    else:
        cases["read"] = _case(walk_ms(
            lambda: [K.read_step(pk_all, t, rows) for t in range(T)], device, reps), T, nbytes)
    cases["gather K1"] = _case(walk_ms(
        lambda: [pack2.matvec_step(pk_all, t, y4, rows) for t in range(T)], device, reps), T, nbytes)
    cases["scatter K2"] = _case(walk_ms(
        lambda: [pack2.rank_update_step(pk_all, t, u) for t in range(T)], device, reps), T, nbytes)
    best_read = max((c for name, c in cases.items() if name.startswith("read")),
                    key=lambda c: c["gb_s"])
    floor = cases["gather K1"]["ms_per_pass"] + cases["scatter K2"]["ms_per_pass"]
    rec.update(best_gather=cases["gather K1"], best_scatter=cases["scatter K2"],
               two_pass_floor_ms=floor, sweeps_per_s_floor=1e3 / floor,
               read_gb_s=best_read["gb_s"], read_two_pass_floor_ms=2 * best_read["ms_per_pass"],
               datasheet_gb_s=DATASHEET_GB_S)
    return rec


def fused(rows, q, T, device, seed=0, reps=5):
    """scripts/micro_fused.py: scatter(t) then gather(t+1) as two launches
    against one fused launch."""
    pk_all, u, y4 = step_inputs(rows, q, T, device, seed)
    a = min(ANCHOR, rows, T * rows // 2)  # the same kernel on steps of `a` rows
    r0, dy = K.fused_step(pk_all, 0, 1, u[:a], y4)
    ref_r0, ref_dy = K.fused_step_plain(pk_all, 0, 1, u[:a], y4)
    hold("fused_step r0", r0, ref_r0)
    hold("fused_step dy", dy, ref_dy)
    again = K.fused_step(pk_all, 0, 1, u[:a], y4)
    _same_bits("fused_step r0", r0, again[0])
    _same_bits("fused_step dy", dy, again[1])
    # K1's and K2's bodies: their bits on the same steps
    _same_bits("fused_step r0 against K1", r0, pack2.matvec_step(pk_all, 1, y4, a))
    _same_bits("fused_step dy against K2", dy, pack2.rank_update_step(pk_all, 0, u[:a]))

    def pair():
        for t in range(T):
            pack2.rank_update_step(pk_all, t, u)
            pack2.matvec_step(pk_all, (t + 1) % T, y4, rows)

    def one():
        for t in range(T):
            K.fused_step(pk_all, t, (t + 1) % T, u, y4)

    runs = [walk_ms(walk, device, reps) for walk in (pair, one, one, pair)]
    nbytes = 2 * T * rows * q  # both passes over the panel
    seq, fus = _case(runs[0] + runs[3], 2 * T, nbytes), _case(runs[1] + runs[2], T, nbytes)
    ratio = fus["ms_per_pass"] / seq["ms_per_pass"]
    rec = _header("fused", device, rows=rows, q=q, T=T, panel_gb=nbytes / 2e9)
    rec.update(cases={"sequential K2 then K1": seq, "fused": fus},
               order_ms=[statistics.median(r) for r in runs], fused_over_sequential=ratio,
               verdict="WIN" if ratio < 0.95 else "NEUTRAL" if ratio < 1.05 else "LOSS",
               gather_blocks=K.fused_gather_blocks(rows))
    if device.type == "cuda":  # the split between the roles, which moves no bit
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        splits = sorted({sms, 2 * sms, 4 * sms, cdiv(rows, 128), cdiv(rows, 64),
                         K.fused_gather_blocks(rows)})
        rec["splits"] = {g: _case(walk_ms(lambda: [K.fused_step(pk_all, t, (t + 1) % T, u, y4, g)
                                                   for t in range(T)], device, reps), T, nbytes)
                         for g in splits}
    return rec


def load32(rows, q, device, seed=0, reps=5):
    """scripts/micro_load32.py: the packed gather by the width of its loads,
    all three on the same bytes and the same y."""
    gen = _gen(device, seed)
    pk = panel(rows, q, device, gen, high=256)
    y4 = torch.randn((4, q), generator=gen, device=device)
    y16, pk32 = K.y_words(y4, 4), pk.view(torch.int32)
    a = min(ANCHOR, rows)
    ref = pack2.matvec_plain(pk[:a], y4)
    for name, out, plain in (
            ("gather_width 1", K.gather_width(pk, y4), K.gather_width_plain(pk[:a], y4)),
            ("gather_width 4", K.gather_width(pk32, y16), K.gather_width_plain(pk32[:a], y16)),
            ("pack2.matvec", pack2.matvec(pk, y4), ref)):
        hold(name, out[:a], plain)
        hold(f"{name} against the packed gather", out[:a], ref)

    pks = copies(pk)
    rec = _header("load32", device, rows=rows, q=q, panel_gb=rows * q / 1e9, copies=len(pks))
    nbytes = len(pks) * rows * q
    rec["cases"] = {
        name: _case(walk_ms(lambda: [fn(p) for p in pks], device, reps), len(pks), nbytes)
        for name, fn in (("16-byte loads (K1)", lambda p: pack2.matvec(p, y4)),
                         ("4-byte loads", lambda p: K.gather_width(p.view(torch.int32), y16)),
                         ("1-byte loads", lambda p: K.gather_width(p, y4)))}
    return rec


def pack_rows(mt):
    """(L, N) dosages in 0..3 -> (L, N/4) planar-packed bytes, no padding."""
    g4 = mt.view(mt.shape[0], 4, -1).to(torch.uint8)
    return (g4[:, 0] | (g4[:, 1] << 2) | (g4[:, 2] << 4) | (g4[:, 3] << 6)).contiguous()


def matvec(rows, n, device, seed=0, reps=5):
    """scripts/micro_matvec.py: the two contractions on int8 dosages, dense
    and 2-bit packed (K1' and K2' on the packed bytes of the same dosages)."""
    gen = _gen(device, seed)
    mt = torch.randint(0, 3, (rows, n), generator=gen, device=device, dtype=torch.int8)
    y = torch.randn((n,), generator=gen, device=device)
    u = torch.randn((rows,), generator=gen, device=device)
    pk, y4 = pack_rows(mt), pack2.y_planar(y)
    a = min(ANCHOR, rows)
    ref_g, ref_s = K.dense_gather_plain(mt[:a], y), K.dense_scatter_plain(mt[:a], u[:a])
    hold("dense_gather", K.dense_gather(mt, y)[:a], ref_g)
    hold("pack2.matvec against dense", pack2.matvec(pk, y4)[:a], ref_g)
    ds = K.dense_scatter(mt[:a], u[:a])
    hold("dense_scatter", ds, ref_s)
    _same_bits("dense_scatter", ds, K.dense_scatter(mt[:a], u[:a]))
    hold("pack2.rank_update against dense", pack2.rank_update(pk[:a], u[:a]).reshape(-1), ref_s)

    mts, pks = copies(mt), copies(pk)
    rec = _header("matvec", device, L=rows, N=n, dense_gb=rows * n / 1e9,
                  packed_gb=rows * n / 4e9, dense_copies=len(mts), packed_copies=len(pks))
    rec["cases"] = {
        name: _case(walk_ms(lambda: [fn(x) for x in xs], device, reps), len(xs),
                    len(xs) * xs[0].numel())
        for name, fn, xs in (("dense gather", lambda m: K.dense_gather(m, y), mts),
                             ("dense scatter", lambda m: K.dense_scatter(m, u), mts),
                             ("packed gather (K1')", lambda p: pack2.matvec(p, y4), pks),
                             ("packed scatter (K2')", lambda p: pack2.rank_update(p, u), pks))}
    # the same contraction per second, whatever the storage
    for case in rec["cases"].values():
        case["dosage_gb_s"] = rows * n / case["ms_per_launch"] / 1e6
    return rec


EXPERIMENTS = ("load32", "matvec", "fused", "frontier")


def main(argv=None):
    """Run the experiments asked for, print one JSON line each, return them."""
    ap = argparse.ArgumentParser(prog="python -m nextgp_tpu_torch.micro", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("experiment", nargs="?", default="all", choices=EXPERIMENTS + ("all",))
    ap.add_argument("--device", default=None, help="cuda (default; fails without a card) or cpu")
    ap.add_argument("--rows", type=int, default=36864, help="loci per step, fused and frontier")
    ap.add_argument("--q", type=int, default=pack2.packed_q(50000), help="packed bytes per locus")
    ap.add_argument("--T", type=int, default=16, help="steps in the panel")
    ap.add_argument("--load-rows", type=int, default=24576, help="rows of load32's panel")
    ap.add_argument("--load-q", type=int, default=pack2.packed_q(50000))
    ap.add_argument("--L", type=int, default=16384, help="loci of matvec's block-step")
    ap.add_argument("--N", type=int, default=10240, help="individuals of matvec's block-step")
    ap.add_argument("--reps", type=int, default=5, help="timed walks per case")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        raise SystemExit("nextgp_tpu_torch.micro: no CUDA device; the ladder measures the card "
                         "(--device cpu runs the plain versions)")
    device = torch.device(args.device or "cuda")
    runs = {"load32": lambda: load32(args.load_rows, args.load_q, device, args.seed, args.reps),
            "matvec": lambda: matvec(args.L, args.N, device, args.seed, args.reps),
            "fused": lambda: fused(args.rows, args.q, args.T, device, args.seed, args.reps),
            "frontier": lambda: frontier(args.rows, args.q, args.T, device, args.seed, args.reps)}
    records = []
    for name in EXPERIMENTS if args.experiment == "all" else (args.experiment,):
        records.append(runs[name]())
        print(json.dumps(records[-1]), flush=True)
    return records


if __name__ == "__main__":
    main()
