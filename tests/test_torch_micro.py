"""The measurement ladder's kernels (plain versions, on the CPU) against the
JAX repository's measurement scripts.

Inputs come from a numpy seed at small sizes (512 rows, q = 256, T = 2),
float32 throughout. Tolerance: 1e-5 of the output's scale, for sums of a few
hundred to a thousand float32 products taken in another order; integer
outputs must be exactly equal.

* `scripts/micro_fused.py` and `scripts/micro_frontier.py` are importable,
  and their Pallas kernels run here in interpret mode, unchanged.
* `scripts/micro_load32.py` runs its `main()` at import and
  `scripts/micro_matvec.py` defines its kernels inside functions, so their
  contractions are written out in numpy from the scripts' lines and the
  packed forms are held to `nextgp_tpu.ops.pack2.unpack2`, as the scripts'
  own checks do.
"""
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from nextgp_tpu.ops import pack2 as j_pack2
from nextgp_tpu_torch import micro
from nextgp_tpu_torch.ops import micro as mk
from nextgp_tpu_torch.ops import pack2

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import micro_frontier  # noqa: E402
import micro_fused  # noqa: E402

ROWS, Q, T = 512, 256, 2
TOL = 1e-5


def _close(out, ref):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape
    assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()


def _step_inputs(seed, rows=ROWS, q=Q, steps=T):
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 255, (steps * rows, q), dtype=np.uint8)
    u = rng.normal(0, 1, rows).astype(np.float32)
    y8 = rng.normal(0, 1, (8, q)).astype(np.float32)  # the scripts' y4: rows 0..3 are used
    return pk, u, y8


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("seed,t,t1", [(0, 0, 1), (1, 1, 0), (2, 1, 1)])
def test_fused_step_matches_the_pallas_kernel(seed, t, t1, monkeypatch):
    monkeypatch.setenv("MF_INTERPRET", "1")
    pk, u, y8 = _step_inputs(seed)
    call = micro_fused.make_fused_step(ROWS, Q, 256, 256)
    ref_r0, ref_dy = call(jnp.asarray(pk), t, t1, jnp.asarray(u), jnp.asarray(y8))
    r0, dy = mk.fused_step(_t(pk), t, t1, _t(u), _t(y8[:4]))
    assert r0.dtype == torch.float32 and dy.shape == (4, Q)
    _close(r0, ref_r0)
    _close(dy, np.asarray(ref_dy)[:4])  # rows 4..7 of the TPU output are padding
    assert not np.asarray(ref_dy)[4:].any()
    # and against the unpacked products, as the script's own check
    _close(r0, j_pack2.unpack2(jnp.asarray(pk[t1 * ROWS:(t1 + 1) * ROWS]), jnp.float32)
           @ jnp.asarray(y8[:4].reshape(-1)))
    _close(dy.reshape(-1), jnp.asarray(u)
           @ j_pack2.unpack2(jnp.asarray(pk[t * ROWS:(t + 1) * ROWS]), jnp.float32))


@pytest.mark.parametrize("seed,t", [(0, 0), (1, 1)])
def test_read_step_matches_the_pallas_kernel(seed, t):
    pk, _, _ = _step_inputs(seed)
    with pltpu.force_tpu_interpret_mode():
        ref = micro_frontier.make_dma_step(ROWS, Q, 256, 256)(jnp.asarray(pk), t)
    out = mk.read_step(_t(pk), t, ROWS)
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), np.asarray(ref)[:, 0])


@pytest.mark.parametrize("seed,t", [(0, 0), (1, 1)])
def test_frontier_gather_and_scatter_are_k1_and_k2(seed, t):
    """`make_gather_step` and `make_scatter_step` compute what K1 and K2
    compute: the ladder launches `pack2.matvec_step` / `rank_update_step`."""
    pk, u, y8 = _step_inputs(seed)
    with pltpu.force_tpu_interpret_mode():
        ref_g = micro_frontier.make_gather_step("vpu", ROWS, Q, 256, 256)(
            jnp.asarray(pk), t, jnp.asarray(y8))
        ref_s = micro_frontier.make_scatter_step("vpu", ROWS, Q, 256, 256)(
            jnp.asarray(pk), t, jnp.asarray(u))
    _close(pack2.matvec_step(_t(pk), t, _t(y8[:4]), ROWS), np.asarray(ref_g)[:, 0])
    _close(pack2.rank_update_step(_t(pk), t, _t(u)), np.asarray(ref_s)[:4])


def _k32_numpy(pk32, y16):
    """`_k32` of scripts/micro_load32.py:56-66 in numpy: byte b of the word,
    then field k of the byte, against row 4b + k of y16."""
    acc = np.zeros(pk32.shape, np.float32)
    for b in range(4):
        byte = (pk32 >> (8 * b)) & 0xFF
        for k in range(4):
            acc = acc + ((byte >> (2 * k)) & 3).astype(np.float32) * y16[4 * b + k]
    return acc.sum(axis=1)


def _k8_numpy(pk, y4):
    """`_k8` of scripts/micro_load32.py:38-45."""
    p = pk.astype(np.int32)
    acc = sum(((p >> (2 * k)) & 3).astype(np.float32) * y4[k] for k in range(4))
    return acc.sum(axis=1)


@pytest.mark.parametrize("seed,rows,q", [(0, 512, 256), (1, 37, 64), (2, 3, 25_088)])
def test_gather_width_matches_the_scripts_contractions(seed, rows, q):
    """q = 25,088 is n = 100,000, past the shared memory S1 once staged y in."""
    rng = np.random.default_rng(seed)
    pk = rng.integers(0, 256, (rows, q), dtype=np.uint8)
    pk32 = pk.reshape(rows, q // 4, 4).view("<i4").reshape(rows, q // 4)  # micro_load32.py:112-113
    y4 = rng.normal(0, 1, (4, q)).astype(np.float32)
    y16 = rng.normal(0, 1, (16, q // 4)).astype(np.float32)  # the script's own, unrelated to y4
    _close(mk.gather_width(_t(pk), _t(y4)), _k8_numpy(pk, y4))
    _close(mk.gather_width(_t(pk32), _t(y16)), _k32_numpy(pk32, y16))
    # torch's int32 view of the bytes is the script's little-endian view
    assert np.array_equal(_t(pk).view(torch.int32).numpy(), pk32)
    # with y laid out by y_words both widths are the packed gather (K1')
    unpacked = np.asarray(j_pack2.unpack2(jnp.asarray(pk), jnp.float32) @ jnp.asarray(y4.reshape(-1)))
    _close(mk.gather_width(_t(pk), mk.y_words(_t(y4), 1)), unpacked)
    _close(mk.gather_width(_t(pk32), mk.y_words(_t(y4), 4)), unpacked)
    _close(pack2.matvec(_t(pk), _t(y4)), unpacked)


@pytest.mark.parametrize("seed,rows,n", [(0, 512, 256), (1, 33, 64)])
def test_dense_and_packed_contractions_match_the_script(seed, rows, n):
    """scripts/micro_matvec.py: the dense kernels (`:58-104`) and the packed
    ones, whose bytes hold columns 4j..4j+3 and whose y4 is y.reshape(N/4, 4).T
    (`:137-145`): the same contraction as K1' and K2' take on those bytes."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 3, (rows, n)).astype(np.uint8)
    y = rng.normal(0, 1, n).astype(np.float32)
    u = rng.normal(0, 1, rows).astype(np.float32)
    ref_g, ref_s = g.astype(np.float32) @ y, u @ g.astype(np.float32)
    mt = _t(g.view(np.int8))
    _close(mk.dense_gather(mt, _t(y)), ref_g)
    _close(mk.dense_scatter(mt, _t(u)), ref_s)
    n4 = n // 4
    packed = (g.reshape(rows, n4, 4) << np.array([0, 2, 4, 6], np.uint8)).sum(axis=2).astype(np.uint8)
    y4 = y.reshape(n4, 4).T.copy()
    _close(pack2.matvec(_t(packed), _t(y4)), ref_g)  # pl_r0p, pl_r0p8
    _close(pack2.rank_update(_t(packed), _t(u)).T.reshape(n), ref_s)  # pl_corrp: out.T.reshape(N)
    # the ladder's own packing is the planar one of pack2, unpacked by the JAX package
    pk = micro.pack_rows(mt)
    assert np.array_equal(np.asarray(j_pack2.unpack2(jnp.asarray(pk.numpy()), jnp.int8)), g)
    _close(pack2.matvec(pk, pack2.y_planar(_t(y))), ref_g)
    _close(pack2.rank_update(pk, _t(u)).reshape(-1), ref_s)


def test_signed_dosages_and_hold():
    mt = torch.tensor([[-3, 2, 0, 1] * 4, [1, -1, 1, -1] * 4], dtype=torch.int8)
    y = torch.arange(16, dtype=torch.float32)
    assert torch.equal(mk.dense_gather(mt, y), mt.float() @ y)
    micro.hold("ints", torch.tensor([1, 2]), torch.tensor([1, 2]))
    micro.hold("floats", torch.tensor([1.0, 2.0]), torch.tensor([1.0, 2.00001]))
    with pytest.raises(RuntimeError, match="differs from its plain version"):
        micro.hold("ints", torch.tensor([1, 2]), torch.tensor([1, 3]))
    with pytest.raises(RuntimeError, match="tolerance"):
        micro.hold("floats", torch.tensor([1.0, 2.0]), torch.tensor([1.0, 2.001]))


SMALL = ["--rows", "512", "--q", "256", "--T", "2", "--load-rows", "512", "--load-q", "256",
         "--L", "512", "--N", "256", "--reps", "2"]


def _ladder(*args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT)
    return subprocess.run([sys.executable, "-m", "nextgp_tpu_torch.micro", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_ladder_end_to_end_on_the_cpu():
    res = _ladder("all", "--device", "cpu", *SMALL)
    assert res.returncode == 0, res.stderr
    recs = [json.loads(line) for line in res.stdout.strip().splitlines()]
    assert [r["experiment"] for r in recs] == list(micro.EXPERIMENTS)
    by = {r["experiment"]: r for r in recs}
    for r in recs:
        assert r["device"] == "cpu" and r["card"] == "cpu"
        for case in r["cases"].values():
            assert case["ms_per_pass"] > 0 and case["ms_per_launch"] > 0 and case["gb_s"] > 0
    assert set(by["load32"]["cases"]) == {"16-byte loads (K1)", "4-byte loads", "1-byte loads"}
    assert set(by["matvec"]["cases"]) == {"dense gather", "dense scatter", "packed gather (K1')",
                                          "packed scatter (K2')"}
    f = by["fused"]
    assert f["verdict"] in ("WIN", "NEUTRAL", "LOSS") and len(f["order_ms"]) == 4
    ratio = f["cases"]["fused"]["ms_per_pass"] / f["cases"]["sequential K2 then K1"]["ms_per_pass"]
    assert f["fused_over_sequential"] == pytest.approx(ratio)
    assert f["verdict"] == ("WIN" if ratio < 0.95 else "NEUTRAL" if ratio < 1.05 else "LOSS")
    fr = by["frontier"]
    assert fr["best_gather"] == fr["cases"]["gather K1"]
    assert fr["best_scatter"] == fr["cases"]["scatter K2"]
    floor = fr["best_gather"]["ms_per_pass"] + fr["best_scatter"]["ms_per_pass"]
    assert fr["two_pass_floor_ms"] == pytest.approx(floor)
    assert fr["sweeps_per_s_floor"] == pytest.approx(1e3 / floor)
    assert fr["datasheet_gb_s"] == 3350.0 and fr["read_gb_s"] > 0
    assert (fr["rows"], fr["q"], fr["T"]) == (512, 256, 2)


def test_ladder_needs_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("there is a card: the ladder would run")
    res = _ladder("frontier", *SMALL)
    assert res.returncode != 0 and not res.stdout.strip()
    assert "no CUDA device" in res.stderr


def test_ladder_defaults_are_the_scripts_sizes(monkeypatch, capsys):
    """MF_ROWS / MF_Q / MF_T, ML_R / ML_Q and L / N of the four scripts."""
    for name in micro.EXPERIMENTS:
        monkeypatch.setattr(micro, name, lambda *a, _n=name: {"experiment": _n, "sizes": a[:-3]})
    recs = micro.main(["all", "--device", "cpu"])
    assert {r["experiment"]: tuple(r["sizes"]) for r in recs} == {
        "load32": (24576, 12544), "matvec": (16384, 10240), "fused": (36864, 12544, 16),
        "frontier": (36864, 12544, 16)}
    assert len(capsys.readouterr().out.strip().splitlines()) == 4
    assert pack2.packed_q(50000) == 12544 == j_pack2.packed_q(50000)
