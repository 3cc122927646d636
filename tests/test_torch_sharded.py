"""The port's sharded sweep (parallel/sharded.py) against the JAX package's,
on the CPU in float64.

* A mesh of one rank (no process group) samples the unsharded chain bit for
  bit, for each of the seven marker methods with a plain ("I") and a
  weighted ("D") residual: the counterpart of
  tests/test_sharded.py::test_one_shard_bitwise_equals_engine.
* Two ranks (gloo, this file run as their worker, one spawn for every
  case) on a (1 x 2) mesh sweep BayesPR with regions, BayesC with a weighted
  residual, BayesR, BayesRCpi, BayesRCplus and BayesLV at V = 4 (local V
  2), BayesPR at V = 1 (each rank half of the block-steps), a correlated
  marker set at V = 4 and a CG random term at V = 2, drawing JaxStream's
  numbers: the parent records them site by site while the port's
  single-rank chain at the same V (V = 2 for the V = 1 case: the schedule
  two shards make) draws them, and the ranks, which import no jax, replay
  them, each site at the shape and gamma shapes recorded (a rank that drew
  another site, shape or shape parameter would fail). Their chains are
  held to the JAX make_sharded_sweep on a (1 x 2) virtual CPU mesh and to
  that single-rank chain, at rtol 1e-9 with delta and the annotation
  categories exact; the two ranks hold the same bits of every chain field.
* The refusals: _check_shardable's two messages are the JAX package's,
  make_mesh refuses a mesh that the ranks do not fill, and distribute
  refuses a vshards request that assemble lowered to a V the shards do not
  divide (the JAX package shards such a plan silently).
"""
import contextlib
import dataclasses
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from nextgp_tpu_torch.engine.rng import SplitByLoop

HERE = os.path.dirname(os.path.abspath(__file__))
CHAIN_KEY = 9
N_SWEEPS = 2
# (marker method or "corr" / "cg", weighted, V)
CASES = [("BayesPR", False, 4), ("BayesC", True, 4), ("BayesR", False, 4), ("BayesRCpi", False, 4),
         ("BayesRCplus", False, 4), ("BayesLV-est", False, 4), ("BayesPR", False, 1),
         ("corr", False, 4), ("cg", False, 2)]
CG_TIGHT = 1e-14  # two CG solvers stop on iterates ~1e-7 apart at the default 1e-8


def _case_id(case):
    return f"{case[0]}-{'D' if case[1] else 'I'}-V{case[2]}"


def _specs(case):
    """(JAX spec, port spec) of a case."""
    import nextgp_tpu as ng
    import nextgp_tpu_torch as ngt
    from test_torch_sweep import _specs as marker_specs

    kind = case[0]
    rng = np.random.default_rng(31)
    if kind == "corr":  # test_sharded.py::test_corr_markers_shards_compose_with_vshards's model
        from nextgp_tpu.api.spec import CorrMarkerTerm

        n, p = 48, 32
        g1, g2 = (rng.integers(0, 3, (n, p)).astype(float) for _ in range(2))
        y = 1.0 + (g1 - g1.mean(0)) @ rng.normal(0, 0.15, p) + rng.normal(0, 1, n)
        v = np.array([[0.02, 0.005], [0.005, 0.015]])
        return tuple(mod.ModelSpec(
            y=y, fixed=[mod.FixedTerm("int", np.ones(n))],
            corr_markers=[term(("M1", "M2"), (mod.from_array(g1), mod.from_array(g2)),
                               mod.BayesPR(9999, v))], block_size=4)
            for mod, term in ((ng, CorrMarkerTerm), (ngt, ngt.CorrMarkerTerm)))
    if kind == "cg":  # test_sharded.py::test_sharded_cg_random_effect's model
        n, p = 48, 32
        g = rng.integers(0, 3, (n, p)).astype(float)
        herd = rng.integers(0, 6, n)
        y = 1.0 + (g - g.mean(0)) @ rng.normal(0, 0.2, p) + rng.normal(0, 1, n)
        return tuple(mod.ModelSpec(
            y=y, fixed=[mod.FixedTerm("int", np.ones(n))],
            random=[mod.RandomTerm("herd", None, z_idx=herd, n_levels=6,
                                   prior=mod.Random("I", 0.5, sampler="cg"))],
            markers=[mod.MarkerTerm("M1", mod.from_array(g), mod.BayesPR(9999, 0.05))],
            block_size=8) for mod in (ng, ngt))
    return marker_specs(kind, case[1])


def _tight(plan):
    return dataclasses.replace(plan, random=tuple(
        dataclasses.replace(rp, cg_tol=CG_TIGHT) if rp.sampler == "cg" else rp for rp in plan.random))


class Recorded(SplitByLoop):
    """A stream that replays `draws`, the numbers recorded site by site
    while `source` drew them (with a source, it records). A replayed draw
    must be asked at its recorded site with its recorded shape, and a
    gamma with its recorded shape parameters."""

    def __init__(self, draws, source=None):
        self.draws, self.source = draws, source

    def _at(self, kind, site, draw, alpha=None):
        key = f"{kind} {site.sweep} {site.stage} {site.index} {site.path}"
        if self.source is not None:
            self.draws[key] = draw(self.source).numpy()
            if alpha is not None:
                self.draws[key + " alpha"] = alpha.numpy().copy()
        if alpha is not None:
            np.testing.assert_array_equal(alpha.numpy(), self.draws[key + " alpha"], err_msg=key)
        return torch.from_numpy(self.draws[key])

    def normal(self, site, shape):
        out = self._at("normal", site, lambda s: s.normal(site, shape))
        assert tuple(out.shape) == tuple(shape), site
        return out

    def uniform(self, site, shape):
        out = self._at("uniform", site, lambda s: s.uniform(site, shape))
        assert tuple(out.shape) == tuple(shape), site
        return out

    def gamma(self, site, alpha):
        return self._at("gamma", site, lambda s: s.gamma(site, alpha), alpha)


def _port(spec, case, V, stream, mesh=None):
    """The port's chain of a case after N_SWEEPS sweeps from `stream`, its
    chain fields in global locus order ({"markers.0.beta": array, ...}): on
    `mesh` through the sharded sweep, or on one rank at V."""
    import nextgp_tpu_torch as ngt
    from nextgp_tpu_torch.engine.state import chain_leaves
    from nextgp_tpu_torch.parallel import sharded

    plan, state = ngt.assemble(spec, device="cpu", dtype=torch.float64, vshards=V)
    plan = _tight(plan)
    if mesh is None:
        sweep = ngt.make_sweep(plan)
        for _ in range(N_SWEEPS):
            state = sweep(state, stream)
    else:
        step = sharded.make_sharded_sweep(plan, mesh, N_SWEEPS)
        state = sharded.gather_chain(step(sharded.distribute(plan, state, mesh, 1), stream),
                                     plan, step.ctx)
    return {k.rstrip("."): v.numpy() for k, v in chain_leaves(state).items()}


def _jax(case):
    """The JAX package's chain of a case on a (1 x 2) virtual CPU mesh,
    every field of its state ({"markers.0.beta": array, ...}), its chain
    fields with their leading chains axis."""
    import jax

    import nextgp_tpu as ng
    from nextgp_tpu.parallel import sharded as jsharded
    from test_torch_sweep import _flatten

    plan, state = ng.assemble(_specs(case)[0], use_pallas=False, pack2=True, vshards=case[2])
    plan = _tight(plan)
    mesh = jsharded.make_mesh(1, 2, devices=jax.devices()[:2])
    b = jsharded.distribute(plan, state, mesh, 1)
    out = jsharded.make_sharded_sweep(plan, mesh, n_sweeps=N_SWEEPS)(b)(b, jax.random.key(CHAIN_KEY)[None])
    return _flatten(out)


def _worker(rank, world, port, out_dir):
    """One rank of the two-rank run: every case's port spec and recorded
    draws read from out_dir, its chain on a (1 x 2) mesh; writes its
    gathered chain fields, a file per case. No jax here."""
    import torch.distributed as dist

    from nextgp_tpu_torch.parallel import sharded

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    mesh = sharded.make_mesh(1, world)
    for case in CASES:
        saved = torch.load(os.path.join(out_dir, f"{_case_id(case)}.pt"), weights_only=False)
        np.savez(os.path.join(out_dir, f"{_case_id(case)}.rank{rank}.npz"),
                 **_port(saved["spec"], case, case[2], Recorded(saved["draws"]), mesh))
    dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(worker_file, world, out_dir, timeout):
    """Start `world` gloo ranks running worker_file's _worker (its
    __main__; the ranks import no jax), let the caller work, and return
    wait(): it collects them within `timeout` seconds and asserts each
    exited 0."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE]))
    procs = [subprocess.Popen([sys.executable, worker_file, str(r), str(world), str(port), str(out_dir)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True)
             for r in range(world)]

    def wait():
        try:
            outs = [p.communicate(timeout=timeout)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        for r, (p, text) in enumerate(zip(procs, outs)):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-4000:]}"

    return wait


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both ranks' chains of every case, the port's single-rank chains (which
    record the draws the ranks replay) and the JAX package's (computed here
    while the ranks run)."""
    import jax

    from test_torch_sweep import JaxStream

    out = tmp_path_factory.mktemp("shards")
    ref = {}
    for case in CASES:
        spec, draws = _specs(case)[1], {}
        single = _port(spec, case, max(case[2], 2), Recorded(draws, JaxStream(jax.random.key(CHAIN_KEY))))
        torch.save({"spec": spec, "draws": draws}, out / f"{_case_id(case)}.pt")
        ref[case] = dict(single=single)
    wait = spawn(os.path.abspath(__file__), 2, out, timeout=240)
    for case in CASES:
        ref[case]["jax"] = _jax(case)
    wait()
    for case in CASES:
        ref[case]["ranks"] = [dict(np.load(out / f"{_case_id(case)}.rank{r}.npz")) for r in range(2)]
    return ref


def _exact(key):
    return key.endswith(("delta", "annot_cat"))


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_two_ranks_match_jax_sharded_sweep(runs, case):
    got, want = runs[case]["ranks"][0], runs[case]["jax"]
    assert int(got["sweep_counter"]) == int(want["sweep_index"][0]) == N_SWEEPS
    for key in sorted(set(got) - {"sweep_counter"}):
        if _exact(key):
            np.testing.assert_array_equal(got[key], want[key][0], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key][0], rtol=1e-9, atol=1e-12, err_msg=key)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_two_ranks_match_the_single_rank_chain(runs, case):
    """Two shards of V block chains (of V = 1: of the block-steps) sample the
    single-rank chain at V (at 2)."""
    got, want = runs[case]["ranks"][0], runs[case]["single"]
    assert set(got) == set(want)
    for key in got:
        if _exact(key) or key == "sweep_counter":
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-9, atol=1e-12, err_msg=key)


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_ranks_hold_the_same_bits(runs, case):
    """The residual and the replicated fields are the same bits on both
    ranks of the row, and so are the gathered per-locus ones."""
    a, b = runs[case]["ranks"]
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


@pytest.mark.parametrize("method", ["BayesPR", "BayesB", "BayesC", "BayesR", "BayesRCpi",
                                    "BayesRCplus", "BayesLV"])
@pytest.mark.parametrize("weighted", [False, True], ids=["I", "D"])
def test_one_rank_mesh_is_the_unsharded_sweep(method, weighted):
    """make_sharded_sweep on a (1 x 1) mesh equals make_sweep bit for bit."""
    import nextgp_tpu_torch as ngt
    from nextgp_tpu_torch.engine.state import chain_leaves
    from nextgp_tpu_torch.parallel import sharded
    from test_torch_sweep import _specs as marker_specs

    plan, state = ngt.assemble(marker_specs(method, weighted)[1], device="cpu",
                               dtype=torch.float64, vshards=4)
    mesh = sharded.make_mesh(1, 1)
    local = sharded.distribute(plan, state, mesh, 1)
    assert local is state
    step = sharded.make_sharded_sweep(plan, mesh, n_sweeps=3)
    assert step.ctx.group is None and step.plan is plan
    stream = ngt.PhiloxStream(4, "cpu", torch.float64)
    got = step(local, stream)
    sweep = ngt.make_sweep(plan)
    for _ in range(3):
        state = sweep(state, stream)
    want = chain_leaves(state)
    assert got.sweep_index == state.sweep_index == 3
    for key, t in chain_leaves(got).items():
        assert torch.equal(t, want[key]), key


def _jax_and_port_plans(method="BayesR", V=4, block=16, p=256):
    import nextgp_tpu as ng
    import nextgp_tpu_torch as ngt
    from test_torch_sweep import _data

    g, y = _data(p)
    out = []
    for mod, kw in ((ng, dict(use_pallas=False)), (ngt, dict(device="cpu"))):
        spec = mod.ModelSpec(y=y, fixed=[mod.FixedTerm("int", np.ones(len(y)))],
                             markers=[mod.MarkerTerm("M", mod.from_array(g), mod.BayesC(0.3, 0.05))],
                             block_size=block)
        with pytest.warns(UserWarning, match="largest divisor") if V == 6 else contextlib.nullcontext():
            out.append(mod.assemble(spec, vshards=V, **kw)[0])
    return out


@pytest.mark.parametrize("V,S", [(4, 3), (1, 3)], ids=["vshards", "blocks"])
def test_check_shardable_messages_match(V, S):
    from nextgp_tpu.parallel import sharded as jsharded
    from nextgp_tpu_torch.parallel import sharded

    jplan, tplan = _jax_and_port_plans(V=V)
    with pytest.raises(ValueError) as jerr:
        jsharded._check_shardable(jplan, S)
    with pytest.raises(ValueError) as terr:
        sharded._check_shardable(tplan, S)
    assert str(terr.value) == str(jerr.value)
    assert ("vshards=4 must be a multiple" if V > 1 else "n_blocks=16 is not divisible") in str(
        terr.value)


def test_make_mesh_refuses_what_the_ranks_do_not_fill():
    from nextgp_tpu_torch.parallel import multihost, sharded

    with pytest.raises(ValueError, match=r"chains\*shards = 2 != 1 ranks"):
        sharded.make_mesh(1, 2)
    with pytest.raises(ValueError, match=r"chains\*shards = 4 != 1 ranks"):
        multihost.global_mesh(2, 2)
    with pytest.raises(ValueError, match="not distinct ranks of the world of 1"):
        sharded.make_mesh(1, 1, ranks=[3])
    mesh = multihost.global_mesh()
    assert mesh.shape == {"chains": 1, "shards": 1} and mesh.coords() == (0, 0)
    assert not multihost.init_distributed() or pytest.fail("a single process initialised a world")


def test_distribute_refuses_a_lowered_vshards():
    """vshards=6 on 16 blocks is lowered to V=4 by assemble (as in the JAX
    package, with a warning); three shards do not divide it, and distribute
    names both numbers rather than shard a chain that no one asked for."""
    from nextgp_tpu_torch.parallel import sharded

    _, tplan = _jax_and_port_plans(V=6)
    assert tplan.markers[0].vshards == 4 and tplan.markers[0].vshards_asked == 6
    mesh = sharded.Mesh(np.arange(3).reshape(1, 3), [None])
    with pytest.raises(ValueError, match=r"vshards=6 was asked for, but its n_blocks=16 gave V=4 "
                                         r"\(the largest divisor\), which is not a multiple of "
                                         r"n_shards=3"):
        sharded.distribute(tplan, None, mesh, 1)
    # two shards divide the lowered V: the plan is sharded as it stands
    sharded._check_asked(tplan, 2)


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
