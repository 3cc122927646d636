"""The port's run_chains over a mesh of ranks against the JAX package's over
its devices, on the CPU in float64.

Four gloo ranks (this file run as their worker, one spawn) form a (2 chains
x 2 shards) mesh with multihost.global_mesh and run run_chains on the
intercept + BayesC model of test_torch_run_chains.py, chain c drawing the
numbers of JaxStream(jax.random.split(jax.random.key(seed), 2)[c]), the
JAX package's key of chain c: the parent records them site by site
(test_torch_sharded.Recorded) from the port's single-rank run of the same
schedule (V = 2, the blocks two shards take at V = 1), and the ranks, which
import no jax, replay them. The JAX package runs ng.run_chains(n_chains=2,
n_shards=2) over four of its virtual CPU devices. The draws, R-hat and ESS
agree to 1e-9, and so do the per-chain files (rank 0 writes them) and the
final state's chain fields (gathered in global locus order). Every rank returns
the same draws, R-hat, ESS and state; a second run gives the same bits; the
two chains differ. With the default streams and the default mesh (n_shards
from the world's ranks) a run stopped after a checkpoint and resumed on
every rank leaves the unbroken run's files, draws and state.
"""
import os
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
N_RANKS = 4


def _worker(rank, world, port, out_dir):
    import torch
    import torch.distributed as dist

    import nextgp_tpu_torch as ngt
    from nextgp_tpu_torch.engine.state import chain_leaves
    from nextgp_tpu_torch.parallel import multihost
    from test_torch_sharded import Recorded

    assert multihost.init_distributed(f"127.0.0.1:{port}", world, rank)
    assert dist.get_backend() == "gloo"
    saved = torch.load(os.path.join(out_dir, "model.pt"), weights_only=False)
    mesh = multihost.global_mesh(2, 2)
    assert mesh.coords() == (rank // 2, rank % 2)

    def run(folder=None, streams=True, **kw):
        return ngt.run_chains(saved["spec"], 2, seed=saved["seed"], mesh=mesh if streams else None,
                              device="cpu",
                              out_folder=None if folder is None else os.path.join(out_dir, folder),
                              streams=[Recorded(d) for d in saved["draws"]] if streams else None,
                              **{**saved["kw"], **kw})

    out = {}
    for name, res in (("a", run("a")), ("b", run())):
        for what in ("draws", "rhat", "ess"):
            out.update({f"{name}.{what}.{k}": v for k, v in res[what].items()})
        out.update({f"{name}.state.{k}": v.numpy() for k, v in chain_leaves(res["state"]).items()})
        out[f"{name}.state.sweep_index"] = res["state"].sweep_index.numpy()
    full = run("c", streams=False, checkpoint_every=3)
    run("d", streams=False, checkpoint_every=3, n_chain=20)  # 5 kept; the checkpoint at 3
    res = run("d", streams=False, checkpoint_every=3, resume=True)
    out["full.varE"], out["resumed.varE"] = full["draws"]["varE"], res["draws"]["varE"]
    out["full.ycorr"], out["resumed.ycorr"] = full["state"].ycorr.numpy(), res["state"].ycorr.numpy()
    out["full.rhat"] = full["rhat"]["varE"]
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import torch

    import nextgp_tpu as ng
    import nextgp_tpu_torch as ngt
    from test_torch_run_chains import KW, SEED, _specs
    from test_torch_sharded import Recorded, spawn
    from test_torch_sweep import JaxStream

    root = tmp_path_factory.mktemp("mesh")
    ts, draws = _specs()[1], [{}, {}]
    keys = jax.random.split(jax.random.key(SEED), 2)
    ngt.run_chains(ts, 2, seed=SEED, device="cpu", vshards=2,
                   streams=[Recorded(d, JaxStream(k)) for d, k in zip(draws, keys)], **KW)
    torch.save(dict(spec=ts, draws=draws, seed=SEED, kw=KW), root / "model.pt")
    wait = spawn(os.path.abspath(__file__), N_RANKS, root, timeout=240)
    jout = ng.run_chains(_specs()[0], n_chains=2, seed=SEED, n_shards=2,
                         out_folder=str(root / "jax"), **KW)
    wait()
    ranks = [dict(np.load(root / f"rank{r}.npz")) for r in range(N_RANKS)]
    return dict(jout=jout, ranks=ranks, root=root)


def test_mesh_run_chains_matches_jax(runs):
    got, jout = runs["ranks"][0], runs["jout"]
    for what in ("draws", "rhat", "ess"):
        for name, v in jout[what].items():
            np.testing.assert_allclose(got[f"a.{what}.{name}"], v, rtol=1e-9, atol=1e-12,
                                       err_msg=f"{what} {name}")
    assert got["a.draws.betaM"].shape == (2, 8, 32)


def test_mesh_files_match_jax(runs):
    root = runs["root"]
    for c in (1, 2):
        assert sorted(os.listdir(root / "a" / f"chain{c}")) == ["betaMOut", "varEOut"]
        for name in ("varE", "betaM"):
            path = os.path.join(f"chain{c}", f"{name}Out")
            np.testing.assert_allclose(np.loadtxt(root / "a" / path, skiprows=1),
                                       np.loadtxt(root / "jax" / path, skiprows=1),
                                       rtol=1e-9, atol=1e-12, err_msg=path)


def test_state_is_gathered_in_global_locus_order(runs):
    got, state = runs["ranks"][0], runs["jout"]["state"]
    assert got["a.state.sweep_index"].tolist() == np.asarray(state.sweep_index).tolist() == [29, 29]
    for key, leaf in (("ycorr", state.ycorr), ("markers.0.beta", state.markers[0].beta),
                      ("markers.0.var_beta", state.markers[0].var_beta)):
        np.testing.assert_allclose(got[f"a.state.{key}."], np.asarray(leaf), rtol=1e-9, atol=1e-12,
                                   err_msg=key)
    np.testing.assert_array_equal(got["a.state.markers.0.delta."], np.asarray(state.markers[0].delta))


def test_every_rank_returns_the_same(runs):
    first = runs["ranks"][0]
    for other in runs["ranks"][1:]:
        assert set(other) == set(first)
        for key, v in first.items():
            np.testing.assert_array_equal(other[key], v, err_msg=key)


def test_two_runs_give_the_same_bits_and_the_chains_differ(runs):
    got = runs["ranks"][0]
    for key in [k for k in got if k.startswith("a.")]:
        np.testing.assert_array_equal(got["b" + key[1:]], got[key], err_msg=key)
    assert not np.array_equal(got["a.draws.varE"][0], got["a.draws.varE"][1])
    assert not np.array_equal(got["a.state.ycorr."][0], got["a.state.ycorr."][1])


def test_resume_on_the_default_mesh_is_exact(runs):
    """A run over the default mesh (2 shards: four ranks, two chains) with a
    checkpoint every 3 kept samples, stopped at 5 and resumed, leaves the
    unbroken run's files byte for byte, its last draws and its state."""
    got, root = runs["ranks"][0], runs["root"]
    for c in (1, 2):
        for name in ("varEOut", "betaMOut"):
            assert (root / "c" / f"chain{c}" / name).read_bytes() == \
                (root / "d" / f"chain{c}" / name).read_bytes()
    np.testing.assert_array_equal(got["resumed.varE"], got["full.varE"][:, 3:])
    np.testing.assert_array_equal(got["resumed.ycorr"], got["full.ycorr"])
    assert np.isfinite(got["full.rhat"]).all()


if __name__ == "__main__":
    sys.path.insert(0, HERE)
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
