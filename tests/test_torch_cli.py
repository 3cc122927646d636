"""The port's command line against the JAX package's, on the CPU.

One config (y ~ 1 + x + PED(ID) + SNP(M) under BayesC with a text genotype
file, a pedigree and a phenotype CSV; "device": "cpu", which the JAX CLI
ignores) is run by the JAX CLI with one chain and with two. On those output
folders the port's `summary`, `diag` and `predict` (training panel and new
individuals, to stdout and to a file) give the JAX commands' output, line
for line. The port's own `run` writes the JAX run's file names with the
same row widths and row counts (the draws differ: another stream), and
`--resume` continues it from its checkpoint to a longer chain. `predict`
on a config whose genotype entry is not a file path returns 2 (the JAX CLI
raises a TypeError there), `roofline` prints the port's report for the
card, and `python -m nextgp_tpu_torch` parses its arguments.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nextgp_tpu import cli as j_cli
from nextgp_tpu_torch import cli as t_cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, P = 40, 24


def _config(tmp_path, out="out", **extra):
    rng = np.random.default_rng(80)
    n_ped = N + 10
    sire = ["0"] * n_ped
    dam = ["0"] * n_ped
    for i in range(10, n_ped):
        s, d = rng.choice(i, 2, replace=False)
        sire[i], dam[i] = f"A{s + 1}", f"A{d + 1}"
    (tmp_path / "ped.txt").write_text("".join(
        f"A{i + 1} {sire[i]} {dam[i]}\n" for i in range(n_ped)))
    g = rng.integers(0, 3, (N, P))
    np.savetxt(tmp_path / "geno.txt", g, fmt="%d")
    np.savetxt(tmp_path / "new.txt", rng.integers(0, 3, (7, P)), fmt="%d")
    x = rng.normal(0, 1, N)
    y = 1.0 + 0.3 * x + (g - g.mean(0)) @ rng.normal(0, 0.2, P) + rng.normal(0, 1, N)
    ids = rng.permutation(np.arange(10, n_ped))[:N]
    (tmp_path / "pheno.csv").write_text("ID,x,y\n" + "".join(
        f"A{ids[i] + 1},{float(x[i])!r},{float(y[i])!r}\n" for i in range(N)))
    cfg = {"formula": "y ~ 1 + x + PED(ID) + SNP(M)", "data": "pheno.csv", "pedigree": "ped.txt",
           "genotypes": {"M": "geno.txt"},
           "priors": {"M": {"type": "BayesC", "pi": 0.2, "v": 0.05, "estimatePi": True},
                      "ID": {"type": "Random", "str": "A", "v": 0.5}},
           "chain": {"length": 12, "burnin": 4, "thin": 2, "seed": 3},
           "block_size": 8, "vshards": 1, "out_folder": out, "device": "cpu", **extra}
    path = tmp_path / f"{out}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


def _chains(cfg_path):
    with open(cfg_path) as fh:
        cfg = json.load(fh)
    cfg["chain"]["chains"] = 2
    cfg["out_folder"] = cfg["out_folder"] + "2"
    path = cfg_path.replace(".json", "2.json")
    with open(path, "w") as fh:
        json.dump(cfg, fh)
    return path


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX CLI's runs: one chain in out/, two in out2/chain{1,2}/."""
    d = tmp_path_factory.mktemp("cli")
    cfg = _config(d)
    assert j_cli.main(["run", cfg, "--quiet"]) == 0
    assert j_cli.main(["run", _chains(cfg), "--quiet"]) == 0
    return d, cfg


def _both(capsys, argv):
    """(port rc, port stdout, JAX rc, JAX stdout) of one command."""
    rt = t_cli.main(argv)
    out_t = capsys.readouterr().out
    rj = j_cli.main(argv)
    out_j = capsys.readouterr().out
    return rt, out_t, rj, out_j


@pytest.mark.parametrize("param", ["betaM", "varE", "piM", "uID", "varUID"])
def test_summary_matches(jax_runs, capsys, param):
    d, _ = jax_runs
    rt, out_t, rj, out_j = _both(capsys, ["summary", param, "--out-folder", str(d / "out")])
    assert rt == rj == 0 and out_t == out_j and out_t.strip()


@pytest.mark.parametrize("param", ["varE", "betaM"])
def test_diag_matches(jax_runs, capsys, param):
    d, _ = jax_runs
    rt, out_t, rj, out_j = _both(capsys, ["diag", param, "--out-folder", str(d / "out2")])
    assert rt == rj and out_t == out_j and "split-Rhat" in out_t
    rt, _, rj, _ = _both(capsys, ["diag", param, "--out-folder", str(d / "out")])
    assert rt == rj == 1  # one chain folder: both refuse


@pytest.mark.parametrize("new", [False, True], ids=["training", "new"])
def test_predict_matches(jax_runs, capsys, new):
    d, cfg = jax_runs
    argv = ["predict", cfg, "--set", "M", "--out-folder", str(d / "out")]
    argv += ["--new", "new.txt"] if new else []
    rt, out_t, rj, out_j = _both(capsys, argv)
    assert rt == rj == 0 and out_t == out_j
    assert len(out_t.split()) == (7 if new else N)
    files = []
    for i, cli in enumerate((t_cli, j_cli)):
        path = d / f"ebv{i}.txt"
        assert cli.main(argv + ["--output", str(path)]) == 0
        files.append(path.read_text())
    assert files[0] == files[1]
    assert t_cli.main(["predict", cfg, "--set", "X"]) == 2  # not in the config: both say 2


def test_predict_without_a_genotype_path_returns_2(tmp_path, capsys):
    """A genotype entry given as a matrix is taken by `run` (parse_formula's
    from_array), but predict reads files: 2 and a message, no TypeError."""
    cfg_path = _config(tmp_path)
    with open(cfg_path) as fh:
        cfg = json.load(fh)
    cfg["genotypes"]["M"] = np.loadtxt(tmp_path / "geno.txt").astype(int).tolist()
    (tmp_path / "matrix.json").write_text(json.dumps(cfg))
    assert t_cli.main(["predict", str(tmp_path / "matrix.json"), "--set", "M"]) == 2
    assert "no file path" in capsys.readouterr().err


def _files(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name)
        if name.endswith("Out"):
            with open(path) as fh:
                rows = [ln.split() for ln in fh.read().splitlines()]
            out[name] = (len(rows), sorted({len(r) for r in rows}))
        elif os.path.isdir(path):
            out[name] = _files(path)
    return out


def test_run_writes_the_jax_files_and_resumes(jax_runs, tmp_path):
    """The port's run (one chain, then two) writes the JAX runs' files with
    their rows; stopped with a checkpoint at 12 sweeps and resumed to 20, it
    has the rows of 20 sweeps."""
    d, _ = jax_runs
    cfg = _config(tmp_path, out="out", chain={"length": 12, "burnin": 4, "thin": 2, "seed": 3,
                                              "checkpoint_every": 1})
    assert t_cli.main(["run", cfg, "--quiet"]) == 0
    assert t_cli.main(["run", _chains(cfg), "--quiet"]) == 0
    assert _files(tmp_path / "out") == _files(d / "out")
    assert _files(tmp_path / "out2") == _files(d / "out2")
    assert os.path.exists(tmp_path / "out" / "chain.ckpt")
    with open(cfg) as fh:
        longer = json.load(fh)
    longer["chain"]["length"] = 20
    with open(cfg, "w") as fh:
        json.dump(longer, fh)
    assert t_cli.main(["run", cfg, "--quiet", "--resume"]) == 0
    rows = {k: v[0] for k, v in _files(tmp_path / "out").items()}
    assert rows["varEOut"] == 1 + (20 - 4) // 2  # the header and 8 kept samples


def test_keyed_stream_config(tmp_path):
    """`run` draws its chain from KeyedStream(seed): its files are those of
    run_lmem on the same spec with that stream, value for value."""
    from nextgp_tpu_torch.engine.rng import KeyedStream
    from nextgp_tpu_torch.runtime import run_lmem

    cfg = _config(tmp_path)
    assert t_cli.main(["run", cfg, "--quiet"]) == 0
    with open(cfg) as fh:
        conf = json.load(fh)
    device = t_cli._device(conf)
    spec = t_cli._spec_from_config(conf, str(tmp_path), device)
    ch = conf["chain"]
    run_lmem(spec, n_chain=ch["length"], n_burn=ch["burnin"], n_thin=ch["thin"],
             out_folder=str(tmp_path / "direct"), seed=ch["seed"], keep_in_memory=False,
             progress=False, vshards=1, device=device,
             stream=KeyedStream(ch["seed"], device, torch.float64))
    names = sorted(n for n in os.listdir(tmp_path / "out") if n.endswith("Out"))
    assert names and names == sorted(n for n in os.listdir(tmp_path / "direct") if n.endswith("Out"))
    for name in names:
        assert (tmp_path / "out" / name).read_text() == (tmp_path / "direct" / name).read_text(), name


def test_roofline(tmp_path, capsys):
    cfg = _config(tmp_path)
    assert t_cli.main(["roofline", cfg]) == 0
    out = capsys.readouterr().out
    assert "roofline" in out
    with pytest.raises(ValueError, match="unknown device"):
        t_cli.main(["roofline", cfg, "--device", "v5e"])


def test_python_m_parses(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-m", "nextgp_tpu_torch", "--help"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0
    assert all(c in res.stdout for c in ("run", "summary", "diag", "predict", "roofline"))
    cfg = _config(tmp_path)
    with open(cfg) as fh:
        no_device = {k: v for k, v in json.load(fh).items() if k != "device"}
    (tmp_path / "card.json").write_text(json.dumps(no_device))
    res = subprocess.run([sys.executable, "-m", "nextgp_tpu_torch", "run", str(tmp_path / "card.json")],
                         cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and "no CUDA device" in res.stderr
    assert not (tmp_path / "out").exists()
