"""Guards on the port's boundaries.

* `nextgp_tpu_torch` imports neither jax nor `nextgp_tpu` (the machine with
  the card has no jax), checked in a fresh interpreter over every module.
* The host-side classes the port copies keep the JAX originals' dataclass
  field names and defaults, and its state and plan dataclasses the JAX
  field names.
* `chip_smoke.py` has no CPU fallback: without a CUDA device it exits
  non-zero and prints no result.
* Neither has the package: without a CUDA device `default_device()` raises,
  and so does every entry point that is not told `device="cpu"`, the
  command line's `run` among them.
* `assemble` refuses float64 on a CUDA device up front where the model has
  marker sets or a scan random term (float32-only kernels).
"""
import dataclasses
import os
import subprocess
import sys

import pytest

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu.data import ingest as j_ingest
from nextgp_tpu_torch.data import ingest as t_ingest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, timeout=120, **extra_env):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, **extra_env)
    args = code_or_args if isinstance(code_or_args, list) else ["-c", code_or_args]
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nextgp_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'nextgp_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nextgp_tpu')]\n"
        "mods = [m for m in sys.modules if m.startswith('nextgp_tpu_torch')]\n"
        "print(len(mods), bad, '|', ' '.join(mods))\n"
        "assert not bad, bad\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    n_mods = int(res.stdout.split()[0])
    assert n_mods >= 34  # every module of the package was imported, the ladder, diag and the CLI too
    assert {"nextgp_tpu_torch.micro", "nextgp_tpu_torch.ops.micro", "nextgp_tpu_torch.diag",
            "nextgp_tpu_torch.data.pedigree", "nextgp_tpu_torch.data.grm", "nextgp_tpu_torch.ops.cg",
            "nextgp_tpu_torch.ops.random_scan",
            "nextgp_tpu_torch.engine.samplers.random_effects", "nextgp_tpu_torch.io.writer",
            "nextgp_tpu_torch.io.checkpoint", "nextgp_tpu_torch.io.summary",
            "nextgp_tpu_torch.data.ingest", "nextgp_tpu_torch.api.formula", "nextgp_tpu_torch.cli",
            "nextgp_tpu_torch.__main__", "nextgp_tpu_torch.grn.sampler",
            "nextgp_tpu_torch.ops.grn_scan", "nextgp_tpu_torch.engine.sharding",
            "nextgp_tpu_torch.parallel.sharded", "nextgp_tpu_torch.parallel.multihost"} <= set(
        res.stdout.split("|")[1].split())


def test_importing_the_ladder_runs_nothing():
    """`nextgp_tpu_torch.micro` is an entry point: importing it (and the
    kernels' module) prints nothing, launches nothing and builds nothing."""
    code = (
        "import nextgp_tpu_torch.micro, nextgp_tpu_torch.diag\n"
        "from nextgp_tpu_torch.ops import _cuda\n"
        "assert not any(_cuda.LAUNCHES.values()) and _cuda._lib is None\n"
        "assert {'gather_width1', 'gather_width4', 'read_step', 'dense_gather', 'dense_scatter',\n"
        "        'fused_step'} <= set(_cuda.LAUNCHES)\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert res.stdout == ""


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        out.append((f.name, default))
    return out


# copied classes that the packages' top levels do not export: their modules
COPIED_MODULES = {"GRNPlan": "grn.sampler", "ShardCtx": "engine.sharding"}
# fields the port renames: ShardCtx's mesh axis is a process group there
RENAMED_FIELDS = {"ShardCtx": {"axis": "group"}}


@pytest.mark.parametrize("name", ["BayesPR", "BayesB", "BayesC", "BayesR", "BayesRCpi",
                                  "BayesRCplus", "BayesLV", "SummaryStatistics", "RandomEffect",
                                  "Random", "FixedTerm", "RandomTerm", "MarkerTerm", "CorrMarkerTerm",
                                  "ModelSpec", "MarkerData", "LMEMResult", "GRNPlan", "ShardCtx"])
def test_copied_dataclasses_match(name):
    import importlib

    if name in COPIED_MODULES:
        jcls = getattr(importlib.import_module(f"nextgp_tpu.{COPIED_MODULES[name]}"), name)
        tcls = getattr(importlib.import_module(f"nextgp_tpu_torch.{COPIED_MODULES[name]}"), name)
    else:
        jcls = getattr(j_ingest, name, None) or getattr(ng, name)
        tcls = getattr(t_ingest, name, None) or getattr(ngt, name)
    renamed = RENAMED_FIELDS.get(name, {})
    assert _fields(tcls) == [(renamed.get(f, f), d) for f, d in _fields(jcls)]


@pytest.mark.parametrize("name", ["RandomState", "SparseRandomState", "CorrRandomState",
                                  "CorrMarkerState", "ModelState", "Pedigree", "RandomPlan",
                                  "CorrMarkerPlan", "GRNState"])
def test_state_fields_match(name):
    """The random effects' and correlated marker sets' state and plan keep
    the JAX field names, so that state_from_numpy reads a flattened JAX
    state at the same paths. The port's ModelState adds sweep_counter (the
    device copy of sweep_index); its RandomPlan adds the CG sampler's static
    tables and its CorrMarkerPlan the bytes of a stored dosage (the JAX
    roofline counts 0.25 for every correlated set), the region sums'
    tables and the vshards asked for (a sharded run refuses one that
    assemble lowered to a V the shards do not divide). The port's GRNState adds it_counter (the device copy of it, which
    the port keeps on the host)."""
    from nextgp_tpu.data import pedigree as j_ped
    from nextgp_tpu.grn import sampler as j_grn
    from nextgp_tpu.engine import plan as j_plan
    from nextgp_tpu.engine import state as j_state
    from nextgp_tpu_torch.data import pedigree as t_ped
    from nextgp_tpu_torch.engine import plan as t_plan
    from nextgp_tpu_torch.engine import state as t_state
    from nextgp_tpu_torch.grn import sampler as t_grn

    jmod, tmod = {"Pedigree": (j_ped, t_ped), "RandomPlan": (j_plan, t_plan),
                  "CorrMarkerPlan": (j_plan, t_plan), "GRNState": (j_grn, t_grn)}.get(name, (j_state, t_state))
    jnames = [f.name for f in dataclasses.fields(getattr(jmod, name))]
    tnames = [f.name for f in dataclasses.fields(getattr(tmod, name))]
    extra = {"ModelState": ["sweep_counter"], "GRNState": ["it_counter"],
             "RandomPlan": ["z_rows", "sire_kids", "dam_kids", "iv_len", "z_diag", "cg_layout"],
             "CorrMarkerPlan": ["dosage_bytes", "region_rows", "region_len", "vshards_asked"]}
    assert tnames == jnames + extra.get(name, [])
    if name in ("RandomPlan", "CorrMarkerPlan"):
        jf = _fields(getattr(jmod, name))
        assert _fields(getattr(tmod, name))[:len(jf)] == jf


def test_chain_fields_match():
    """The port's _CHAIN_FIELDS (the fields a sweep replaces: run_chains
    batches them, a checkpoint holds them) name the JAX package's classes
    and fields; the port's ModelState adds sweep_counter."""
    from nextgp_tpu.parallel import sharded
    from nextgp_tpu_torch.engine import state as t_state

    jax_fields = {cls.__name__: fields for cls, fields in sharded._CHAIN_FIELDS.items()}
    jax_fields["ModelState"] += ("sweep_counter",)
    assert {cls.__name__: fields for cls, fields in t_state._CHAIN_FIELDS.items()} == jax_fields


# parameters the port adds to an entry point: where it runs, and its draw streams
PORT_ONLY = ("device", "stream", "streams")
# parameters of the JAX package's that the port leaves out: `assemble`'s
# use_pallas (its Pallas switch has no meaning on the card)
JAX_ONLY = ("use_pallas",)
# parameters the port renames: make_mesh lays out ranks, not devices
RENAMED_PARAMS = {"devices": "ranks"}
# the entry points that the packages' top levels do not export: their modules
MODULES = {"build_lv_design": "api.formula", "from_device_array": "data.ingest",
           "read_map_file": "data.ingest", "make_mesh": "parallel.sharded",
           "distribute": "parallel.sharded", "make_sharded_sweep": "parallel.sharded",
           "global_mesh": "parallel.multihost", "init_distributed": "parallel.multihost",
           "chain_checksum": "parallel.multihost"}


@pytest.mark.parametrize("name", ["run_lmem", "run_chains", "prep", "model_card", "summary_mcmc",
                                  "genomic_values", "predict", "assemble", "parse_formula",
                                  "build_lv_design", "from_array", "from_float_array",
                                  "from_device_array", "from_packed", "read_genotype_file",
                                  "read_plink", "read_map_file", "est_grn", "make_mesh",
                                  "global_mesh", "init_distributed", "distribute",
                                  "make_sharded_sweep", "chain_checksum"])
def test_entry_point_signatures_match(name):
    """A script written for the JAX package calls the port's entry points
    with the same arguments: names, order and defaults equal, the port's
    additions (PORT_ONLY) left out, `assemble`'s use_pallas (JAX_ONLY)
    dropped from the JAX side, and make_mesh's devices named ranks
    (RENAMED_PARAMS). make_sharded_sweep's step takes a stream where the
    JAX function's takes the chains' keys."""
    import importlib
    import inspect

    def params(fn, drop=()):
        return [(RENAMED_PARAMS.get(p.name, p.name), p.kind, p.default)
                for p in inspect.signature(fn).parameters.values() if p.name not in drop]

    if name in MODULES:
        jfn = getattr(importlib.import_module(f"nextgp_tpu.{MODULES[name]}"), name)
        tfn = getattr(importlib.import_module(f"nextgp_tpu_torch.{MODULES[name]}"), name)
    else:
        jfn, tfn = getattr(ng, name), getattr(ngt, name)
    assert params(tfn, PORT_ONLY) == params(jfn, JAX_ONLY)


@pytest.mark.parametrize("model", ["BayesRCpi-D-V4", "corr-V2"])
def test_chain_checksum_matches(model):
    """chain_checksum of a JAX state carried across (state_from_numpy)
    equals the JAX function's: the same leaves in the same order, the
    port's sweep_counter left out (the storage's other layout sums the
    same values in another order)."""
    from nextgp_tpu.parallel import multihost as j_multihost
    from nextgp_tpu_torch.parallel import multihost as t_multihost
    from test_torch_corr import _marker_specs
    from test_torch_sweep import _flatten
    from test_torch_sweep import _specs as marker_specs

    js, ts = marker_specs("BayesRCpi", True) if model.startswith("BayesRCpi") else _marker_specs(2)
    V = int(model[-1])
    jplan, jstate = ng.assemble(js, use_pallas=False, vshards=V)
    tplan, _ = ngt.assemble(ts, device="cpu", vshards=V)
    tstate = ngt.state_from_numpy(tplan, _flatten(jstate))
    want = j_multihost.chain_checksum(jstate)
    assert want > 0
    assert abs(t_multihost.chain_checksum(tstate) - want) <= 1e-12 * want


def test_chip_smoke_fails_without_gpu():
    res = _run(["chip_smoke.py"], timeout=300, CUDA_VISIBLE_DEVICES="")  # no card, wherever it runs
    assert res.returncode != 0
    last = (res.stdout.strip().splitlines() or [""])[-1]
    assert '"ok": true' not in last


def _tiny_spec():
    import numpy as np

    rng = np.random.default_rng(0)
    g = rng.integers(0, 3, (20, 16))
    return ngt.ModelSpec(y=rng.normal(size=20), fixed=[ngt.FixedTerm("int", np.ones(20))],
                         markers=[ngt.MarkerTerm("M", ngt.from_array(g), ngt.BayesC(0.9, 0.05))],
                         block_size=8)


def test_default_device_is_the_card_or_an_error(monkeypatch):
    import torch

    from nextgp_tpu_torch import utils

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='no CUDA device.*device="cpu"'):
        utils.default_device()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert utils.default_device() == torch.device("cuda")


def _cli_config(tmp_path, out, **extra):
    """A CLI config over _tiny_spec's data written to tmp_path: a phenotype
    CSV, a genotype file, y ~ 1 + SNP(M) under BayesC."""
    import json

    import numpy as np

    spec = _tiny_spec()
    g = spec.markers[0].data.genotypes
    (tmp_path / "geno.txt").write_text("\n".join(" ".join(map(str, r)) for r in g) + "\n")
    (tmp_path / "pheno.csv").write_text(
        "ID,y\n" + "\n".join(f"a{i},{float(v)!r}" for i, v in enumerate(np.asarray(spec.y))) + "\n")
    cfg = {"formula": "y ~ 1 + SNP(M)", "data": "pheno.csv", "genotypes": {"M": "geno.txt"},
           "priors": {"M": {"type": "BayesC", "pi": 0.9, "v": 0.05}}, "block_size": 8,
           "chain": {"length": 2, "burnin": 0, "thin": 1, "seed": 1}, "out_folder": str(out),
           **extra}
    path = tmp_path / "run.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("entry", ["assemble", "run_lmem", "prep", "run_chains", "cli_run", "est_grn"])
def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch, tmp_path, entry):
    """Without a CUDA device and without device="cpu" nothing is built on the
    CPU, and the output folder that run_lmem, run_chains and the CLI's run
    wipe is left as it was; with device="cpu" (the CLI: the config's
    "device": "cpu") the same call goes through."""
    import torch

    from nextgp_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _tiny_spec()
    out = tmp_path / "out"
    out.mkdir()
    (out / "kept").write_text("")
    if entry == "cli_run":
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["run", _cli_config(tmp_path, out), "--quiet"])
        assert (out / "kept").exists()
        assert cli.main(["run", _cli_config(tmp_path, out, device="cpu"), "--quiet"]) == 0
        assert not (out / "kept").exists() and (out / "varEOut").exists()
        return
    import numpy as np

    rng = np.random.default_rng(1)
    x, y = rng.integers(0, 3, (6, 30)).astype(float), rng.normal(size=(2, 30))
    call = {"est_grn": lambda **kw: ngt.est_grn(x, y, 2, 3, 2, 0, 1, out_folder=str(out), **kw)[2].ycorr,
            "assemble": lambda **kw: ngt.assemble(spec, **kw)[1].ycorr,
            "prep": lambda **kw: ngt.prep(spec, **kw)[1].ycorr,
            "run_lmem": lambda **kw: ngt.run_lmem(spec, 2, 0, 1, out_folder=str(out), seed=1,
                                                  **kw).state.ycorr,
            "run_chains": lambda **kw: ngt.run_chains(spec, 2, 2, 0, 1, out_folder=str(out),
                                                      **kw)["state"].ycorr}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert (out / "kept").exists()
    assert call(device="cpu").device.type == "cpu"


# every kind of term, BayesRCpi, BayesRCplus and correlated marker sets
# among them: each kernel has a float64 instance
CARD_DTYPE_CASES = (
    "BayesRCpi", "BayesRCplus", "corr_markers", "scan", "corr_random", "BayesR+scan",
    "markers", "BayesB", "BayesC+D", "BayesPR", "BayesLV", "BayesR", "BayesR+D", "BayesR_float", "cg", "fixed",
)


def _card_dtype_spec(kind):
    """An intercept and one more term: a marker set of one method ("markers"
    is BayesC; "BayesR_float" on float rows, the others on 0..2 dosages,
    packed or int8 as assemble's pack2 says), a correlated pair of marker
    sets, a random term drawn by the per-level scan, a correlated group, one
    drawn by CG, or none; "+D" with a weighted residual."""
    import numpy as np

    spec = _tiny_spec()
    n, p = spec.y.shape[0], 16
    rng = np.random.default_rng(1)
    g = rng.integers(0, 3, (n, p))
    annot = rng.integers(0, 2, (p, 2)) | np.array([1, 0])
    method = kind.split("+")[0].removesuffix("_float")
    priors = {"BayesB": ngt.BayesB(0.9, 0.05), "BayesC": ngt.BayesC(0.9, 0.05),
              "BayesPR": ngt.BayesPR(9999, 0.05), "BayesLV": ngt.BayesLV(0.01, rng.normal(size=(p, 2)), 0.01),
              "BayesRCpi": ngt.BayesRCpi([0.9, 0.1], [0.0, 0.01], 1.0, annot),
              "BayesRCplus": ngt.BayesRCplus([0.9, 0.1], [0.0, 0.01], 1.0, annot),
              "BayesR": ngt.BayesR([0.9, 0.05, 0.05], [0.0, 1e-3, 1e-2], 1.0, estimatePi=True)}
    if method in priors:
        data = ngt.from_float_array(g + 0.5) if kind.endswith("_float") else ngt.from_array(g)
        spec.markers = [ngt.MarkerTerm("M", data, priors[method])]
    elif kind != "markers":
        spec.markers = []
    if kind.endswith("+D"):
        spec.residual = ngt.RandomEffect(rng.uniform(0.5, 2.0, n), 1.0)
    if kind == "corr_markers":
        spec.corr_markers = [ngt.CorrMarkerTerm(("M1", "M2"), (ngt.from_array(g), ngt.from_array(g)),
                                                ngt.BayesPR(9999, 0.01 * np.eye(2)))]
    if kind.endswith("scan"):
        spec.random = [ngt.RandomTerm("A", np.eye(n), prior=ngt.Random("A", 0.5))]
    if kind == "corr_random":
        spec.random = [ngt.RandomTerm(("a", "b"), (np.eye(n), np.eye(n)),
                                      prior=ngt.Random("I", 0.1 * np.eye(2)))]
    if kind == "cg":
        spec.random = [ngt.RandomTerm("A", None, prior=ngt.Random("A", 0.5, sampler="cg"),
                                      z_idx=np.arange(n), n_levels=n)]
    return spec


@pytest.mark.parametrize("kind", CARD_DTYPE_CASES)
def test_float64_on_the_card_meets_no_dtype_refusal(kind):
    """float64 with device="cuda" is taken for every kind of term: BayesRCpi
    and BayesRCplus marker sets (K12, K14), correlated marker sets (CM1,
    CM1r), BayesR, BayesB, BayesC (weighted residual or not), BayesPR and
    BayesLV marker sets on any storage, random terms drawn by the per-level
    scan alone or beside BayesR or by CG, correlated random groups and fixed
    effects alone. Without a card assemble fails only for want of the card
    (no ValueError); with one it assembles the model in float64 there. The
    same spec assembles in float64 on the CPU."""
    import torch

    spec = _card_dtype_spec(kind)
    spec.validate()
    if torch.cuda.is_available():
        _, st = ngt.assemble(spec, dtype=torch.float64, device="cuda")
        assert st.ycorr.dtype == torch.float64 and st.ycorr.is_cuda
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            ngt.assemble(spec, dtype=torch.float64, device="cuda")
    _, st = ngt.assemble(spec, dtype=torch.float64, device="cpu")
    assert st.ycorr.dtype == torch.float64


def test_float64_without_a_card_leaves_the_output_folder(monkeypatch, tmp_path):
    """A float64 BayesRCpi run_lmem without a CUDA device and without
    device="cpu" raises for want of the card before it touches out_folder;
    with device="cpu" the same call runs in float64 and writes there."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _card_dtype_spec("BayesRCpi")
    out = tmp_path / "out"
    out.mkdir()
    (out / "kept").write_text("x")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ngt.run_lmem(spec, 2, 0, 1, out_folder=str(out), dtype=torch.float64)
    assert (out / "kept").exists()
    res = ngt.run_lmem(spec, 2, 0, 1, out_folder=str(out), device="cpu", dtype=torch.float64)
    assert res.state.ycorr.dtype == torch.float64
    assert not (out / "kept").exists() and (out / "varEOut").exists()


def test_normalize_annot_matches():
    import numpy as np

    from nextgp_tpu.api import priors as j_priors
    from nextgp_tpu_torch.api import priors as t_priors

    annot = np.random.default_rng(0).integers(0, 2, (7, 3)).astype(float)
    out, ref = t_priors.normalize_annot(annot), j_priors.normalize_annot(annot)
    assert out.dtype == ref.dtype and (out == ref).all()
    with pytest.raises(ValueError, match="nSNP, nAnnot"):
        t_priors.normalize_annot(annot[:, 0])


def test_grn_stage_number_matches():
    """The GRN sampler's draws are keyed at the JAX package's stage."""
    from nextgp_tpu.engine import rng as j_rng
    from nextgp_tpu_torch.engine import rng as t_rng

    assert t_rng.STAGE_GRN == j_rng.STAGE_GRN == 9
