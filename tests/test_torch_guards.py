"""Guards on the port's boundaries.

* `nextgp_tpu_torch` imports neither jax nor `nextgp_tpu` (the machine with
  the card has no jax), checked in a fresh interpreter over every module.
* The host-side classes the port copies keep the JAX originals' dataclass
  field names and defaults, and its state and plan dataclasses the JAX
  field names.
* `chip_smoke.py` has no CPU fallback: without a CUDA device it exits
  non-zero and prints no result.
* Neither has the package: without a CUDA device `default_device()` raises,
  and so does every entry point that is not told `device="cpu"`.
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
    assert n_mods >= 31  # every module of the package was imported, the ladder and diag too
    assert {"nextgp_tpu_torch.micro", "nextgp_tpu_torch.ops.micro", "nextgp_tpu_torch.diag",
            "nextgp_tpu_torch.data.pedigree", "nextgp_tpu_torch.data.grm", "nextgp_tpu_torch.ops.cg",
            "nextgp_tpu_torch.ops.random_scan",
            "nextgp_tpu_torch.engine.samplers.random_effects", "nextgp_tpu_torch.io.writer",
            "nextgp_tpu_torch.io.checkpoint", "nextgp_tpu_torch.io.summary"} <= set(
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


@pytest.mark.parametrize("name", ["BayesPR", "BayesB", "BayesC", "BayesR", "BayesRCpi",
                                  "BayesRCplus", "BayesLV", "SummaryStatistics", "RandomEffect",
                                  "Random", "FixedTerm", "RandomTerm", "MarkerTerm", "CorrMarkerTerm",
                                  "ModelSpec", "MarkerData", "LMEMResult"])
def test_copied_dataclasses_match(name):
    jcls = getattr(j_ingest, name, None) or getattr(ng, name)
    tcls = getattr(t_ingest, name, None) or getattr(ngt, name)
    assert _fields(tcls) == _fields(jcls)


@pytest.mark.parametrize("name", ["RandomState", "SparseRandomState", "CorrRandomState",
                                  "CorrMarkerState", "ModelState", "Pedigree", "RandomPlan",
                                  "CorrMarkerPlan"])
def test_state_fields_match(name):
    """The random effects' and correlated marker sets' state and plan keep
    the JAX field names, so that state_from_numpy reads a flattened JAX
    state at the same paths. The port's ModelState adds sweep_counter (the
    device copy of sweep_index); its RandomPlan adds the CG sampler's static
    tables and its CorrMarkerPlan the region sums' tables."""
    from nextgp_tpu.data import pedigree as j_ped
    from nextgp_tpu.engine import plan as j_plan
    from nextgp_tpu.engine import state as j_state
    from nextgp_tpu_torch.data import pedigree as t_ped
    from nextgp_tpu_torch.engine import plan as t_plan
    from nextgp_tpu_torch.engine import state as t_state

    jmod, tmod = {"Pedigree": (j_ped, t_ped), "RandomPlan": (j_plan, t_plan),
                  "CorrMarkerPlan": (j_plan, t_plan)}.get(name, (j_state, t_state))
    jnames = [f.name for f in dataclasses.fields(getattr(jmod, name))]
    tnames = [f.name for f in dataclasses.fields(getattr(tmod, name))]
    extra = {"ModelState": ["sweep_counter"],
             "RandomPlan": ["z_rows", "sire_kids", "dam_kids", "iv_len", "z_diag", "cg_layout"],
             "CorrMarkerPlan": ["region_rows", "region_len"]}
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


@pytest.mark.parametrize("name", ["run_lmem", "run_chains", "prep", "model_card", "summary_mcmc",
                                  "genomic_values", "predict"])
def test_entry_point_signatures_match(name):
    """A script written for the JAX package calls the port's entry points
    with the same arguments: names, order and defaults equal, the port's
    additions (PORT_ONLY) left out."""
    import inspect

    def params(fn, drop=()):
        return [(p.name, p.kind, p.default) for p in inspect.signature(fn).parameters.values()
                if p.name not in drop]

    assert params(getattr(ngt, name), PORT_ONLY) == params(getattr(ng, name))


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


@pytest.mark.parametrize("entry", ["assemble", "run_lmem", "prep", "run_chains"])
def test_entry_points_do_not_fall_back_to_the_cpu(monkeypatch, tmp_path, entry):
    """Without a CUDA device and without device="cpu" nothing is built on the
    CPU, and the output folder that run_lmem and run_chains wipe is left as
    it was; with device="cpu" the same call goes through."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = _tiny_spec()
    out = tmp_path / "out"
    out.mkdir()
    (out / "kept").write_text("")
    call = {"assemble": lambda **kw: ngt.assemble(spec, **kw)[1].ycorr,
            "prep": lambda **kw: ngt.prep(spec, **kw)[1].ycorr,
            "run_lmem": lambda **kw: ngt.run_lmem(spec, 2, 0, 1, out_folder=str(out), seed=1,
                                                  **kw).state.ycorr,
            "run_chains": lambda **kw: ngt.run_chains(spec, 2, 2, 0, 1, out_folder=str(out),
                                                      **kw)["state"].ycorr}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    assert (out / "kept").exists()
    assert call(device="cpu").device.type == "cpu"


def _card_dtype_spec(kind):
    """An intercept and one more term: a marker set, a random term drawn by
    the per-level scan, one drawn by CG, or none."""
    import numpy as np

    spec = _tiny_spec()
    n = spec.y.shape[0]
    if kind != "markers":
        spec.markers = []
    if kind == "scan":
        spec.random = [ngt.RandomTerm("A", np.eye(n), prior=ngt.Random("A", 0.5))]
    if kind == "cg":
        spec.random = [ngt.RandomTerm("A", None, prior=ngt.Random("A", 0.5, sampler="cg"),
                                      z_idx=np.arange(n), n_levels=n)]
    return spec


@pytest.mark.parametrize("kind", ["markers", "scan", "cg", "fixed"])
def test_float64_on_the_card_is_refused_up_front(kind):
    """float64 on a CUDA device is refused where a float32-only kernel would
    meet it (marker sets, a scan random term), and taken with CG terms and
    fixed effects alone; float32 on the card and float64 on the CPU always."""
    import torch

    from nextgp_tpu_torch.engine.plan import check_card_dtype

    spec, cuda = _card_dtype_spec(kind), torch.device("cuda")
    if kind in ("markers", "scan"):
        with pytest.raises(ValueError, match='float64 on a CUDA device.*float32.*device="cpu"'):
            check_card_dtype(spec, torch.float64, cuda)
        # assemble asks before it places anything: with no card here, a tensor
        # on "cuda" would fail with another error
        with pytest.raises(ValueError, match="float64 on a CUDA device"):
            ngt.assemble(spec, dtype=torch.float64, device="cuda")
    else:
        check_card_dtype(spec, torch.float64, cuda)
    check_card_dtype(spec, torch.float32, cuda)
    check_card_dtype(spec, torch.float64, torch.device("cpu"))


def test_normalize_annot_matches():
    import numpy as np

    from nextgp_tpu.api import priors as j_priors
    from nextgp_tpu_torch.api import priors as t_priors

    annot = np.random.default_rng(0).integers(0, 2, (7, 3)).astype(float)
    out, ref = t_priors.normalize_annot(annot), j_priors.normalize_annot(annot)
    assert out.dtype == ref.dtype and (out == ref).all()
    with pytest.raises(ValueError, match="nSNP, nAnnot"):
        t_priors.normalize_annot(annot[:, 0])
