"""Guards on the port's boundaries.

* `nextgp_tpu_torch` imports neither jax nor `nextgp_tpu` (the machine with
  the card has no jax), checked in a fresh interpreter over every module.
* The host-side classes the port copies keep the JAX originals' dataclass
  field names and defaults.
* `chip_smoke.py` has no CPU fallback: without a CUDA device it exits
  non-zero and prints no result.
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
        "print(len([m for m in sys.modules if m.startswith('nextgp_tpu_torch')]), bad)\n"
        "assert not bad, bad\n"
    )
    res = _run(code)
    assert res.returncode == 0, res.stderr
    n_mods = int(res.stdout.split()[0])
    assert n_mods >= 15  # every module of the package was imported


def _fields(cls):
    out = []
    for f in dataclasses.fields(cls):
        default = f.default_factory() if f.default_factory is not dataclasses.MISSING else f.default
        out.append((f.name, default))
    return out


@pytest.mark.parametrize("name", ["BayesR", "RandomEffect", "FixedTerm", "MarkerTerm", "ModelSpec",
                                  "MarkerData"])
def test_copied_dataclasses_match(name):
    jcls = getattr(j_ingest, name, None) or getattr(ng, name)
    tcls = getattr(t_ingest, name, None) or getattr(ngt, name)
    assert _fields(tcls) == _fields(jcls)


def test_chip_smoke_fails_without_gpu():
    res = _run(["chip_smoke.py"], timeout=300, CUDA_VISIBLE_DEVICES="")  # no card, wherever it runs
    assert res.returncode != 0
    last = (res.stdout.strip().splitlines() or [""])[-1]
    assert '"ok": true' not in last
