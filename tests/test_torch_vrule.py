"""vshards="auto": the rule measured on the card, and 1 on the CPU.

`_card_vshards` is a pure function of the block count, the block size, the
records and the method: its result divides the block count and leaves at
least two block-steps a sweep, a method that the quality gate admitted at
no V > 1 gets 1, and the shapes measured on an H100 (`python3 chip_smoke.py
vrule`, PERF.md §5) give the V recorded there. On the CPU "auto" is 1 for
every method and for correlated marker sets, as the JAX package resolves it
off its kernel path, and a checkpoint taken at one V is refused at another
with a message that says so.
"""
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu_torch.engine import plan as t_plan
from test_torch_corr import _marker_specs
from test_torch_sweep import _specs

KINDS = ("BayesPR", "BayesB", "BayesC", "BayesR", "BayesRCpi", "BayesRCplus", "BayesLV", "BayesC+D")
# the kinds whose chain the gate admitted at no V > 1 on the card
REFUSED = ("BayesPR", "BayesRCplus", "BayesLV", "BayesC+D")
# the largest V the gate admitted, by kind, at 10,000 x 49,152 in blocks of 256
CAPS = {"BayesR": 96, "BayesRCpi": 96, "BayesB": 32, "BayesC": 8}
# the measured shapes (records, block count) at B = 256 -> the V the rule
# gives each kind there (PERF.md §5): 10,000 and 50,000 x 49,152, 10,000 x
# 50,000, 10,000 x 589,824, and the gate's second panel, 2,000 x 8,192,
# where the gate admitted BayesR and BayesRCpi to 4, BayesB to 8, BayesC 1
MEASURED = {(10_000, 192): CAPS, (50_000, 192): CAPS,
            (10_000, 196): {"BayesR": 49, "BayesRCpi": 49, "BayesB": 28, "BayesC": 7},
            (10_000, 2304): CAPS,
            (2_000, 32): {"BayesR": 2, "BayesRCpi": 2, "BayesB": 1, "BayesC": 1}}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("nb", [1, 2, 7, 32, 192, 196, 197, 232, 2304])
def test_card_rule_divides_the_block_count(nb, kind):
    for n, block in ((10_000, 256), (2_000, 256), (50_000, 128), (300, 32)):
        v = t_plan._card_vshards(nb, block, n, kind)
        assert 1 <= v <= nb and nb % v == 0
        assert v < nb or nb == 1
        assert v <= CAPS.get(kind, 1)
        if kind in REFUSED:
            assert v == 1
    if (10_000, nb) in MEASURED:
        assert t_plan._card_vshards(nb, 256, 10_000, kind) == MEASURED[10_000, nb].get(kind, 1)


@pytest.mark.parametrize("shape", sorted(MEASURED))
def test_card_rule_at_the_measured_shapes(shape):
    n, nb = shape
    got = {kind: t_plan._card_vshards(nb, 256, n, kind) for kind in KINDS}
    assert got == {kind: MEASURED[shape].get(kind, 1) for kind in KINDS}


def test_card_rule_follows_the_records_and_the_block():
    """V * block concurrent loci at most the gate's times (n / 10,000)^2: a
    block of 512 halves BayesR's V at 10,000 records (the CLI's default
    block size), half the records quarter it, more records raise no cap."""
    assert t_plan._card_vshards(96, 512, 10_000, "BayesR") == 48
    assert t_plan._card_vshards(192, 256, 5_000, "BayesR") == 24
    assert t_plan._card_vshards(192, 256, 1_000, "BayesC") == 1
    assert t_plan._card_vshards(192, 256, 100_000, "BayesC") == 8


def test_card_rule_takes_an_unmeasured_kind_at_one():
    """A weighted residual on a method the gate did not measure with one
    (BayesR+D) and an unknown name run the sequential order."""
    assert t_plan._card_vshards(192, 256, 10_000, "BayesR+D") == 1
    assert t_plan._card_vshards(192, 256, 10_000, "BayesX") == 1


def test_resolve_keeps_integers_and_correlated_sets_without_a_card():
    """An explicit V, and "auto" for a correlated set (method None), resolve
    without asking the card, on a CUDA device as on the CPU."""
    cuda = torch.device("cuda")
    assert t_plan._resolve_vshards(96, 192, "M", cuda, "BayesR") == 96
    assert t_plan._resolve_vshards("auto", 192, "M1+M2", cuda, None) == 1
    assert t_plan._resolve_vshards("auto", 192, "M", torch.device("cpu"), "BayesR") == 1
    with pytest.warns(UserWarning, match="largest divisor V=64"):
        assert t_plan._resolve_vshards(80, 192, "M", cuda, "BayesR") == 64


def _method_of(kind):
    return kind[:-2] if kind.endswith("+D") else kind


@pytest.mark.parametrize("kind", KINDS)
def test_auto_is_one_on_the_cpu(kind):
    """assemble(vshards="auto", device="cpu") gives V = 1 and records it as
    the V asked for, as the JAX package's assemble(use_pallas=False)."""
    jspec, tspec = _specs(_method_of(kind), weighted=kind.endswith("+D"))
    jplan, _ = ng.assemble(jspec, use_pallas=False, vshards="auto")
    tplan, _ = ngt.assemble(tspec, vshards="auto", device="cpu")
    assert tplan.markers[0].n_blocks > 1
    assert [mp.vshards for mp in tplan.markers] == [mp.vshards for mp in jplan.markers] == [1]
    assert tplan.markers[0].vshards_asked == 1


def test_auto_is_one_for_correlated_sets_on_the_cpu():
    jspec, tspec = _marker_specs(2)
    jplan, _ = ng.assemble(jspec, use_pallas=False, vshards="auto")
    tplan, _ = ngt.assemble(tspec, vshards="auto", device="cpu")
    assert tplan.corr_markers[0].n_blocks > 1
    assert [cp.vshards for cp in tplan.corr_markers] == [cp.vshards for cp in jplan.corr_markers] == [1]
    assert tplan.corr_markers[0].vshards_asked == 1


def test_checkpoint_at_another_v_is_refused(tmp_path):
    """A checkpoint written at V = 1 (as "auto" gave on every device before
    the card's rule) does not resume at V = 2: the fingerprint refuses it,
    and the message says why."""
    _, spec = _specs("BayesR")
    kw = dict(n_chain=6, n_burn=2, n_thin=2, device="cpu", out_folder=str(tmp_path / "out"),
              checkpoint_every=1)
    ngt.run_lmem(spec, vshards=1, **{**kw, "n_chain": 4})
    with pytest.raises(ValueError, match=r"block chains \(V\) differ\. A chain is not continued at another V"):
        ngt.run_lmem(spec, vshards=2, resume=True, **kw)
    res = ngt.run_lmem(spec, vshards=1, resume=True, **kw)
    assert res.plan.markers[0].vshards == 1 and np.isfinite(res.draws["varE"]).all()
