"""The port's formula front end against the JAX package's, on the CPU.

`parse_formula` on the cases of tests/test_formula_parity.py (PBLUP with
PED(ID) + PED(Dam) + (1|Dam) and a fixed-effect block, a correlated tuple
prior, a user-matrix structure, SNP(name, map=...) with dict genotypes,
a positional genotype path containing '=', and the errors they raise), and
on a GBLUP term (G^-1 from the port's GRM on the CPU), a CG-sampled
PED term, an interaction, centred float covariates and a full-dummy hint:
both packages give the same ModelSpec, field for field (arrays equal, G^-1
at 1e-12). `build_lv_design` agrees; a BayesLV model whose covariates are a
formula string sweeps as the JAX one does (3 sweeps from the JAX keys,
rtol 1e-9); the prior aliases and `is_marker_prior` agree.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import nextgp_tpu as ng
import nextgp_tpu_torch as ngt
from nextgp_tpu.api import formula as j_formula
from nextgp_tpu.api import priors as j_priors
from nextgp_tpu_torch.api import formula as t_formula
from nextgp_tpu_torch.api import priors as t_priors
from test_torch_sweep import JaxStream, _assert_chains_agree


def _host(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else a


def _assert_same(t, j, where="spec"):
    """Field for field: dataclasses by their fields (the class names equal),
    arrays equal (floats within 1e-12 of their scale: the port's G^-1 is a
    torch inverse), containers item by item, anything else equal."""
    t, j = _host(t), _host(j)
    if dataclasses.is_dataclass(j):
        assert type(t).__name__ == type(j).__name__, where
        for f in dataclasses.fields(j):
            _assert_same(getattr(t, f.name), getattr(j, f.name), f"{where}.{f.name}")
    elif isinstance(j, dict):
        assert set(t) == set(j), where
        for k in j:
            _assert_same(t[k], j[k], f"{where}[{k!r}]")
    elif isinstance(j, (list, tuple)):
        assert type(t) is type(j) and len(t) == len(j), where
        for i, (a, b) in enumerate(zip(t, j)):
            _assert_same(a, b, f"{where}[{i}]")
    elif isinstance(j, np.ndarray) or isinstance(t, np.ndarray):
        a, b = np.asarray(t), np.asarray(j)
        assert a.shape == b.shape, where
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=1e-12 * max(1.0, np.abs(b).max()),
                                       err_msg=where)
        else:
            np.testing.assert_array_equal(a, b, err_msg=where)
    else:
        assert t == j, where


def _pedigree(tmp_path, rng, n_ped=40, n=25):
    sire = ["0"] * n_ped
    dam = ["0"] * n_ped
    for i in range(10, n_ped):
        s, d = rng.integers(0, i, 2)
        if s != d:
            sire[i], dam[i] = f"A{s + 1}", f"A{d + 1}"
    ped_path = tmp_path / "ped.txt"
    ped_path.write_text("".join(f"A{i + 1} {sire[i]} {dam[i]}\n" for i in range(n_ped)))
    idx = rng.choice(np.arange(10, n_ped), n, replace=False)
    data = {
        "BW": rng.normal(10, 2, n),
        "ID": np.array([f"A{i + 1}" for i in idx]),
        "Dam": np.array([dam[i] if dam[i] != "0" else "A1" for i in idx]),
        "Herds": rng.integers(0, 3, n),
        "Pen": rng.integers(0, 2, n),
        "x": rng.normal(0, 1, n),
        "farm": np.array(["a", "b", "c", "a", "b"] * (n // 5)),
    }
    return str(ped_path), data


def _case(name, tmp_path):
    """(formula, data, a function of the package giving parse_formula's
    other arguments) of one case; the same seed for both packages."""
    rng = np.random.default_rng(60)
    if name in ("pblup", "corr_tuple", "interaction", "ped_cg"):
        ped, data = _pedigree(tmp_path, rng)
        if name == "pblup":
            return ("BW ~ Herds + Pen + PED(ID) + PED(Dam) + (1|Dam)", data, lambda m: dict(
                priors={"ID": m.Random("A", 150.0), "Dam": m.Random("A", 90.0),
                        "1|Dam": m.Random("I", 40.0), "e": m.Random("I", 350.0)},
                path2ped=ped, blocks=[("Herds", "Pen")]))
        if name == "corr_tuple":
            v = np.array([[150.0, 30.0], [30.0, 90.0]])
            return ("BW ~ Herds + PED(ID) + PED(Dam)", data,
                    lambda m: dict(priors={("ID", "Dam"): m.Random("A", v)}, path2ped=ped))
        if name == "ped_cg":
            return ("BW ~ 1 + x + PED(ID)", data, lambda m: dict(
                priors={"ID": m.Random("A", 0.5, sampler="cg")}, path2ped=ped))
        return ("BW ~ 1 + x + farm + Herds:farm", data, lambda m: dict(hints={"farm": "full_dummy"}))
    if name == "user_matrix":
        n, q = 30, 5
        a = rng.normal(0, 1, (q, q))
        user = a @ a.T + q * np.eye(q)
        data = {"y": rng.normal(0, 1, n), "grp": np.arange(1, q + 1).repeat(n // q)}
        return "y ~ 1 + (1|grp)", data, lambda m: dict(priors={"grp": m.Random(user, 1.0)})
    if name == "snp_map":
        n, p = 30, 8
        g = rng.integers(0, 3, (n, p)).astype(float)
        mapf = tmp_path / "chip.map"
        mapf.write_text("snpID,snpOrder,chrID\n" + "".join(
            f"s{i},{i + 1},{1 if i < 5 else 2}\n" for i in range(p)))
        return (f"y ~ 1 + SNP(geno, map={mapf})", {"y": rng.normal(0, 1, n)}, lambda m: dict(
            priors={"geno": m.BayesPR(99, 0.05)}, genotypes={"geno": g}, block_size=8))
    if name == "snp_path":
        n, p = 20, 6
        d = tmp_path / "run=2"
        d.mkdir()
        gf = d / "geno.txt"
        gf.write_text("".join(" ".join(map(str, r)) + "\n" for r in rng.integers(0, 3, (n, p))))
        return (f"y ~ 1 + SNP(M, {gf})", {"y": rng.normal(0, 1, n)},
                lambda m: dict(priors={"M": m.BayesR([0.9, 0.1], [0.0, 0.01], 1.0)}, block_size=8))
    if name == "gblup":
        n, p = 24, 40
        g = rng.integers(0, 3, (n, p)).astype(float)
        return ("y ~ 1 + SNP(M)", {"y": rng.normal(0, 1, n)}, lambda m: dict(
            priors={"M": m.Random("G", 0.3, type=2)}, genotypes={"M": g}))
    raise KeyError(name)


CASES = ["pblup", "corr_tuple", "user_matrix", "snp_map", "snp_path", "gblup", "ped_cg",
         "interaction"]


@pytest.mark.parametrize("name", CASES)
def test_parse_formula_matches(name, tmp_path):
    formula, data, kw = _case(name, tmp_path)
    ref = j_formula.parse_formula(formula, data, **kw(ng))
    out = t_formula.parse_formula(formula, data, **kw(ngt), device="cpu")
    _assert_same(out, ref)
    ngt.assemble(out, device="cpu")  # and the port's planner takes it


def test_formula_errors_match(tmp_path):
    """The errors the JAX front end raises, with its words."""
    rng = np.random.default_rng(61)
    data = {"y": rng.normal(0, 1, 10), "g": rng.integers(0, 2, 10)}
    g = rng.integers(0, 3, (10, 6)).astype(float)
    calls = [
        ("y ~ 1 + (1|g)", dict(priors=lambda m: {("g", "h"): m.Random("I", np.eye(2))})),
        ("y ~ 1 + SNP(M, chip=foo)", dict(priors=lambda m: {"M": m.BayesPR(9999, 0.05)},
                                          genotypes=lambda m: {"M": g})),
        ("y ~ 1 + SNP(M)", dict(priors=lambda m: {"M": m.Random("A", 0.05)},
                                genotypes=lambda m: {"M": g})),
        ("y ~ 1 + PED(ID)", {}),
        ("nonsense", {}),
    ]
    for formula, kw in calls:
        msgs = []
        for mod, fmod in ((ng, j_formula), (ngt, t_formula)):
            with pytest.raises(ValueError) as err:
                fmod.parse_formula(formula, data, **{k: f(mod) for k, f in kw.items()})
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1], formula


def test_packed_genotypes_reject_pedigree_reorder(tmp_path):
    from nextgp_tpu_torch.ops import pack2

    rng = np.random.default_rng(62)
    n, p = 6, 8
    g = rng.integers(0, 3, (n, p)).astype(np.int8)
    ped = tmp_path / "ped.txt"
    ped.write_text("id,sire,dam\n" + "".join(f"A{i},0,0\n" for i in reversed(range(n))))
    data = {"y": rng.normal(0, 1, n), "ID": np.array([f"A{i}" for i in range(n)])}
    msgs = []
    for mod, fmod in ((ng, j_formula), (ngt, t_formula)):
        md = mod.from_packed(pack2.pack2_np(g), n_ind=n, center=g.astype(float).mean(0))
        with pytest.raises(ValueError, match="packed") as err:
            fmod.parse_formula("y ~ 1 + PED(ID) + SNP(geno)", data,
                               priors={"ID": mod.Random("A", 0.5), "geno": mod.BayesPR(9999, 0.05)},
                               path2ped=str(ped), genotypes={"geno": md}, block_size=8)
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]


def _lv_table(p=48):
    rng = np.random.default_rng(63)
    return {"w": rng.normal(0, 1, p), "grp": rng.integers(0, 3, p),
            "lab": np.array(["u", "v"] * (p // 2))}


@pytest.mark.parametrize("rhs,hints", [("1 + w", None), ("1 + w + grp + lab", None),
                                       ("w + lab", {"lab": "full_dummy"})])
def test_build_lv_design_matches(rhs, hints):
    table = _lv_table()
    C, labels = t_formula.build_lv_design(rhs, table, hints)
    Cj, labels_j = j_formula.build_lv_design(rhs, table, hints)
    assert labels == labels_j
    np.testing.assert_array_equal(C, Cj)
    for fmod in (j_formula, t_formula):
        with pytest.raises(ValueError, match="empty variance-model formula"):
            fmod.build_lv_design("  ", table)


def test_bayeslv_formula_string_sweeps_match():
    """BayesLV with covariates "1 + w + grp" built against its table: the
    port's planner builds the design as the JAX planner does, and 3 sweeps
    from the JAX keys agree at rtol 1e-9."""
    rng = np.random.default_rng(64)
    n, p = 60, 48
    g = rng.integers(0, 3, (n, p)).astype(float)
    y = 1.0 + (g - g.mean(0)) @ rng.normal(0, 0.2, p) + rng.normal(0, 1, n)
    specs = [mod.ModelSpec(y=y, fixed=[mod.FixedTerm("int", np.ones(n))], markers=[mod.MarkerTerm(
        "M", mod.from_array(g), mod.BayesLV(0.01, "1 + w + grp", 0.01, estimateVarZeta=True,
                                            covariate_table=_lv_table(p)))], block_size=16)
             for mod in (ng, ngt)]
    jplan, jst = ng.assemble(specs[0], use_pallas=False, pack2=True)
    tplan, tst = ngt.assemble(specs[1], dtype=torch.float64, device="cpu")
    assert tplan.markers[0].n_lv_cov == jplan.markers[0].n_lv_cov == 4
    np.testing.assert_array_equal(tst.markers[0].lv_design.numpy(), np.asarray(jst.markers[0].lv_design))
    jsweep, tsweep = jax.jit(ng.make_sweep(jplan)), ngt.make_sweep(tplan)
    stream = JaxStream(jax.random.key(65))
    for _ in range(3):
        jst = jsweep(jst, jax.random.key(65))
        tst = tsweep(tst, stream)
    _assert_chains_agree(tst, jst, tplan)


def test_prior_aliases_match():
    for alias in ("bayes_alias_BayesA", "bayes_alias_ridge"):
        t, j = getattr(t_priors, alias)(0.05), getattr(j_priors, alias)(0.05)
        _assert_same(t, j)
    assert [c.__name__ for c in t_priors.MARKER_PRIORS] == [c.__name__ for c in j_priors.MARKER_PRIORS]
    for tp, jp in ((t_priors.BayesC(0.9, 0.1), j_priors.BayesC(0.9, 0.1)),
                   (t_priors.RandomEffect("I", 1.0), j_priors.RandomEffect("I", 1.0)),
                   (t_priors.bayes_alias_ridge(1.0), j_priors.bayes_alias_ridge(1.0)), (3, 3)):
        assert t_priors.is_marker_prior(tp) == j_priors.is_marker_prior(jp)
