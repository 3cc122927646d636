"""Command-line runner: declarative config -> MCMC run on the card.

A copy of `nextgp_tpu/cli.py` (`run`, `summary`, `diag`, `predict`,
`roofline`) over the port's entry points. NextGP.jl has no CLI or config
system — everything is `runLMEM(...)` keyword arguments in Julia
(`src/MCMC.jl:31`). Here a JSON (or TOML) config
compiles to the same pipeline:

    python -m nextgp_tpu_torch run analysis.json
    python -m nextgp_tpu_torch summary betaM --out-folder outMCMC
    python -m nextgp_tpu_torch diag varE --out-folder outMCMC   # multi-chain R-hat/ESS
    python -m nextgp_tpu_torch predict analysis.json --set M --new new_geno.txt
    python -m nextgp_tpu_torch roofline analysis.json --device h100

Config schema (all paths relative to the config file):

    {
      "formula":   "y ~ 1 + sex + (1|herd) + PED(ID) + SNP(M)",
      "data":      "pheno.csv",                  # CSV with header
      "pedigree":  "ped.txt",                    # optional
      "genotypes": {"M": "geno.txt"},            # per SNP(name) term
      "priors":    {"M":  {"type": "BayesR", "pi": [0.9,0.1], "class": [0.0,0.01], "v": 1.0},
                    "ID": {"type": "Random", "str": "A", "v": 0.5},
                    "e":  {"type": "Random", "str": "I", "v": 1.0}},
      "blocks":    [["x1", "x2"]],               # joint fixed-effect blocks
      "hints":     {"farm": "full_dummy"},
      "chain":     {"length": 50000, "burnin": 5000, "thin": 10, "seed": 1,
                    "chains": 4},               # >1 = run_chains + R-hat/ESS
      "block_size": 512,
      "vshards":   "auto",                       # or an int; "auto": see _parse_vshards
      "out_folder": "outMCMC",
      "device":    "cuda"                        # port only: where the chain runs
    }

The port adds one key. "device" (default the card) is where `run`,
`roofline` and a GBLUP term's G^-1 work; without a CUDA device and without
"device": "cpu", `run` raises before it reads anything, as `run_lmem` does:
there is no CPU fallback. `run` draws every chain from a KeyedStream
(engine/rng.py), so that the card replays its sweeps as CUDA graphs; the
draws differ from the JAX CLI's, as any port stream's do.
`predict` on a config whose genotype entry for the set is not a file path
returns 2 with a message on stderr (the JAX CLI raises a TypeError there).
"""
from __future__ import annotations

import argparse
import csv
import json
import os
import sys
from typing import Any, Dict

import numpy as np

from .api import priors as P


def _load_config(path: str) -> Dict[str, Any]:
    if path.endswith(".toml"):
        import tomllib

        with open(path, "rb") as fh:
            return tomllib.load(fh)
    with open(path) as fh:
        return json.load(fh)


def _read_csv(path: str) -> Dict[str, np.ndarray]:
    """Header CSV -> dict of columns with numeric inference (the reference
    uses CSV.read + DataFrame, MCMC.jl docs examples)."""
    with open(path, newline="") as fh:
        sniff = csv.Sniffer().sniff(fh.read(4096), delimiters=",;\t ")
        fh.seek(0)
        rows = list(csv.reader(fh, dialect=sniff))
    header, body = rows[0], [r for r in rows[1:] if r]
    cols: Dict[str, np.ndarray] = {}
    for j, name in enumerate(header):
        vals = [r[j] for r in body]
        try:
            ivals = [int(v) for v in vals]
            cols[name] = np.asarray(ivals)
            continue
        except ValueError:
            pass
        try:
            cols[name] = np.asarray([float(v) for v in vals])
        except ValueError:
            cols[name] = np.asarray(vals)
    return cols


_PRIOR_BUILDERS = {
    "BayesPR": lambda d: P.BayesPR(d.get("r", 9999), d["v"]),
    "BayesA": lambda d: P.BayesPR(1, d["v"]),
    "BayesB": lambda d: P.BayesB(d["pi"], d["v"], estimatePi=d.get("estimatePi", False)),
    "BayesC": lambda d: P.BayesC(d["pi"], d["v"], estimatePi=d.get("estimatePi", False)),
    "BayesR": lambda d: P.BayesR(
        d["pi"], d.get("class", d.get("class_")), d["v"], estimatePi=d.get("estimatePi", False)
    ),
    "BayesRCpi": lambda d: P.BayesRCpi(
        d["pi"], d.get("class", d.get("class_")), d["v"], np.asarray(d["annot"]),
        estimatePi=d.get("estimatePi", False),
    ),
    "BayesRCplus": lambda d: P.BayesRCplus(
        d["pi"], d.get("class", d.get("class_")), d["v"], np.asarray(d["annot"]),
        estimatePi=d.get("estimatePi", False),
    ),
    "BayesLV": lambda d: P.BayesLV(
        d["v"], np.asarray(d["covariates"], dtype=np.float64), d["varZeta"],
        estimateVarZeta=d.get("estimateVarZeta", False),
    ),
    "Random": lambda d: P.RandomEffect(d.get("str", "I"), d["v"], type=d.get("type_g", 1)),
}


def _build_prior(d: Any):
    if not isinstance(d, dict):
        return d
    t = d.get("type")
    if t not in _PRIOR_BUILDERS:
        raise ValueError(f"unknown prior type {t!r}; one of {sorted(_PRIOR_BUILDERS)}")
    return _PRIOR_BUILDERS[t](d)


def _spec_from_config(cfg: Dict[str, Any], base: str, device=None):
    from .api.formula import parse_formula

    def rel(p):
        return p if os.path.isabs(p) else os.path.join(base, p)

    data = _read_csv(rel(cfg["data"]))
    priors = {k: _build_prior(v) for k, v in (cfg.get("priors") or {}).items()}
    genotypes = {k: rel(v) if isinstance(v, str) else v for k, v in (cfg.get("genotypes") or {}).items()}
    return parse_formula(
        cfg["formula"],
        data,
        priors=priors,
        hints=cfg.get("hints"),
        path2ped=rel(cfg["pedigree"]) if cfg.get("pedigree") else None,
        blocks=[tuple(b) for b in cfg.get("blocks", [])],
        block_size=int(cfg.get("block_size", 256)),
        genotypes=genotypes,
        device=device,
    )


def _parse_vshards(v):
    """Config `vshards`: "auto" (default: V = 1 on the CPU and for
    correlated marker sets; on a CUDA device a single marker set takes the
    rule measured on an H100 from its block count, block size, records and
    prior) or an explicit integer (1: the sequential order)."""
    return "auto" if isinstance(v, str) and v.lower() == "auto" else int(v)


def _device(cfg: Dict[str, Any]):
    """The config's "device", else the card (raising without one)."""
    import torch

    from .utils import default_device

    return torch.device(cfg["device"]) if cfg.get("device") else default_device()


def _streams(device, seed: int, n_chains: int):
    """One KeyedStream per chain, seeded as `run_lmem` (one chain) and
    `run_chains` (runtime.chain_seed) seed their default streams."""
    from .engine.rng import KeyedStream
    from .runtime import chain_seed
    from .utils import default_dtype

    dtype = default_dtype(device)
    if n_chains == 1:
        return [KeyedStream(seed, device, dtype)]
    return [KeyedStream(chain_seed(seed, c), device, dtype) for c in range(n_chains)]


def cmd_run(args) -> int:
    from .runtime import run_chains, run_lmem

    cfg = _load_config(args.config)
    device = _device(cfg)
    base = os.path.dirname(os.path.abspath(args.config))
    spec = _spec_from_config(cfg, base, device)
    ch = cfg.get("chain", {})
    out_folder = cfg.get("out_folder", "outMCMC")
    if not os.path.isabs(out_folder):
        out_folder = os.path.join(base, out_folder)
    n_chains = int(ch.get("chains", 1))
    seed = int(ch.get("seed", 0))
    streams = _streams(device, seed, n_chains)
    if n_chains > 1:
        # the chains in turn on the card with built-in R-hat/ESS
        out = run_chains(
            spec,
            n_chains=n_chains,
            n_chain=int(ch.get("length", 5000)),
            n_burn=int(ch.get("burnin", 1000)),
            n_thin=int(ch.get("thin", 10)),
            seed=seed,
            track=ch.get("track", "all"),
            out_folder=out_folder,
            vshards=_parse_vshards(cfg.get("vshards", "auto")),
            checkpoint_every=int(ch.get("checkpoint_every", 0)),
            resume=args.resume,
            progress=not args.quiet,
            device=device,
            streams=streams,
        )
        worst = max(
            (float(np.nanmax(v)) for v in out["rhat"].values()
             if np.isfinite(v).any()),
            default=float("nan"),
        )
        print(f"done: {n_chains} chains in {out_folder}; "
              f"worst split-Rhat {worst:.3f}")
        return 0
    res = run_lmem(
        spec,
        n_chain=int(ch.get("length", 5000)),
        n_burn=int(ch.get("burnin", 1000)),
        n_thin=int(ch.get("thin", 10)),
        out_folder=out_folder,
        seed=seed,
        keep_in_memory=False,
        progress=not args.quiet,
        vshards=_parse_vshards(cfg.get("vshards", "auto")),
        checkpoint_every=int(ch.get("checkpoint_every", 0)),
        resume=args.resume,
        device=device,
        stream=streams[0],
    )
    print(f"done: {res.sweeps_per_sec:.1f} sweeps/s, output in {out_folder}")
    return 0


def cmd_diag(args) -> int:
    """Cross-chain split-Rhat/ESS from run_chains output folders."""
    import glob as _glob

    from .io.summary import ess_bulk, read_samples, split_rhat

    folders = sorted(_glob.glob(os.path.join(args.out_folder, "chain*")))
    if len(folders) < 2:
        print(f"need >=2 chain folders under {args.out_folder} "
              f"(found {len(folders)}); run with chain.chains > 1", file=sys.stderr)
        return 1
    chains = np.stack([read_samples(args.param, f) for f in folders])
    rhat = split_rhat(chains)
    ess = ess_bulk(chains)
    print(f"{args.param}: {chains.shape[0]} chains x {chains.shape[1]} draws")
    print("split-Rhat: " + " ".join(f"{v:.4f}" for v in np.atleast_1d(rhat)[:8])
          + (" ..." if np.atleast_1d(rhat).size > 8 else ""))
    print("ESS:        " + " ".join(f"{v:.1f}" for v in np.atleast_1d(ess)[:8])
          + (" ..." if np.atleast_1d(ess).size > 8 else ""))
    worst = float(np.nanmax(rhat))
    print(f"worst Rhat {worst:.4f} -> {'OK (< 1.05)' if worst < 1.05 else 'NOT CONVERGED'}")
    return 0 if worst < 1.05 else 2


def cmd_summary(args) -> int:
    from .io.summary import summary_mcmc

    means = summary_mcmc(args.param, out_folder=args.out_folder)
    np.savetxt(sys.stdout, np.atleast_1d(means)[None], fmt="%.6g", delimiter="\t")
    return 0


def cmd_roofline(args) -> int:
    from .diag import roofline
    from .engine.plan import assemble

    cfg = _load_config(args.config)
    device = _device(cfg)
    spec = _spec_from_config(cfg, os.path.dirname(os.path.abspath(args.config)), device)
    plan, _ = assemble(spec, device=device)
    print(roofline(plan, device=args.device, n_shards=args.shards))
    return 0


def cmd_predict(args) -> int:
    """Serve EBVs from a finished run: training-panel genomic values, or
    predictions for NEW individuals under the trained centering. The
    reference leaves this to user-side file post-processing
    (docs/src/BWGR/BWGR.md:50-58)."""
    from .data.ingest import read_genotype_file
    from .io.summary import summary_mcmc
    from .predict import genomic_values, predict

    cfg = _load_config(args.config)
    base = os.path.dirname(os.path.abspath(args.config))

    def rel(p):
        return p if os.path.isabs(p) else os.path.join(base, p)

    genos = cfg.get("genotypes") or {}
    if args.set not in genos:
        print(f"marker set {args.set!r} not in config genotypes "
              f"{sorted(genos)}", file=sys.stderr)
        return 2
    if not isinstance(genos[args.set], str):
        print(f"marker set {args.set!r}: predict reads the genotypes from a file, and the "
              "config gives no file path for it", file=sys.stderr)
        return 2
    md = read_genotype_file(rel(genos[args.set]))
    beta = np.atleast_1d(summary_mcmc(f"beta{args.set}",
                                      out_folder=args.out_folder))
    if args.new:
        new_md = read_genotype_file(rel(args.new))
        ebv = predict(md, beta, new_md.genotypes)
    else:
        ebv = genomic_values(md, beta)
    out = open(args.output, "w") if args.output else sys.stdout
    try:
        np.savetxt(out, ebv[:, None], fmt="%.10g")
    finally:
        if args.output:
            out.close()
            print(f"{len(ebv)} genomic values written to {args.output}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="nextgp_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    r = sub.add_parser("run", help="run an MCMC analysis from a config file, on the card "
                                   "(or the config's \"device\")")
    r.add_argument("config")
    r.add_argument("--quiet", action="store_true")
    r.add_argument("--resume", action="store_true",
                   help="continue from <out_folder>/chain.ckpt if present")
    r.set_defaults(fn=cmd_run)
    s = sub.add_parser("summary", help="posterior means of a tracked quantity")
    s.add_argument("param")
    s.add_argument("--out-folder", default="outMCMC")
    s.set_defaults(fn=cmd_summary)
    rf = sub.add_parser("roofline", help="analytic per-sweep roofline for a config")
    rf.add_argument("config")
    rf.add_argument("--device", default="h100", help="a name in diag._DEVICE_PEAKS")
    rf.add_argument("--shards", type=int, default=1)
    rf.set_defaults(fn=cmd_roofline)
    dg = sub.add_parser("diag", help="cross-chain split-Rhat/ESS from run_chains output")
    dg.add_argument("param")
    dg.add_argument("--out-folder", default="outMCMC")
    dg.set_defaults(fn=cmd_diag)
    pr = sub.add_parser(
        "predict", help="genomic values from a finished run (training panel "
                        "or new individuals under the trained centering)")
    pr.add_argument("config")
    pr.add_argument("--set", default="M", help="marker set name in the config")
    pr.add_argument("--out-folder", default="outMCMC")
    pr.add_argument("--new", default=None,
                    help="genotype file of NEW individuals (training locus "
                         "order); omit for training-panel EBVs")
    pr.add_argument("--output", default=None, help="write values here "
                                                   "instead of stdout")
    pr.set_defaults(fn=cmd_predict)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
