"""Gene-regulatory-network structural-equation MH-within-Gibbs sampler.

Counterpart of `nextgp_tpu/grn/sampler.py` (NextGP.jl's `estGRN_MHGibbs`):
    Y = mu + Lambda1 Y + Lambda2 Xc + e      (genes x individuals)
with a gene-to-gene matrix Lambda1 (its off-diagonals, Metropolis-Hastings
with a |det(I - Lambda1)|^(N/2) Jacobian in the target) and SNP-to-gene
effects Lambda2 (single-site Gibbs over all SNPs of every gene). The step
keeps the JAX package's algebra, its order of stages and its draw sites
(it, STAGE_GRN, i): Lambda1's proposal from G batched (G-1) x (G-1)
inverses of YY' blocks, Lambda2's scan as GRN1 (`ops/grn_scan`, one launch
for all genes on the card, on the triangle that `grn_layout` packs once a
chain) and the large products as `torch.matmul` in
full float32 (TF32 off) or float64. A step reads nothing back to the host:
the Metropolis-Hastings choice is a `torch.where` on the card, and `accept`
is a device tensor. On the card a chain with a KeyedStream replays one
captured step a CUDA graph at a time (`GRNChain`), as the JAX package jits
its step; with any other stream, and on the CPU, its steps run eagerly.

Hyper-parameters as in GRN.jl:68-90: df = 4 everywhere, varLambda1 = 5e-4,
varBeta = 5e-4 per gene, scale = v*(df-2)/df.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from ..engine.rng import STAGE_GRN, PhiloxStream, Site
from ..engine.sweep import replays_on
from ..io.writer import MCMCWriter, folder_handler
from ..ops.grn_scan import grn_layout, grn_scan
from ..utils import default_device, default_dtype, full_f32, replace

KEEP_CHUNK = 32  # kept samples copied to the host at once


@contextlib.contextmanager
def _cusolver():
    """torch.linalg on cuSOLVER and cuBLAS within the block. On torch's
    default route the batched inverse of the G (G-1) x (G-1) blocks cannot
    be captured at G = 100 (the capture fails; at G = 6 it holds, and so do
    the Cholesky factors and slogdet at both). The step keeps all its linalg
    calls on this route, on which its chains replay with the eager chain's
    bits."""
    prev = torch.backends.cuda.preferred_linalg_library()
    torch.backends.cuda.preferred_linalg_library("cusolver")
    try:
        yield
    finally:
        torch.backends.cuda.preferred_linalg_library(prev)


@dataclasses.dataclass(frozen=True)
class GRNState:
    """The JAX GRNState's fields, as tensors on one device, but `it`, the
    host's count of steps taken; `it_counter` is its copy on the device,
    which a KeyedStream reads (a captured step's host number is the
    capture's)."""

    mu: torch.Tensor  # (G,)
    lam1: torch.Tensor  # (nL,) off-diagonal coefficients
    lam2: torch.Tensor  # (G, S)
    var_lam1: torch.Tensor  # ()
    var_beta: torch.Tensor  # (G,)
    var_e: torch.Tensor  # ()
    ycorr: torch.Tensor  # (G, N)
    accept: torch.Tensor  # () int32
    it: int
    it_counter: torch.Tensor  # () int64


_TENSORS = ("mu", "lam1", "lam2", "var_lam1", "var_beta", "var_e", "ycorr", "accept", "it_counter")


@dataclasses.dataclass(frozen=True)
class GRNPlan:
    n_genes: int
    n_snps: int
    n_ind: int
    mean_lam1: float
    nu_s_l1: float
    df_l1: float
    nu_s_beta: float
    df_beta: float
    nu_s_e: float
    df_e: float


def _pairs(G):
    """Off-diagonal coefficient ordering: (g, k) row-major, k != g.
    lam1[i] multiplies gene k's expression in gene g's equation."""
    return [(g, k) for g in range(G) for k in range(G) if k != g]


@functools.lru_cache(maxsize=8)
def _pairs_idx(G):
    """(G(G-1), 2) index array of _pairs(G), cached."""
    return np.array(_pairs(G), dtype=np.int64).reshape(-1, 2)


def _lam1_matrix(lam1, G):
    """The (G, G) matrix with lam1 on its off-diagonals, row-major (a torch
    tensor on lam1's device, or a numpy array for a numpy lam1)."""
    idx = _pairs_idx(G)
    if isinstance(lam1, np.ndarray):
        out = np.zeros((G, G), lam1.dtype)
        out[idx[:, 0], idx[:, 1]] = lam1
        return out
    flat = torch.as_tensor(idx[:, 0] * G + idx[:, 1], device=lam1.device)
    return lam1.new_zeros(G * G).index_copy(0, flat, lam1).view(G, G)


def make_grn_step(plan: GRNPlan, xc, ytil, dtype=torch.float64):
    """One MH-within-Gibbs iteration (GRN.jl:103-143): step(state, stream)
    -> state, on xc's device. xc (S, N) the centred dosages and ytil (G, N)
    the fixed regressors, both in the working type; dtype is that of the
    YY' blocks and the identities (the streams draw in their own).

    MpM[(g,k),(g',k')] = delta_gg' YY[k,k'] is block-diagonal in gene g, so
    the proposal covariance inverts as G batched (G-1) x (G-1) blocks."""
    G, S, N = plan.n_genes, plan.n_snps, plan.n_ind
    dev = xc.device
    pairs = _pairs_idx(G)
    n_l = len(pairs)
    excl = torch.as_tensor(np.array([[k for k in range(G) if k != g] for g in range(G)],
                                    dtype=np.int64).reshape(G, G - 1), device=dev)
    with full_f32():
        yy = ytil @ ytil.T  # (G, G)
        gram_x = xc @ xc.T  # (S, S)
    layout = grn_layout(gram_x) if dev.type == "cuda" else None  # GRN1's, once a chain
    yy_sub = yy[excl[:, :, None], excl[:, None, :]].to(dtype)  # (G, G-1, G-1)
    pair_g = torch.as_tensor(pairs[:, 0], device=dev)
    pair_k = torch.as_tensor(pairs[:, 1], device=dev)
    flat = pair_g * G + pair_k
    eye, eye_g = torch.eye(G - 1, dtype=dtype, device=dev), torch.eye(G, dtype=dtype, device=dev)
    alpha_e = torch.tensor((plan.df_e + G * N) / 2.0, dtype=dtype, device=dev)
    alpha_l1 = torch.tensor((plan.df_l1 + n_l) / 2.0, dtype=dtype, device=dev)
    alpha_beta = torch.full((G,), (plan.df_beta + S) / 2.0, dtype=dtype, device=dev)

    linalg = _cusolver if dev.type == "cuda" else contextlib.nullcontext

    def lam_matrix(v):
        return v.new_zeros(G * G).index_copy(0, flat, v).view(G, G)

    def step(state: GRNState, stream) -> GRNState:
        def site(i):
            return Site(state.it, STAGE_GRN, i, counter=state.it_counter)

        with full_f32(), linalg():
            ycorr = state.ycorr

            # 1) residual variance (GRN.jl:106, sampleVarE :245-247)
            ss = torch.sum(ycorr * ycorr)
            var_e = (plan.nu_s_e + ss) / (2.0 * stream.gamma(site(0), alpha_e))

            # 2) gene means (GRN.jl:109-119)
            ycorr = ycorr + state.mu[:, None]
            mean_mu = torch.sum(ycorr, dim=1) / N
            mu = mean_mu + torch.sqrt(var_e / N) * stream.normal(site(1), (G,))
            ycorr = ycorr - mu[:, None]

            # 3) Lambda1 Metropolis-Hastings (GRN.jl:122,192-232), batched
            # over the G diagonal blocks of MpM
            ycorr = ycorr + lam_matrix(state.lam1) @ ytil
            ratio = var_e / state.var_lam1
            # icov has the closed form inv(ilhs*ve) = (yy_sub + ratio*I)/ve
            lhs = yy_sub + ratio * eye[None]
            ilhs = torch.linalg.inv_ex(lhs)[0]  # (G, G-1, G-1)
            yyc = ytil @ ycorr.T  # (G_k, G_g)
            rhs = (yyc[pair_k, pair_g] + plan.mean_lam1 * ratio).reshape(G, G - 1)
            lam_mean = torch.einsum("gij,gj->gi", ilhs, rhs)  # (G, G-1)
            cov = ilhs * var_e
            cov = (cov + cov.transpose(1, 2)) / 2.0
            chol = torch.linalg.cholesky_ex(cov)[0]
            z1 = stream.normal(site(2), (n_l,)).reshape(G, G - 1)
            prop = (lam_mean + torch.einsum("gij,gj->gi", chol, z1)).reshape(-1)
            icov = lhs / var_e
            lam_mean_flat = lam_mean.reshape(-1)

            def log_target(lam_vec):
                # log|det(I - Lambda1)|: the JAX package's slogdet, whose
                # sign it drops
                logdet = torch.linalg.slogdet(eye_g - lam_matrix(lam_vec)).logabsdet
                d = (lam_vec - lam_mean_flat).reshape(G, G - 1)
                return (N / 2.0) * logdet - 0.5 * torch.einsum("gi,gij,gj->", d, icov, d)

            log_a = log_target(prop) - log_target(state.lam1)
            acc = torch.log(stream.uniform(site(3), ())) < log_a
            lam1 = torch.where(acc, prop, state.lam1)
            accept = state.accept + acc.to(torch.int32)
            ycorr = ycorr - lam_matrix(lam1) @ ytil

            # 4) var(lambda1) (GRN.jl:125, :238-240)
            d1 = lam1 - plan.mean_lam1
            var_lam1 = (plan.nu_s_l1 + d1 @ d1) / (2.0 * stream.gamma(site(4), alpha_l1))

            # 5) Lambda2 single-site Gibbs over all SNPs of every gene
            # (GRN.jl:128,150-164); the reference's prior-mean shift is
            # identically zero (GRN.jl:72,153-156), as in the JAX package
            z2 = stream.normal(site(5), (G, S))
            lam2, u = grn_scan(gram_x, ycorr @ xc.T, z2, state.lam2, var_e, layout)
            ycorr = ycorr + u @ xc

            # 6) per-gene SNP-effect variances (GRN.jl:131-133, :242-244)
            ssb = torch.sum(lam2 * lam2, dim=1)
            var_beta = (plan.nu_s_beta + ssb) / (2.0 * stream.gamma(site(6), alpha_beta))

        return replace(state, mu=mu, lam1=lam1, lam2=lam2, var_lam1=var_lam1, var_beta=var_beta,
                       var_e=var_e, ycorr=ycorr, accept=accept, it=state.it + 1,
                       it_counter=state.it_counter + 1)

    step.lam_matrix = lam_matrix
    return step


def grn_state_from_numpy(plan: GRNPlan, arrays, device=None, dtype=None) -> GRNState:
    """A GRNState on `device` (the card unless "cpu") from the JAX
    GRNState's fields as numpy arrays (a mapping of field name to array):
    floats in dtype (default: utils.default_dtype), accept int32, it a host
    int and its device copy."""
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    G, S, N = plan.n_genes, plan.n_snps, plan.n_ind
    shapes = dict(mu=(G,), lam1=(G * G - G,), lam2=(G, S), var_lam1=(), var_beta=(G,), var_e=(),
                  ycorr=(G, N))
    fields = {}
    for name, shape in shapes.items():
        a = np.asarray(arrays[name])
        if a.shape != shape:
            raise ValueError(f"grn_state_from_numpy: {name} has shape {a.shape}, the plan's is {shape}")
        fields[name] = torch.tensor(a, dtype=dtype, device=device)
    it = int(np.asarray(arrays["it"]))
    return GRNState(**fields, accept=torch.tensor(int(np.asarray(arrays["accept"])), dtype=torch.int32,
                                                  device=device),
                    it=it, it_counter=torch.tensor(it, dtype=torch.int64, device=device))


class GRNChain:
    """A GRN chain from `state`: on the card with a stream that can be
    captured (KeyedStream), replays of one step captured in a CUDA graph on
    buffers of its own (`static`: each replay ends by copying the step's
    outputs into them); else eager steps. Before capture one step runs
    eagerly on the capture stream and is discarded, so that the kernels and
    the libraries' handles exist outside the graph's memory. A capture that
    fails raises: nothing falls back to eager steps."""

    def __init__(self, step, state: GRNState, stream):
        self.step, self.stream = step, stream
        self._state, self.graph = state, None
        if replays_on(state.ycorr.device, stream, eager_ok=True):
            dev = state.ycorr.device
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                step(state, stream)
            main.wait_stream(side)
            self.static = replace(state, **{f: getattr(state, f).clone() for f in _TENSORS})
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph, stream=side):
                out = step(self.static, stream)
                for f in _TENSORS:
                    getattr(self.static, f).copy_(getattr(out, f))
            self.it = state.it

    def run(self, n: int) -> None:
        """n steps."""
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._state = self.step(self._state, self.stream)
        if self.graph is not None:
            self.it += n

    @property
    def state(self) -> GRNState:
        """The state after the steps run so far (on the card, replayed: the
        graph's buffers, which the next step overwrites)."""
        return self._state if self.graph is None else replace(self.static, it=self.it)


def grn_sample(state: GRNState, step):
    """The kept quantities of est_grn, as new tensors on the state's device
    (step: make_grn_step's, whose Lambda1 matrix it uses): Lambda1 and
    Lambda2 dumped column-major, as the JAX package dumps them."""
    return {
        "Lambda1": step.lam_matrix(state.lam1).T.reshape(-1).clone(),
        "varLambda1": state.var_lam1.reshape(-1).clone(),
        "Lambda2": state.lam2.T.reshape(-1).clone(),
        "varBeta": state.var_beta.clone(),
        "varE": state.var_e.reshape(-1).clone(),
        "means": state.mu.clone(),
    }


def prepare_grn(x, y, n_genes: int, start_lam1=None, mean_lam1: float = 0.0, start_lam2=None,
                prior_res: float = 1.0, dtype=None, device=None):
    """est_grn's set-up (GRN.jl:14-98): (plan, initial state, step) on
    `device` (the card unless "cpu") in dtype (None: utils.default_dtype).
    x: (nSNP, nInd) dosages; y: (nGenes, nInd) expression."""
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    G = n_genes
    S, N = x.shape
    xc = x - x.mean(axis=1, keepdims=True)  # GRN.jl:23
    n_l = G * G - G

    mu0 = y.mean(axis=1)  # GRN.jl:42
    lam1_0 = np.zeros(n_l) if start_lam1 is None else np.asarray(start_lam1, float)
    lam2_0 = np.zeros((G, S)) if start_lam2 is None else np.asarray(start_lam2, float)

    # hyperpriors (GRN.jl:68-90)
    df = 4.0
    var_lam1_0 = 5e-4
    var_beta_0 = 5e-4
    nu_s_l1 = var_lam1_0 * (df - 2.0)  # scale*df
    nu_s_beta = var_beta_0 * (df - 2.0)
    nu_s_e = prior_res * (df - 2.0)

    ycorr0 = y - mu0[:, None] - _lam1_matrix(lam1_0, G) @ y - lam2_0 @ xc  # GRN.jl:95

    plan = GRNPlan(
        n_genes=G, n_snps=S, n_ind=N, mean_lam1=float(mean_lam1),
        nu_s_l1=nu_s_l1, df_l1=df, nu_s_beta=nu_s_beta, df_beta=df,
        nu_s_e=nu_s_e, df_e=df,
    )
    state = grn_state_from_numpy(plan, dict(
        mu=mu0, lam1=lam1_0, lam2=lam2_0, var_lam1=var_lam1_0, var_beta=np.full(G, var_beta_0),
        var_e=prior_res, ycorr=ycorr0, accept=0, it=0), device=device, dtype=dtype)
    ytil = state.ycorr.clone()  # fixed regressors (GRN.jl:98, BIGM)
    step = make_grn_step(plan, torch.as_tensor(xc, dtype=dtype, device=device), ytil, dtype)
    return plan, state, step


def est_grn(
    x,
    y,
    n_genes: int,
    snp_per_gene: int,
    chain_length: int,
    burn_in: int,
    output_freq: int,
    start_lam1: Optional[np.ndarray] = None,
    mean_lam1: float = 0.0,
    start_lam2: Optional[np.ndarray] = None,
    prior_res: float = 1.0,
    out_folder: Optional[str] = "outMCMC",
    seed: int = 0,
    dtype=None,
    device=None,
    stream=None,
):
    """estGRN_MHGibbs equivalent (GRN.jl:14-145). x: (nSNP, nInd) dosages;
    y: (nGenes, nInd) expression. Returns (acceptance count, draws dict,
    final state); with out_folder, the kept draws are also written to its
    `<quantity>Out` files (the folder wiped first).

    snp_per_gene is accepted for signature parity: the reference builds cis
    windows from it (GRN.jl:32-38) but its sampleΛ2! loops over ALL SNPs for
    every gene (GRN.jl:150-164), as this sampler does.

    device: where the chain runs (the card unless "cpu"; without a card this
    raises before the output folder is touched). dtype None is
    utils.default_dtype(device). stream overrides the default
    PhiloxStream(seed) (eager steps); a KeyedStream on the card runs the
    chain as CUDA-graph replays of one step."""
    plan, state, step = prepare_grn(x, y, n_genes, start_lam1, mean_lam1, start_lam2, prior_res,
                                    dtype, device)
    stream = stream or PhiloxStream(seed, state.ycorr.device, state.ycorr.dtype)

    writer = None
    if out_folder:
        folder_handler(out_folder)
        writer = MCMCWriter(out_folder)
    draws: dict = {}
    kept: list = []

    def flush():
        host = {nm: torch.stack([s[nm] for s in kept]).cpu().numpy() for nm in kept[0]}
        for r in range(len(kept)):
            sample = {nm: v[r] for nm, v in host.items()}
            if writer:
                writer.put(sample)
            for nm, v in sample.items():
                draws.setdefault(nm, []).append(v)
        kept.clear()

    chain = GRNChain(step, state, stream)
    done = 0
    try:
        for it in range(burn_in + output_freq, chain_length + 1, output_freq):
            if it < 1:
                continue
            chain.run(it - done)
            done = it
            kept.append(grn_sample(chain.state, step))
            if len(kept) == KEEP_CHUNK:
                flush()
        chain.run(chain_length - done)
        if kept:
            flush()
    finally:
        if writer:
            writer.close()
    state = chain.state
    return int(state.accept), {k: np.stack(v) for k, v in draws.items()}, state
