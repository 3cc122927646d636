"""Planner: ModelSpec -> (static SweepPlan, ModelState on the device).

Counterpart of `nextgp_tpu/engine/plan.py:assemble` for the terms the port
carries: the residual ("I" structure), fixed-effect blocks, and BayesR
marker sets stored 2-bit planar-packed in the (T, V, B, q) layout of
engine/state.py. Defaults follow the JAX package (and NextGP.jl's
mme.jl): residual df 4 and scale v*(df-2)/df with the 0.0005 zero-variance
guard; marker df 3 + 1; multi-column fixed blocks get the ridge jitter
I * min|diag| / 10000. Any other term raises NotImplementedError naming it.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Tuple, Union

import numpy as np
import torch

from ..api import priors as P
from ..api.spec import FixedTerm, MarkerTerm, ModelSpec
from ..ops import pack2
from ..utils import cdiv, default_device, default_dtype
from .state import FixedState, MarkerState, ModelState, ResidualState

METHOD_R = "BayesR"


@dataclasses.dataclass(frozen=True)
class FixedPlan:
    name: Union[str, Tuple[str, ...]]
    k: int
    single: bool  # single-column path (functions.jl:41-47)


@dataclasses.dataclass(frozen=True)
class MarkerPlan:
    name: str
    method: str
    p: int
    p_pad: int
    block: int
    n_blocks: int
    n_classes: int
    est_pi: bool
    df: float
    # V block chains advance per block-step; chain v owns the contiguous
    # blocks [v*T, (v+1)*T). V=1 is the reference-sequential order.
    vshards: int = 1


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    n: int
    e_df: float
    fixed: Tuple[FixedPlan, ...]
    markers: Tuple[MarkerPlan, ...]
    dtype: torch.dtype
    device: torch.device


def _build_fixed(term_mats, name, dtype, device):
    """Cross-products + jitter for one fixed block (mme.jl:132-153)."""
    x = np.concatenate(list(term_mats), axis=1)
    k = x.shape[1]
    xpx = x.T @ x
    if k > 1:  # the reference jitters only a Matrix xpx (mme.jl:149-152)
        xpx = xpx + np.eye(k) * np.min(np.abs(np.diag(xpx))) / 10000.0

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    st = FixedState(x=dev(x), xp=dev(np.ascontiguousarray(x.T)), xpx=dev(xpx),
                    lhs_ss=dev(np.zeros(k)), rhs_ss=dev(np.zeros(k)), b=dev(np.zeros(k)))
    return st, FixedPlan(name=name, k=k, single=(k == 1))


def _resolve_vshards(vshards, nb, name):
    if vshards == "auto":
        raise ValueError(
            "vshards='auto': the H100 value has not been measured yet; pass an integer "
            "(1 is the reference-sequential order)")
    vreq = int(vshards)
    vsh = max(v for v in range(1, vreq + 1) if nb % v == 0) if vreq > 1 else 1
    if vreq > 1 and vsh != vreq:
        warnings.warn(
            f"marker set {name}: vshards={vreq} does not divide the block count "
            f"nb={nb}; using the largest divisor V={vsh}.", stacklevel=3)
    return vsh


def _packed_rows(md, name, device):
    """The marker set's (p, q) uint8 packed rows on `device`."""
    if md.packed:
        return torch.as_tensor(md.genotypes, device=device)
    g = np.asarray(md.genotypes)
    if not (g.dtype == np.int8 and g.min() >= 0 and g.max() <= 3):
        raise NotImplementedError(
            f"marker set {name}: the port stores genotypes 2-bit packed only, which "
            "needs int8 dosages in 0..3")
    return torch.as_tensor(pack2.pack2_np(g), device=device)


_GRAM_CHUNK = 16  # blocks unpacked at a time while building the Grams


def _centered_grams(mt_blocks, center_blocks, n, dtype):
    """Centered Gram blocks (nb, B, B) from packed (nb, B, q) rows. TF32 is turned
    off for the products: it would put ~1e-3 relative error into every
    Gram entry and so into every conditional."""
    out = torch.empty(mt_blocks.shape[:2] + (mt_blocks.shape[1],), dtype=dtype,
                      device=mt_blocks.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(0, mt_blocks.shape[0], _GRAM_CHUNK):
            sl = slice(i, i + _GRAM_CHUNK)
            mcb = pack2.unpack2(mt_blocks[sl], dtype)[..., :n] - center_blocks[sl, :, None]
            out[sl] = torch.bmm(mcb, mcb.transpose(1, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out


def _build_marker(term: MarkerTerm, block, dtype, device, vshards):
    md, prior = term.data, term.prior
    if not isinstance(prior, P.BayesR):
        raise NotImplementedError(
            f"marker set {term.name}: prior {type(prior).__name__} is not ported yet "
            "(the port carries BayesR)")
    n, p = md.n_ind, md.n_snp
    block = min(block, max(8, 1 << (p - 1).bit_length()))  # don't over-pad tiny sets
    p_pad = cdiv(p, block) * block
    nb = p_pad // block
    V = _resolve_vshards(vshards, nb, term.name)
    T = nb // V
    pad = p_pad - p

    rows = _packed_rows(md, term.name, device)
    q = rows.shape[1]
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, q))])
    # global block g = v*T + t  ->  storage (t, v)
    mt = rows.reshape(V, T, block, q).transpose(0, 1).contiguous()
    center = torch.as_tensor(md.center, device=device).to(dtype)
    if pad:
        center = torch.cat([center, center.new_zeros(pad)])
    center_tv = center.reshape(V, T, block).transpose(0, 1).contiguous()

    gram_flat = _centered_grams(mt.view(T * V, block, q), center_tv.view(T * V, block), n, dtype)
    gram = gram_flat.view(T, V, block, block).permute(0, 2, 1, 3).contiguous()  # (T, B, V, B)
    mpm = torch.diagonal(gram_flat, dim1=1, dim2=2).reshape(T, V, block).transpose(0, 1)

    mask = torch.zeros(p_pad, dtype=torch.bool, device=device)
    mask[:p] = True
    df = 4.0  # 3 + dim(v) for a scalar v (mme.jl:264-272)
    v0 = float(prior.v)
    pi = np.asarray(prior.pi, dtype=np.float64)
    v_class = np.asarray(prior.class_, dtype=np.float64)

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    ms = MarkerState(
        mt=mt,
        center=center_tv,
        gram=gram,
        mpm=mpm.reshape(nb, block).contiguous(),
        lhs_ss=torch.zeros((nb, block), dtype=dtype, device=device),
        rhs_ss=torch.zeros((nb, block), dtype=dtype, device=device),
        mask=mask.reshape(nb, block),
        region_id=torch.zeros(p_pad, dtype=torch.int32, device=device),
        beta=torch.zeros(p_pad, dtype=dtype, device=device),
        delta=torch.ones(p_pad, dtype=torch.int32, device=device),
        var_beta=dev([v0]),
        scale=dev(v0 * (df - 2.0) / df),
        log_pi=dev(np.log(pi)),
        pi_hat=dev(pi),
        v_class=dev(v_class),
    )
    mp = MarkerPlan(
        name=term.name, method=METHOD_R, p=p, p_pad=p_pad, block=block, n_blocks=nb,
        n_classes=len(v_class), est_pi=bool(prior.estimatePi), df=df, vshards=V,
    )
    return ms, mp


def assemble(spec: ModelSpec, dtype=None, device=None, block_size=None, vshards=1):
    """Build (SweepPlan, ModelState) from a validated ModelSpec.

    device: where the state lives and the sweep runs (default CUDA when
    present). dtype: default float32 on CUDA, float64 on the CPU.
    vshards: V > 1 advances V marker blocks per block-step (the schedule a
    V-device run would use); the chain then differs from the V=1 order by
    design. A V that does not divide the block count falls back to its
    largest divisor with a warning. "auto" raises: the H100 value has not
    been measured.
    """
    spec.validate()
    device = torch.device(device) if device is not None else default_device()
    dtype = dtype or default_dtype(device)
    for t in spec.random:
        raise NotImplementedError(f"random term {t.name}: random effects are not ported yet")
    for t in spec.corr_markers:
        raise NotImplementedError(f"correlated marker sets {t.names}: not ported yet")
    if spec.summary_stats:
        raise NotImplementedError(
            f"summary statistics on {list(spec.summary_stats)}: not ported yet")

    y = np.asarray(spec.y, dtype=np.float64).ravel()
    res_prior = spec.residual or P.RandomEffect("I", 100.0)
    if not isinstance(res_prior.str_, str) or res_prior.str_ != "I":
        raise NotImplementedError(
            "residual: only the 'I' structure is ported; weighted ('D') residuals are not yet")
    e_df = 4.0
    ev = float(res_prior.v)
    e_scale = 0.0005 if ev == 0.0 else ev * (e_df - 2.0) / e_df

    fixed_states, fixed_plans = [], []
    blocked = set()
    by_name = {t.name: t for t in spec.fixed}
    for blk in spec.blocks:
        st, fp = _build_fixed([by_name[nm].matrix() for nm in blk], tuple(blk), dtype, device)
        fixed_states.append(st)
        fixed_plans.append(fp)
        blocked.update(blk)
    for t in spec.fixed:
        if t.name not in blocked:
            st, fp = _build_fixed([t.matrix()], t.name, dtype, device)
            fixed_states.append(st)
            fixed_plans.append(fp)

    marker_states, marker_plans = [], []
    for t in spec.markers:
        st, mp = _build_marker(t, block_size or spec.block_size, dtype, device, vshards)
        marker_states.append(st)
        marker_plans.append(mp)

    y_dev = torch.as_tensor(y, dtype=dtype, device=device)
    state = ModelState(
        y=y_dev,
        ycorr=y_dev.clone(),
        e=ResidualState(
            scale=torch.tensor(e_scale, dtype=dtype, device=device),
            var_e=torch.tensor(ev if ev > 0 else 0.0005, dtype=dtype, device=device),
        ),
        fixed=tuple(fixed_states),
        markers=tuple(marker_states),
        sweep_index=0,
    )
    plan = SweepPlan(n=y.size, e_df=e_df, fixed=tuple(fixed_plans),
                     markers=tuple(marker_plans), dtype=dtype, device=device)
    return plan, state
