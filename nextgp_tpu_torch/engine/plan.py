"""Planner: ModelSpec -> (static SweepPlan, ModelState on the device).

Counterpart of `nextgp_tpu/engine/plan.py:assemble` for the terms the port
carries: the residual ("I", or weighted "D" from a weight vector),
fixed-effect blocks, and BayesPR, BayesB, BayesC and BayesR marker sets
stored 2-bit planar-packed in the (T, V, B, q) layout of engine/state.py.
Defaults follow the JAX package (and NextGP.jl's mme.jl): residual df 4 and
scale v*(df-2)/df with the 0.0005 zero-variance guard; marker df 3 + 1; a
marker set without a prior is BayesPR(9999, 0.05); multi-column fixed
blocks get the ridge jitter I * min|diag| / 10000. A weighted residual
(d_inv = 1/weights) weights X'X, the Gram blocks and their diagonal mpm,
and keeps the unweighted Gram beside the weighted one. Any other term
raises NotImplementedError naming it.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..api import priors as P
from ..api.spec import MarkerTerm, ModelSpec
from ..data.regions import build_regions
from ..ops import pack2
from ..utils import cdiv, default_device, default_dtype
from .state import FixedState, MarkerState, ModelState, ResidualState

METHOD_PR = "BayesPR"
METHOD_B = "BayesB"
METHOD_C = "BayesC"
METHOD_R = "BayesR"
_NOT_PORTED = ("BayesRCpi", "BayesRCplus", "BayesLV")


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
    n_var: int  # len(var_beta)
    n_regions: int  # BayesPR region count (== n_var)
    n_classes: int  # 0 for BayesPR, 2 for B/C, K for R
    est_pi: bool
    df: float
    weighted: bool
    # V block chains advance per block-step; chain v owns the contiguous
    # blocks [v*T, (v+1)*T). V=1 is the reference-sequential order.
    vshards: int = 1
    # BayesPR's region sums without float atomics: the loci < p in a stable
    # order grouped by region, and each region's size (constant)
    region_order: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)
    region_len: Optional[torch.Tensor] = dataclasses.field(default=None, compare=False)


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    n: int
    e_df: float
    weighted: bool
    fixed: Tuple[FixedPlan, ...]
    markers: Tuple[MarkerPlan, ...]
    dtype: torch.dtype
    device: torch.device


def _build_fixed(term_mats, name, d_inv, dtype, device):
    """Cross-products + jitter for one fixed block (mme.jl:132-153)."""
    x = np.concatenate(list(term_mats), axis=1)
    k = x.shape[1]
    xp = (x * d_inv[:, None]).T if d_inv is not None else x.T
    xpx = xp @ x
    if k > 1:  # the reference jitters only a Matrix xpx (mme.jl:149-152)
        xpx = xpx + np.eye(k) * np.min(np.abs(np.diag(xpx))) / 10000.0

    def dev(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    st = FixedState(x=dev(x), xp=dev(np.ascontiguousarray(xp)), xpx=dev(xpx),
                    lhs_ss=dev(np.zeros(k)), rhs_ss=dev(np.zeros(k)), b=dev(np.zeros(k)))
    return st, FixedPlan(name=name, k=k, single=(k == 1))


def _df_for(v):
    """3 + dim(v) (mme.jl:264-272); a matrix v raised before this."""
    return 3.0 + 1.0


def _scale_for(v, df):
    """Prior scale from a scalar variance and df (mme.jl:269-271, 498-505)."""
    return float(v) * (df - 2.0) / df


def _method_of(prior, name):
    if prior is None or isinstance(prior, P.BayesPR):
        return METHOD_PR
    for cls, method in ((P.BayesB, METHOD_B), (P.BayesC, METHOD_C), (P.BayesR, METHOD_R)):
        if isinstance(prior, cls):
            return method
    kind = type(prior).__name__
    what = "is not ported yet" if kind in _NOT_PORTED else "is not a marker prior"
    raise NotImplementedError(f"marker set {name}: prior {kind} {what}")


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


def _centered_grams(mt_blocks, center_blocks, n, dtype, d_inv=None):
    """Centered Gram blocks (nb, B, B) from packed (nb, B, q) rows: returns
    (weighted (Mc*d_inv) Mc', raw Mc Mc') when d_inv (n,) is given, else
    (Mc Mc', None). TF32 is turned off for the products: it would put ~1e-3
    relative error into every Gram entry and so into every conditional."""
    out = torch.empty(mt_blocks.shape[:2] + (mt_blocks.shape[1],), dtype=dtype,
                      device=mt_blocks.device)
    raw = None if d_inv is None else torch.empty_like(out)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in range(0, mt_blocks.shape[0], _GRAM_CHUNK):
            sl = slice(i, i + _GRAM_CHUNK)
            mcb = pack2.unpack2(mt_blocks[sl], dtype)[..., :n] - center_blocks[sl, :, None]
            mct = mcb.transpose(1, 2)
            if d_inv is None:
                out[sl] = torch.bmm(mcb, mct)
            else:
                out[sl] = torch.bmm(mcb * d_inv, mct)
                raw[sl] = torch.bmm(mcb, mct)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return out, raw


def _region_segments(info, device):
    """(order, lengths) for the deterministic region sums of BayesPR: the
    loci in a stable order grouped by region, and each region's size."""
    order = np.argsort(info.region_id, kind="stable")
    return (torch.as_tensor(order, dtype=torch.int64, device=device),
            torch.as_tensor(info.sizes, dtype=torch.int64, device=device))


def _build_marker(term: MarkerTerm, d_inv, block, dtype, device, vshards):
    md, prior = term.data, term.prior
    method = _method_of(prior, term.name)
    if prior is not None and np.ndim(prior.v) > 0:
        raise NotImplementedError(
            f"marker set {term.name}: a matrix v belongs to correlated marker sets "
            "(ROADMAP M9), which are not ported yet")
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

    di = None if d_inv is None else torch.as_tensor(d_inv, dtype=dtype, device=device)
    gram_flat, raw_flat = _centered_grams(mt.view(T * V, block, q), center_tv.view(T * V, block),
                                          n, dtype, di)

    def locus_major(g):  # layout (t, v) -> (T, B, V, B)
        return g.view(T, V, block, block).permute(0, 2, 1, 3).contiguous()

    mpm = torch.diagonal(gram_flat, dim1=1, dim2=2).reshape(T, V, block).transpose(0, 1)

    # per-method region and variance bookkeeping (mme.jl:331-441)
    if prior is None:
        df, v0 = 4.0, 0.05
    else:
        df, v0 = _df_for(prior.v), float(prior.v)
    scale = _scale_for(v0, df)
    region_id = np.zeros(p_pad, np.int32)
    order = lengths = None
    log_pi = pi_hat = v_class = None
    n_classes = 0
    if method == METHOD_PR:
        info = build_regions(p, prior.r if prior is not None else 9999, md.chr_ids)
        region_id = np.concatenate([info.region_id, np.full(pad, info.n_regions, np.int32)])
        n_var = info.n_regions
        var_beta = np.full(n_var, v0)
        order, lengths = _region_segments(info, device)
    elif method == METHOD_B:
        region_id = np.arange(p_pad, dtype=np.int32)
        n_var = p_pad
        var_beta = np.zeros(p_pad)
        var_beta[:p] = v0
    else:
        n_var = 1
        var_beta = np.full(1, v0)
    if method in (METHOD_B, METHOD_C):
        log_pi = np.log(np.array([1.0 - prior.pi, prior.pi]))
        pi_hat = np.array([1.0 - prior.pi, prior.pi])
        v_class = np.array([0.0, 1.0])
        n_classes = 2
    elif method == METHOD_R:
        pi = np.asarray(prior.pi, dtype=np.float64)
        log_pi, pi_hat = np.log(pi), pi
        v_class = np.asarray(prior.class_, dtype=np.float64)
        n_classes = len(v_class)

    mask = torch.zeros(p_pad, dtype=torch.bool, device=device)
    mask[:p] = True

    def dev(a):
        return None if a is None else torch.as_tensor(a, dtype=dtype, device=device)

    ms = MarkerState(
        mt=mt,
        center=center_tv,
        gram=locus_major(gram_flat),
        gram_raw=None if raw_flat is None else locus_major(raw_flat),
        mpm=mpm.reshape(nb, block).contiguous(),
        lhs_ss=torch.zeros((nb, block), dtype=dtype, device=device),
        rhs_ss=torch.zeros((nb, block), dtype=dtype, device=device),
        mask=mask.reshape(nb, block),
        region_id=torch.as_tensor(region_id, device=device),
        beta=torch.zeros(p_pad, dtype=dtype, device=device),
        delta=torch.ones(p_pad, dtype=torch.int32, device=device),
        var_beta=dev(var_beta),
        scale=dev(scale),
        log_pi=dev(log_pi),
        pi_hat=dev(pi_hat),
        v_class=dev(v_class),
    )
    mp = MarkerPlan(
        name=term.name, method=method, p=p, p_pad=p_pad, block=block, n_blocks=nb,
        n_var=n_var, n_regions=n_var, n_classes=n_classes,
        est_pi=bool(getattr(prior, "estimatePi", False)), df=df, weighted=d_inv is not None,
        vshards=V, region_order=order, region_len=lengths,
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
    d_inv = None
    if isinstance(res_prior.str_, (list, np.ndarray)):
        d_inv = 1.0 / np.asarray(res_prior.str_, dtype=np.float64)
    elif res_prior.str_ != "I":
        raise NotImplementedError(
            f"residual: structure {res_prior.str_!r} is not ported; the port takes 'I' "
            "or a weight vector")
    e_df = 4.0
    ev = float(res_prior.v)
    e_scale = 0.0005 if ev == 0.0 else ev * (e_df - 2.0) / e_df

    fixed_states, fixed_plans = [], []
    blocked = set()
    by_name = {t.name: t for t in spec.fixed}
    for blk in spec.blocks:
        st, fp = _build_fixed([by_name[nm].matrix() for nm in blk], tuple(blk), d_inv, dtype,
                              device)
        fixed_states.append(st)
        fixed_plans.append(fp)
        blocked.update(blk)
    for t in spec.fixed:
        if t.name not in blocked:
            st, fp = _build_fixed([t.matrix()], t.name, d_inv, dtype, device)
            fixed_states.append(st)
            fixed_plans.append(fp)

    marker_states, marker_plans = [], []
    for t in spec.markers:
        st, mp = _build_marker(t, d_inv, block_size or spec.block_size, dtype, device, vshards)
        marker_states.append(st)
        marker_plans.append(mp)

    y_dev = torch.as_tensor(y, dtype=dtype, device=device)
    state = ModelState(
        y=y_dev,
        ycorr=y_dev.clone(),
        e=ResidualState(
            scale=torch.tensor(e_scale, dtype=dtype, device=device),
            d_inv=None if d_inv is None else torch.as_tensor(d_inv, dtype=dtype, device=device),
            var_e=torch.tensor(ev if ev > 0 else 0.0005, dtype=dtype, device=device),
        ),
        fixed=tuple(fixed_states),
        markers=tuple(marker_states),
        sweep_index=0,
    )
    plan = SweepPlan(n=y.size, e_df=e_df, weighted=d_inv is not None, fixed=tuple(fixed_plans),
                     markers=tuple(marker_plans), dtype=dtype, device=device)
    return plan, state
