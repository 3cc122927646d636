"""The Gibbs state as frozen dataclasses of tensors.

Counterparts of the pytrees in `nextgp_tpu/engine/state.py`, with the same
field names, for the terms the port carries: residual (plain or weighted),
fixed blocks, random effects (dense for the per-level scan, sparse for the
CG sampler, and correlated groups), marker sets of all seven methods and
correlated marker sets. A sweep returns a new state
(`utils.replace`). A field that the JAX state leaves None for a model is
None here too.

Marker storage has one layout for every V (V=1 included), with
T = n_blocks / V block-steps and global block g = v*T + t:
    mt       (T, V, B, q) uint8, 2-bit planar-packed rows, or (T, V, B, n)
             int8 or float (the engine dtype) dosages
    center   (T, V, B)
    gram     (T, B, V, B) centered (weighted) Gram blocks, locus-major
    gram_raw (T, B, V, B) unweighted Gram blocks, weighted models only
The JAX package stores V=1 as (nb, B, q) / (nb, B) / (nb, B, B); those are
the same bytes, and `state_from_numpy` reshapes them.

Correlated marker sets (nT sets of one panel's loci) keep one row per
(locus, set), so that a block-step's V * B * nT rows are one contiguous
step of the packed passes, and the Gram in the layout the correlated
block scan (CM1) reads:
    mt       (T, V, B, nT, q) uint8, or (T, V, B, nT, n) int8 or float
    center   (T, V, B, nT)
    gram     (T, B, nT, V, B, nT): gram[t, j, u, v, k, w] = <Mc[j, u], Mc[k, w]>
             of global block g = v*T + t
The JAX package's (nb, B, nT, q), (nb, B, nT) and (nb, B, B, nT, nT) in
global block order are laid out so by `state_from_numpy`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FixedState:
    x: torch.Tensor  # (n, k)
    xp: torch.Tensor  # (k, n) = X' or (X .* d_inv)' when weighted
    xpx: torch.Tensor  # (k, k) = xp @ X, ridge-jittered when k > 1
    lhs_ss: torch.Tensor  # (k,) summary-statistic offsets 1/v (single columns use them)
    rhs_ss: torch.Tensor  # (k,) m/v
    b: torch.Tensor  # (k,)


@dataclasses.dataclass(frozen=True)
class RandomState:
    """Uncorrelated random effect for the per-level scan (mme.jl:170-204)."""

    z: torch.Tensor  # (n, q)
    zp: torch.Tensor  # (q, n) = Z' or (Z .* d_inv)' when the residual is weighted
    zpz: torch.Tensor  # (q,) diag of zp @ Z
    ivstr: torch.Tensor  # (q, q) inverse structure (I, A^-1, G^-1, user^-1)
    u: torch.Tensor  # (q,)
    var_u: torch.Tensor  # ()
    scale: torch.Tensor  # ()


@dataclasses.dataclass(frozen=True)
class SparseRandomState:
    """Uncorrelated random effect for the CG sampler, for large level counts:
    the one-hot incidence as a level index per record, A^-1 as fixed-width
    padded rows, and the Henderson factor (I-P)' D^-1/2 for exact N(0, A^-1)
    draws. No dense (n, q) or (q, q) array."""

    z_idx: torch.Tensor  # (n,) int32 level of each record, -1 = none
    iv_idx: torch.Tensor  # (q, K) int32 padded inverse-structure rows
    iv_val: torch.Tensor  # (q, K)
    fac_sire: torch.Tensor  # (q,) int32, -1 = unknown
    fac_dam: torch.Tensor  # (q,) int32
    fac_dsqrt: torch.Tensor  # (q,) D^-1/2 of the Henderson factorization
    u: torch.Tensor  # (q,)
    var_u: torch.Tensor  # ()
    scale: torch.Tensor  # ()


@dataclasses.dataclass(frozen=True)
class CorrRandomState:
    """A correlated random group (NextGP.jl's tuple key, mme.jl:207-239;
    samplers functions.jl:75-110): nT effects per level with a joint
    (nT, nT) covariance."""

    zs: torch.Tensor  # (nT, n, q) stacked component incidences
    zpz: torch.Tensor  # (q, nT, nT) per-level cross-products
    ivstr: torch.Tensor  # (q, q) inverse structure
    u: torch.Tensor  # (nT, q)
    var_u: torch.Tensor  # (nT, nT)
    scale: torch.Tensor  # (nT, nT)


@dataclasses.dataclass(frozen=True)
class MarkerState:
    """One marker set. B = block size, nb = n_blocks."""

    mt: torch.Tensor  # (T, V, B, q) uint8 packed, or (T, V, B, n) int8 or float
    center: torch.Tensor  # (T, V, B)
    gram: torch.Tensor  # (T, B, V, B), weighted (Mc D^-1 Mc') when the residual is
    gram_raw: Optional[torch.Tensor]  # (T, B, V, B) Mc Mc' when weighted, else None
    mpm: torch.Tensor  # (nb, B) diag of gram, global block order
    lhs_ss: torch.Tensor  # (nb, B) summary-statistic offsets 1/v, Inf guarded to 0
    rhs_ss: torch.Tensor  # (nb, B) m/v, NaN guarded to 0
    mask: torch.Tensor  # (nb, B) bool, False on padded loci
    region_id: torch.Tensor  # (p_pad,) int32; BayesPR regions, padded loci -> n_regions
    beta: torch.Tensor  # (p_pad,)
    delta: torch.Tensor  # (p_pad,) int32: 1-based class (R), indicator (B/C)
    var_beta: torch.Tensor  # (n_var,): regions (PR), per locus (B/LV), one (C/R), annotations (RC)
    scale: torch.Tensor  # ()
    log_pi: Optional[torch.Tensor] = None  # (2,) | (K,) | (A, K); None for BayesPR/LV
    pi_hat: Optional[torch.Tensor] = None
    v_class: Optional[torch.Tensor] = None  # (K,)
    # annotation state (BayesRCpi / BayesRCplus)
    annot_input: Optional[torch.Tensor] = None  # (p_pad, A) the 0/1 annotations as floats
    annot_prob: Optional[torch.Tensor] = None  # (p_pad, A) row-normalized
    annot_nz: Optional[torch.Tensor] = None  # (p_pad, A) bool
    annot_cat: Optional[torch.Tensor] = None  # (p_pad,) int32, 1-based; 0 on padded loci
    # log-linear variance state (BayesLV, mme.jl:418-441)
    log_var: Optional[torch.Tensor] = None  # (p_pad,)
    lv_design: Optional[torch.Tensor] = None  # (p_pad, kC) variance-model design C
    lv_icpc: Optional[torch.Tensor] = None  # (kC, kC) = inv(C'C + jitter)
    lv_icpc_chol: Optional[torch.Tensor] = None  # chol(lv_icpc)
    lv_c: Optional[torch.Tensor] = None  # (kC,)
    lv_resid: Optional[torch.Tensor] = None  # (p_pad,)
    var_zeta: Optional[torch.Tensor] = None  # ()


@dataclasses.dataclass(frozen=True)
class CorrMarkerState:
    """Correlated marker sets, NextGP.jl's tuple key (M1, M2) (mme.jl:
    448-489; sampler functions.jl:140-154): per locus the nT sets' columns,
    with (nT, nT) cross-Gram blocks so that the in-block scan stays exact.
    Layouts in the module docstring."""

    mt: torch.Tensor  # (T, V, B, nT, q) uint8 2-bit planar-packed, or (T, V, B, nT, n) unpacked
    center: torch.Tensor  # (T, V, B, nT)
    gram: torch.Tensor  # (T, B, nT, V, B, nT) centered cross-Grams
    mpm: torch.Tensor  # (nb, B, nT, nT) per-locus M_l' M_l, global block order
    mask: torch.Tensor  # (nb, B) bool
    region_id: torch.Tensor  # (p_pad,) int32; padded loci -> n_regions
    beta: torch.Tensor  # (p_pad, nT)
    var_beta: torch.Tensor  # (n_regions, nT, nT)
    scale: torch.Tensor  # (nT, nT)


@dataclasses.dataclass(frozen=True)
class ResidualState:
    scale: torch.Tensor  # ()
    d_inv: Optional[torch.Tensor]  # (n,) 1/weights of a weighted residual, else None
    var_e: torch.Tensor  # () last drawn value


@dataclasses.dataclass(frozen=True)
class ModelState:
    y: torch.Tensor  # (n,)
    ycorr: torch.Tensor  # (n,) raw residual y - Xb - Mc beta, weighted or not
    e: ResidualState
    fixed: Tuple[FixedState, ...]
    random: Tuple[Union[RandomState, SparseRandomState, CorrRandomState], ...]
    markers: Tuple[MarkerState, ...]
    sweep_index: int  # host counter; names the draw sites of the next sweep
    corr_markers: Tuple[CorrMarkerState, ...]
    # the same number as a 0-d int64 tensor on the state's device: the sweep
    # a KeyedStream keys its draws on, on the card inside a captured sweep
    sweep_counter: torch.Tensor


# The fields a sweep replaces, by class: a copy of the JAX package's
# _CHAIN_FIELDS (nextgp_tpu/parallel/sharded.py:55-65), to which the
# port's ModelState adds sweep_counter. run_chains stacks them on a leading
# chain axis, and a checkpoint holds them (io/checkpoint.py).
_CHAIN_FIELDS = {
    ModelState: ("ycorr", "sweep_index", "sweep_counter"),
    ResidualState: ("var_e",),
    FixedState: ("b",),
    RandomState: ("u", "var_u"),
    SparseRandomState: ("u", "var_u"),
    CorrRandomState: ("u", "var_u"),
    MarkerState: ("beta", "delta", "var_beta", "log_pi", "pi_hat", "annot_prob",
                  "annot_cat", "log_var", "lv_c", "lv_resid", "var_zeta"),
    CorrMarkerState: ("beta", "var_beta"),
}


def chain_leaves(obj, prefix="") -> Dict[str, torch.Tensor]:
    """The tensors of `obj` (a state, or a part of one) in the fields that
    _CHAIN_FIELDS names, keyed as engine/sweep._leaves keys them
    ("markers.0.beta.", ...); None fields and sweep_index (a host int, or
    the chains' (C,) tensor of a batched state) left out."""
    out = {}
    if dataclasses.is_dataclass(obj):
        names = _CHAIN_FIELDS.get(type(obj), ())
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            if f.name not in names:
                out.update(chain_leaves(v, f"{prefix}{f.name}."))
            elif isinstance(v, torch.Tensor) and f.name != "sweep_index":
                out[f"{prefix}{f.name}."] = v
    elif isinstance(obj, tuple):
        for i, x in enumerate(obj):
            out.update(chain_leaves(x, f"{prefix}{i}."))
    return out


_INT_FIELDS = {"region_id": torch.int32, "delta": torch.int32,
               "mask": torch.bool, "annot_nz": torch.bool, "annot_cat": torch.int32,
               "z_idx": torch.int32, "iv_idx": torch.int32, "fac_sire": torch.int32,
               "fac_dam": torch.int32}
_MIX_FIELDS = ("log_pi", "pi_hat", "v_class")
_ANNOT_FIELDS = ("annot_input", "annot_prob", "annot_nz", "annot_cat")
_LV_FIELDS = ("log_var", "lv_design", "lv_icpc", "lv_icpc_chol", "lv_c", "lv_resid", "var_zeta")


def _none_fields(plan):
    """Keys whose field the plan leaves None (the JAX tree drops them)."""
    out = set() if plan.weighted else {"e.d_inv"}
    for i, mp in enumerate(plan.markers):
        if not mp.weighted:
            out.add(f"markers.{i}.gram_raw")
        absent = () if mp.n_classes else _MIX_FIELDS  # BayesPR/LV: no indicator probabilities
        absent += () if mp.n_annot else _ANNOT_FIELDS
        absent += () if mp.n_lv_cov else _LV_FIELDS
        out.update(f"markers.{i}.{f}" for f in absent)
    return out


def state_from_numpy(plan, arrays: Dict[str, np.ndarray]) -> ModelState:
    """Build a ModelState on plan.device from numpy arrays keyed by the JAX
    field paths ("ycorr", "e.var_e", "fixed.0.b", "random.0.u",
    "markers.0.gram", "corr_markers.0.gram", ..., "sweep_index"), for
    instance a flattened JAX ModelState. Every field
    must be given and no other, except that a field the plan leaves None
    (gram_raw and e.d_inv unweighted, log_pi/pi_hat/v_class for BayesPR and
    BayesLV, the annotation and log-variance fields of the other methods)
    must be absent; float fields take plan.dtype, and marker storage is
    laid out as the port keeps it (the module docstring)."""
    used = set()
    none = _none_fields(plan)

    def get(key, dtype=None, shape=None):
        """shape: a shape to reshape to, or a function of the tensor."""
        if key in none:
            return None
        if key not in arrays:
            raise KeyError(f"state_from_numpy: missing {key!r}")
        used.add(key)
        t = torch.tensor(np.asarray(arrays[key]))  # a copy: the arrays may be read-only
        t = t.to(device=plan.device, dtype=dtype or plan.dtype)
        if callable(shape):
            return shape(t).contiguous()
        return t.reshape(shape) if shape is not None else t

    def fields(cls, prefix, shapes=None):
        shapes = shapes or {}
        return cls(**{
            f.name: get(prefix + f.name, _INT_FIELDS.get(f.name) or _mt_dtype(f.name, prefix),
                        shapes.get(f.name))
            for f in dataclasses.fields(cls)})

    def _mt_dtype(name, prefix):
        """Marker storage keeps its own type: packed uint8, int8, or float
        rows in plan.dtype."""
        if name != "mt" or prefix + "mt" not in arrays:
            return None
        a = np.asarray(arrays[prefix + "mt"])
        return {np.dtype(np.uint8): torch.uint8, np.dtype(np.int8): torch.int8}.get(a.dtype)

    markers = []
    for i, mp in enumerate(plan.markers):
        V, B = mp.vshards, mp.block
        T = mp.n_blocks // V
        q = arrays[f"markers.{i}.mt"].shape[-1]
        markers.append(fields(MarkerState, f"markers.{i}.", {
            "mt": (T, V, B, q), "center": (T, V, B), "gram": (T, B, V, B),
            "gram_raw": (T, B, V, B)}))
    corr = []
    for i, cp in enumerate(plan.corr_markers):
        V, B, nT = cp.vshards, cp.block, cp.n_t
        T = cp.n_blocks // V

        def tv(t, V=V, T=T):  # (nb, ...) in global block order g = v*T + t -> (T, V, ...)
            return t.reshape((V, T) + t.shape[1:]).transpose(0, 1)

        def gram(t, V=V, T=T, B=B, nT=nT):  # (nb, B, B, nT, nT) -> (T, B, nT, V, B, nT)
            return t.reshape(V, T, B, B, nT, nT).permute(1, 2, 4, 0, 3, 5)

        corr.append(fields(CorrMarkerState, f"corr_markers.{i}.",
                           {"mt": tv, "center": tv, "gram": gram}))
    rand_cls = {"cg": SparseRandomState, "scan": RandomState}
    sweep_index = int(get("sweep_index", torch.int64))
    state = ModelState(
        y=get("y"),
        ycorr=get("ycorr"),
        e=fields(ResidualState, "e."),
        fixed=tuple(fields(FixedState, f"fixed.{i}.") for i in range(len(plan.fixed))),
        random=tuple(fields(CorrRandomState if rp.correlated else rand_cls[rp.sampler],
                            f"random.{i}.") for i, rp in enumerate(plan.random)),
        markers=tuple(markers),
        sweep_index=sweep_index,
        corr_markers=tuple(corr),
        sweep_counter=torch.tensor(sweep_index, dtype=torch.int64, device=plan.device),
    )
    extra = set(arrays) - used
    if extra:
        raise KeyError(f"state_from_numpy: unknown fields {sorted(extra)}")
    return state
