"""Genotype ingestion: dosage array or packed rows -> MarkerData.

Copies of `nextgp_tpu.data.ingest.MarkerData`, `from_array` and
`from_packed` with the same fields and defaults. Dosages stay raw integers
(int8) with a float64 center vector; centering is applied algebraically by
the planner and the kernels. `from_packed` also takes a torch tensor (for
instance packed on the card), which `assemble` then lays out without a
trip through the host.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class MarkerData:
    """Host- or device-side marker set. genotypes int8 (nInd, nSNP), center
    (nSNP,).

    packed=True means genotypes holds 2-bit planar-packed rows instead:
    (nSNP, q) uint8 with q = ops.pack2.packed_q(nInd) (see ops/pack2.py).
    """

    genotypes: np.ndarray
    center: np.ndarray
    snp_ids: list
    chr_ids: Optional[np.ndarray] = None
    sample_ids: Optional[list] = None
    packed: bool = False
    packed_n_ind: Optional[int] = None

    @property
    def n_ind(self) -> int:
        return self.packed_n_ind if self.packed else self.genotypes.shape[0]

    @property
    def n_snp(self) -> int:
        return self.genotypes.shape[0] if self.packed else self.genotypes.shape[1]


def from_array(m, snp_ids=None, chr_ids=None, drop_missing=True) -> MarkerData:
    """Build a MarkerData from an (nInd, nSNP) dosage array. NaN entries mark
    missing; columns with any missing value are dropped (prepMatVec.jl:118)."""
    m = np.asarray(m, dtype=np.float64)
    p0 = m.shape[1]
    keep = np.ones(p0, dtype=bool)
    if drop_missing:
        keep = ~np.isnan(m).any(axis=0)
    m = m[:, keep]
    if snp_ids is None:
        snp_ids = [f"M{i + 1}" for i in range(p0)]
    snp_ids = [s for s, k in zip(snp_ids, keep) if k]
    if chr_ids is not None:
        chr_ids = np.asarray(chr_ids)[keep]
    center = m.mean(axis=0)
    g = m.astype(np.int8)
    if not np.array_equal(g.astype(np.float64), m):
        raise ValueError("genotypes must be integer dosages (0/1/2)")
    return MarkerData(genotypes=g, center=center, snp_ids=snp_ids, chr_ids=chr_ids)


def from_packed(pk, n_ind: int, center, snp_ids=None, chr_ids=None) -> MarkerData:
    """MarkerData over already 2-bit-packed genotype rows.

    pk: (nSNP, q) uint8 planar-packed (ops/pack2.py layout, q =
    packed_q(n_ind)), a numpy array or a torch tensor on any device;
    center: (nSNP,) column means of the unpacked dosages, numpy or torch.
    `assemble` lays the rows out as its storage without unpacking them.
    """
    from ..ops import pack2

    q_want = pack2.packed_q(n_ind)
    dtype_ok = pk.dtype == (torch.uint8 if isinstance(pk, torch.Tensor) else np.uint8)
    if not dtype_ok or pk.ndim != 2 or pk.shape[1] != q_want:
        raise ValueError(
            f"packed rows must be (nSNP, {q_want}) uint8 for n_ind={n_ind}; "
            f"got {tuple(pk.shape)} {pk.dtype}"
        )
    p = pk.shape[0]
    if not isinstance(center, torch.Tensor):
        center = np.asarray(center, np.float64)
    if snp_ids is None:
        snp_ids = [f"M{i + 1}" for i in range(p)]
    return MarkerData(
        genotypes=pk, center=center, snp_ids=list(snp_ids), chr_ids=chr_ids,
        packed=True, packed_n_ind=int(n_ind),
    )
