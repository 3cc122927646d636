"""SNP region (variance-window) construction for BayesPR.

Copy of `nextgp_tpu.data.regions` (`RegionInfo`, `regions_from_sentinel`,
`regions_from_map`, `build_regions`, `write_group_info`), the semantics of NextGP.jl's
`prep2RegionData` (misc.jl:163-215) and the no-map sentinels of
`mme.getMME!` (mme.jl:334-348):

  no map, r == 1    -> every locus its own region
  no map, r == 9999 -> one whole-genome region
  no map, other     -> error
  map,  r == 99     -> one region per chromosome
  map,  r == 9999   -> one whole-genome region
  map,  other       -> windows of r SNPs within each chromosome (the last
                       window of a chromosome may be short)

The output is a per-locus region id (int32) and the region count.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class RegionInfo:
    # (p,) int32; non-decreasing for genome-ordered maps (for interleaved
    # chromosome maps, ids group by chromosome value as in the reference)
    region_id: np.ndarray
    n_regions: int

    @property
    def sizes(self) -> np.ndarray:
        return np.bincount(self.region_id, minlength=self.n_regions)


def regions_from_sentinel(n_snp: int, r: int) -> RegionInfo:
    """No-map path (mme.jl:334-344)."""
    if r == 1:
        return RegionInfo(np.arange(n_snp, dtype=np.int32), n_snp)
    if r == 9999:
        return RegionInfo(np.zeros(n_snp, dtype=np.int32), 1)
    raise ValueError("without a map file the region size must be 1 or 9999")


def regions_from_map(chr_ids, r: int) -> RegionInfo:
    """Map path (misc.jl:169-208). `chr_ids` is the per-SNP chromosome id in
    genome order."""
    chrv = np.asarray(chr_ids)
    n = len(chrv)
    if r == 9999:
        return RegionInfo(np.zeros(n, dtype=np.int32), 1)
    region = np.empty(n, dtype=np.int32)
    next_region = 0
    # one pass per chromosome value in order of first appearance, as
    # unique(chrID) in misc.jl:170/179, so interleaved chromosomes are
    # grouped rather than re-processed
    for c in dict.fromkeys(chrv.tolist()):
        idx = np.nonzero(chrv == c)[0]
        m = len(idx)
        if r == 99:
            region[idx] = next_region
            next_region += 1
        else:
            within = np.arange(m) // r
            region[idx] = next_region + within
            next_region += int(within[-1]) + 1 if m else 0
    return RegionInfo(region, next_region)


def build_regions(n_snp: int, r: int, chr_ids: Optional[np.ndarray] = None) -> RegionInfo:
    if chr_ids is None:
        return regions_from_sentinel(n_snp, r)
    if len(chr_ids) != n_snp:
        raise ValueError("map length != nSNP")
    return regions_from_map(chr_ids, r)


def write_group_info(path: str, marker_set: str, snp_ids, chr_ids, info: RegionInfo,
                     r: Optional[int] = None):
    """groupInfo_<set>.txt emission matching misc.jl:209 (tab-delimited).

    For r == 99 the reference writes the actual CHROMOSOME id as groupID
    (misc.jl:170-173), not a renumbered region index — chromosome labels
    3 and 7 emit groupID 3 and 7. Window regions write 1-based region ids
    (misc.jl:178-208)."""
    fn = os.path.join(path, f"groupInfo_{marker_set}.txt")
    with open(fn, "w") as fh:
        fh.write("snpID\tsnpOrder\tchrID\tgroupID\n")
        for i, (sid, cid) in enumerate(zip(snp_ids, chr_ids)):
            gid = cid if r == 99 else int(info.region_id[i]) + 1
            fh.write(f"{sid}\t{i + 1}\t{cid}\t{gid}\n")
    return fn
