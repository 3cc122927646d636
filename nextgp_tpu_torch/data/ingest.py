"""Genotype ingestion: file, array, tensor or packed rows -> MarkerData.

Copies of `nextgp_tpu.data.ingest` (`MarkerData`, `from_array`,
`from_float_array`, `from_device_array`, `from_packed`,
`read_genotype_file`, `read_plink`, `read_map_file`) with the same fields,
defaults and results. Dosages stay raw integers (int8) with a float64
center vector; centering is applied algebraically by the planner and the
kernels. Fractional (imputed) dosages stay float (`from_float_array`), and
the planner stores them unpacked. `from_device_array` and `from_packed`
take torch tensors (for instance on the card), which `assemble` lays out
without a trip through the host.

The JAX package parses text and .bed files in a native C++ library when it
is built, and in Python otherwise; the port does the same work in
vectorised numpy (`_parse_text`, `_bed_decode_numpy`) and gives the
results of the native path: the int8 dosages with the column sums' centre,
NA / na / . / NaN / -1 as missing, and the float reader for any other
token (fractional dosages).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class MarkerData:
    """Host- or device-side marker set. genotypes int8 (nInd, nSNP) (or
    float for fractional dosages), center (nSNP,).

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

    def centered(self, dtype=np.float64) -> np.ndarray:
        """Dense centered marker matrix (what the reference stores), on the
        host."""
        g, center = _host(self.genotypes), _host(self.center)
        if self.packed:
            from ..ops import pack2

            g = pack2.unpack2(torch.from_numpy(g), torch.float64).numpy().T[: self.n_ind]
            return g.astype(dtype) - center.astype(dtype)[None, :]
        return g.astype(dtype) - center.astype(dtype)[None, :]


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


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
        raise ValueError(
            "genotypes must be integer dosages (0/1/2); use from_float_array "
            "for arbitrary real-valued covariate panels"
        )
    return MarkerData(genotypes=g, center=center, snp_ids=snp_ids, chr_ids=chr_ids)


def from_float_array(m, snp_ids=None, chr_ids=None) -> MarkerData:
    """Arbitrary real-valued marker panel (e.g. imputed dosages): a float64
    genotype matrix on the host, centre the column mean. `assemble` stores
    it unpacked in the engine dtype (float32 on the card)."""
    m = np.asarray(m, dtype=np.float64)
    if snp_ids is None:
        snp_ids = [f"M{i + 1}" for i in range(m.shape[1])]
    center = m.mean(axis=0, dtype=np.float64)
    return MarkerData(genotypes=m, center=center, snp_ids=list(snp_ids), chr_ids=chr_ids)


def _finish_int8(g, col_sum, col_n, snp_ids=None, chr_ids=None, drop_missing=True) -> MarkerData:
    """Shared tail of the readers: drop missing-containing columns
    (prepMatVec.jl:118) and compute centers from the column sums."""
    n, p0 = g.shape
    keep = col_n == n if drop_missing else np.ones(p0, bool)
    g = np.ascontiguousarray(g[:, keep])
    center = col_sum[keep] / np.maximum(col_n[keep], 1)
    if snp_ids is None:
        snp_ids = [f"M{i + 1}" for i in range(p0)]
    snp_ids = [s for s, k in zip(snp_ids, keep) if k]
    if chr_ids is not None:
        chr_ids = np.asarray(chr_ids)[keep]
    return MarkerData(genotypes=g, center=center, snp_ids=snp_ids, chr_ids=chr_ids)


def from_device_array(g, snp_ids=None, chr_ids=None) -> MarkerData:
    """MarkerData over a dosage tensor (nInd, nSNP) on any device, e.g. a
    panel simulated on the card; the centre is a float64 column mean taken
    on the tensor's device, a chunk of columns at a time, so that no float64
    copy of the whole panel is made. `assemble` lays the tensor out (and
    packs it, where it can) on its device."""
    g = torch.as_tensor(g)
    center = torch.empty(g.shape[1], dtype=torch.float64, device=g.device)
    step = max(1, (1 << 27) // max(1, g.shape[0]))  # ~1 GiB of float64 a chunk
    for j in range(0, g.shape[1], step):
        center[j:j + step] = g[:, j:j + step].to(torch.float64).mean(dim=0)
    if snp_ids is None:
        snp_ids = [f"M{i + 1}" for i in range(g.shape[1])]
    return MarkerData(genotypes=g, center=center, snp_ids=list(snp_ids), chr_ids=chr_ids)


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


_DELIMS = b" \t,\r"
_MISSING = {b"na", b".", b"nan", b"-1"}  # the native parser's missing tokens (any case)


def _digit_table(data: bytes):
    """The fast case of a text panel: every token one digit. Returns the
    (n, p) int8 dosages, or None when the file is not of that form."""
    raw = np.frombuffer(data, np.uint8)
    delim = np.zeros(256, bool)
    delim[list(_DELIMS)] = True
    is_nl = raw == ord("\n")
    is_tok = ~(delim[raw] | is_nl)
    prev = np.concatenate([[False], is_tok[:-1]])
    nxt = np.concatenate([is_tok[1:], [False]])
    starts = np.flatnonzero(is_tok & ~prev)
    if starts.size == 0 or np.any(nxt[starts]):
        return None  # a token longer than one byte
    vals = raw[starts]
    if np.any((vals < ord("0")) | (vals > ord("9"))):
        return None
    line = np.cumsum(is_nl)[starts]  # the line each token sits on
    _, counts = np.unique(line, return_counts=True)
    if counts.size == 0 or np.any(counts != counts[0]):
        raise ValueError("ragged rows in genotype file")
    return (vals - ord("0")).astype(np.int8).reshape(counts.size, counts[0])


def _parse_text(path: str):
    """(tokens (n, p) as bytes, or int8 dosages) of a delimited headerless
    genotype file."""
    with open(path, "rb") as fh:
        data = fh.read()
    fast = _digit_table(data)
    if fast is not None:
        return None, fast
    rows = [ln.replace(b",", b" ").split() for ln in data.splitlines()]
    rows = [r for r in rows if r]
    if not rows or any(len(r) != len(rows[0]) for r in rows):
        raise ValueError(f"ragged rows in genotype file {path!r}")
    return np.array(rows, dtype=bytes), None


def _int_tokens(tok: np.ndarray):
    """The native parser's integer path: (int8 dosages with -1 missing), or
    None when a token is neither missing nor an integer in 0..127 (an
    optional fraction of zeros allowed)."""
    low = np.char.lower(tok)
    missing = np.isin(low, list(_MISSING))
    whole = np.char.partition(tok, b".")
    head, dot, frac = whole[..., 0], whole[..., 1], whole[..., 2]
    ok = np.char.isdigit(head) & (np.char.str_len(head) <= 3)
    ok &= (dot == b"") | (np.char.str_len(np.char.strip(frac, b"0")) == 0)
    if not np.all(ok | missing):
        return None
    val = np.where(missing, b"-1", np.where(ok, head, b"0")).astype(np.int64)
    if np.any(val > 127):
        return None
    return val.astype(np.int8)


def read_genotype_file(path: str, delim: str = " ", drop_missing=True) -> MarkerData:
    """Space-delimited headerless genotype file (prepMatVec.jl:116); commas
    and tabs are delimiters too, as in the JAX package's parser.

    Integer dosages give an int8 MarkerData (missing NA / na / . / NaN /
    -1; with drop_missing their columns are dropped, else kept as -1 and
    left out of the centre). A file with fractional dosages goes to the
    float reader: a float MarkerData over the columns without a missing
    value (the reference accepts any real-valued genotype file and stores
    centered floats, prepMatVec.jl:129)."""
    tok, g = _parse_text(path)
    if g is None:
        g = _int_tokens(tok)
    if g is not None:
        ok = g >= 0
        col_sum = np.where(ok, g, 0).sum(axis=0, dtype=np.float64)
        return _finish_int8(g, col_sum, ok.sum(axis=0).astype(np.int64), drop_missing=drop_missing)
    low = np.char.lower(tok)
    m = np.where(np.isin(low, [b"na", b".", b"nan"]), b"nan", tok).astype(np.float64)
    keep = ~np.isnan(m).any(axis=0) if drop_missing else np.ones(m.shape[1], bool)
    mk = m[:, keep]
    if np.array_equal(mk, np.round(mk)) and 0 <= mk.min() and mk.max() <= 127:
        return from_array(m, drop_missing=drop_missing)
    return from_float_array(mk, snp_ids=[f"M{i + 1}" for i in np.flatnonzero(keep)])


# a .bed byte -> its four dosages (2-bit fields, little-endian within the
# byte): 00 hom-A1 -> 2, 01 missing -> -1, 10 het -> 1, 11 hom-A2 -> 0
_BED_BYTE = np.array([2, -1, 1, 0], np.int8)[(np.arange(256)[:, None] >> (2 * np.arange(4))) & 3]


def _bed_decode_numpy(path: str, n: int, p: int):
    """Pure-NumPy PLINK .bed decode (SNP-major v1.0): a byte's four dosages
    from one table lookup, 256 loci at a time. Returns (int8 (n, p) with -1
    missing, column sums and counts of the calls)."""
    raw = np.fromfile(path, dtype=np.uint8)
    if raw.size < 3 or raw[0] != 0x6C or raw[1] != 0x1B or raw[2] != 0x01:
        raise ValueError(f"{path!r}: bad .bed magic (need SNP-major v1.0)")
    bps = (n + 3) // 4
    body = raw[3: 3 + bps * p].reshape(p, bps)
    g = np.empty((n, p), np.int8)
    col_sum = np.empty(p, np.float64)
    col_n = np.empty(p, np.int64)
    for j in range(0, p, 256):
        gj = _BED_BYTE[body[j:j + 256]].reshape(-1, 4 * bps)[:, :n]  # (loci, n)
        missing = np.count_nonzero(gj < 0, axis=1)
        col_sum[j:j + 256] = gj.sum(axis=1, dtype=np.int64) + missing  # a missing call is -1
        col_n[j:j + 256] = n - missing
        g[:, j:j + 256] = gj.T
    return g, col_sum, col_n


def read_plink(prefix: str, drop_missing=True) -> MarkerData:
    """PLINK binary fileset `prefix`.bed/.bim/.fam -> MarkerData (dosage of
    the A1 allele). An ingestion format the reference lacks; at 600k-SNP
    scale .bed is ~25x smaller than the text format of prepMatVec.jl:116."""
    with open(prefix + ".fam") as fh:
        fam = [ln.split() for ln in fh if ln.strip()]
    with open(prefix + ".bim") as fh:
        bim = [ln.split() for ln in fh if ln.strip()]
    n, p = len(fam), len(bim)
    snp_ids = [r[1] for r in bim]
    chr_raw = [r[0] for r in bim]
    try:
        chr_ids = np.asarray([int(c) for c in chr_raw])
    except ValueError:
        _, chr_ids = np.unique(chr_raw, return_inverse=True)
    g, col_sum, col_n = _bed_decode_numpy(prefix + ".bed", n, p)
    md = _finish_int8(g, col_sum, col_n, snp_ids, chr_ids, drop_missing)
    md.sample_ids = [r[1] for r in fam]
    return md


def read_map_file(path: str):
    """Map file with header `snpID,snpOrder,chrID` (misc.jl:167 expects these
    columns; commas or whitespace accepted). Returns (snp_ids, chr_ids)."""
    snp_ids, chr_ids = [], []
    with open(path) as fh:
        header = fh.readline().replace(",", " ").split()
        cols = {c: i for i, c in enumerate(header)}
        for line in fh:
            parts = line.replace(",", " ").split()
            if not parts:
                continue
            snp_ids.append(parts[cols.get("snpID", 0)])
            chr_ids.append(int(float(parts[cols.get("chrID", 2)])))
    return snp_ids, np.asarray(chr_ids)
