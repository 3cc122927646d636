"""The port's genotype readers against the JAX package's, on files written in
tmp_path.

`read_genotype_file` on an integer file, a file with missing tokens (NA,
".", NaN), a fractional (imputed) file and a comma-separated one, with
drop_missing on and off; `read_plink` on a .bed/.bim/.fam set written by a
numpy encoder (missing calls and string chromosomes included);
`read_map_file`; `from_float_array`; and `from_device_array` on a CPU
tensor against the JAX function on the same array with x64 on. The
dosages, ids and maps are equal and the centres within 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nextgp_tpu.data import ingest as J
from nextgp_tpu_torch.data import ingest as T

N, P = 37, 23  # odd sizes: the .bed rows' last byte is partly padding


def _assert_same(t, j):
    gt, gj = np.asarray(t.genotypes), np.asarray(j.genotypes)
    assert gt.dtype == gj.dtype and gt.shape == gj.shape
    np.testing.assert_array_equal(gt, gj)
    np.testing.assert_allclose(np.asarray(t.center), np.asarray(j.center), rtol=1e-12, atol=1e-12)
    assert list(t.snp_ids) == list(j.snp_ids)
    assert (t.chr_ids is None) == (j.chr_ids is None)
    if j.chr_ids is not None:
        np.testing.assert_array_equal(t.chr_ids, j.chr_ids)
    assert t.sample_ids == j.sample_ids and t.packed == j.packed


def _write(path, rows, sep=" "):
    path.write_text("".join(sep.join(r) + "\n" for r in rows))
    return str(path)


def _dosages(seed=70):
    return np.random.default_rng(seed).integers(0, 3, (N, P))


def _text_file(tmp_path, kind):
    g = _dosages().astype("U24")
    if kind in ("missing", "fractional"):
        for (i, j), tok in zip([(3, 4), (7, 1), (2, 2), (30, 9)], ["NA", ".", "NaN", "nan"]):
            g[i, j] = tok
    if kind == "fractional":
        rng = np.random.default_rng(71)
        for i, j in zip(rng.integers(0, N, 20), rng.integers(0, P, 20)):
            g[i, j] = repr(float(rng.uniform(0, 2)))
    if kind == "dotted":
        g[5, 5], g[6, 6] = "1.0", "2.00"
    sep = "," if kind == "comma" else " "
    return _write(tmp_path / f"{kind}.txt", g.tolist(), sep)


@pytest.mark.parametrize("drop_missing", [True, False], ids=["drop", "keep"])
@pytest.mark.parametrize("kind", ["integer", "missing", "fractional", "comma", "dotted"])
def test_read_genotype_file_matches(tmp_path, kind, drop_missing):
    path = _text_file(tmp_path, kind)
    t = T.read_genotype_file(path, drop_missing=drop_missing)
    j = J.read_genotype_file(path, drop_missing=drop_missing)
    if kind == "fractional" and not drop_missing:  # NaN columns kept: NaN centres in both
        np.testing.assert_array_equal(np.isnan(t.center), np.isnan(j.center))
        ok = ~np.isnan(j.center)
        np.testing.assert_allclose(t.center[ok], j.center[ok], rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(t.genotypes, j.genotypes)
        return
    _assert_same(t, j)
    assert t.genotypes.dtype == (np.float64 if kind == "fractional" else np.int8)
    if kind == "missing" and drop_missing:
        assert t.n_snp == P - 4


def test_ragged_file_raises(tmp_path):
    path = _write(tmp_path / "ragged.txt", [["0", "1", "2"], ["1", "1"]])
    with pytest.raises(ValueError, match="ragged"):
        T.read_genotype_file(path)


def _bed_encode(g, path):
    """SNP-major PLINK .bed v1.0: 2-bit codes, little-endian within a byte;
    dosage 2 -> 00, missing (-1) -> 01, 1 -> 10, 0 -> 11."""
    n, p = g.shape
    code = np.select([g == 2, g < 0, g == 1], [0, 1, 2], 3).astype(np.uint8)
    bps = (n + 3) // 4
    pad = np.zeros((p, 4 * bps), np.uint8)
    pad[:, :n] = code.T
    f = pad.reshape(p, bps, 4)
    body = f[..., 0] | (f[..., 1] << 2) | (f[..., 2] << 4) | (f[..., 3] << 6)
    path.write_bytes(bytes([0x6C, 0x1B, 0x01]) + body.astype(np.uint8).tobytes())


@pytest.mark.parametrize("drop_missing", [True, False], ids=["drop", "keep"])
@pytest.mark.parametrize("chrom", ["numeric", "named"])
def test_read_plink_matches(tmp_path, chrom, drop_missing):
    g = _dosages(72).astype(np.int8)
    g[4, 3] = g[11, 17] = -1  # two missing calls
    prefix = tmp_path / "panel"
    _bed_encode(g, tmp_path / "panel.bed")
    chroms = [str(1 + i // 8) if chrom == "numeric" else ("X", "Y", "MT")[i % 3] for i in range(P)]
    (tmp_path / "panel.bim").write_text("".join(
        f"{c}\trs{i}\t0\t{1000 * i}\tA\tG\n" for i, c in enumerate(chroms)))
    (tmp_path / "panel.fam").write_text("".join(f"F{i} I{i} 0 0 1 -9\n" for i in range(N)))
    t = T.read_plink(str(prefix), drop_missing=drop_missing)
    j = J.read_plink(str(prefix), drop_missing=drop_missing)
    _assert_same(t, j)
    assert t.sample_ids == [f"I{i}" for i in range(N)]
    assert t.n_snp == (P - 2 if drop_missing else P)
    keep = [k for k in range(P) if not drop_missing or k not in (3, 17)]
    np.testing.assert_array_equal(t.genotypes, g[:, keep])


def test_bed_magic_is_checked(tmp_path):
    (tmp_path / "bad.bed").write_bytes(bytes([0x6C, 0x1B, 0x00, 0, 0]))
    with pytest.raises(ValueError, match="bad .bed magic"):
        T._bed_decode_numpy(str(tmp_path / "bad.bed"), 4, 2)


@pytest.mark.parametrize("sep", [",", " "])
def test_read_map_file_matches(tmp_path, sep):
    path = tmp_path / "chip.map"
    path.write_text(sep.join(["snpID", "snpOrder", "chrID"]) + "\n" + "".join(
        sep.join([f"s{i}", str(i + 1), f"{1 + i // 5}.0" if i % 2 else str(1 + i // 5)]) + "\n"
        for i in range(12)))
    ids_t, chr_t = T.read_map_file(str(path))
    ids_j, chr_j = J.read_map_file(str(path))
    assert ids_t == ids_j
    np.testing.assert_array_equal(chr_t, chr_j)


def test_from_float_array_matches():
    m = np.random.default_rng(73).uniform(0, 2, (N, P))
    chr_ids = np.arange(P) % 3
    _assert_same(T.from_float_array(m, chr_ids=chr_ids), J.from_float_array(m, chr_ids=chr_ids))


@pytest.mark.parametrize("dtype", ["int8", "float32"])
def test_from_device_array_matches(dtype):
    """The JAX function under x64 takes a float64 centre; the port's is a
    float64 mean on the tensor's device (a CPU tensor here)."""
    g = _dosages(74).astype(dtype)
    t = T.from_device_array(torch.from_numpy(g))
    j = J.from_device_array(jnp.asarray(g))
    assert isinstance(t.genotypes, torch.Tensor) and t.center.dtype == torch.float64
    assert np.asarray(j.center).dtype == np.float64
    np.testing.assert_array_equal(t.genotypes.numpy(), np.asarray(j.genotypes))
    np.testing.assert_allclose(t.center.numpy(), np.asarray(j.center), rtol=1e-12, atol=1e-12)
    assert t.snp_ids == j.snp_ids


def test_centered_matches():
    m = np.random.default_rng(75).uniform(0, 2, (N, P))
    np.testing.assert_allclose(T.from_float_array(m).centered(), J.from_float_array(m).centered(),
                               rtol=1e-12, atol=1e-12)
    g = _dosages(76)
    np.testing.assert_array_equal(T.from_array(g).centered(), J.from_array(g).centered())
    from nextgp_tpu_torch.ops import pack2

    pk = pack2.pack2_np(g.astype(np.int8))
    np.testing.assert_array_equal(T.from_packed(pk, N, g.mean(0)).centered(),
                                  J.from_packed(pk, N, g.mean(0)).centered())
