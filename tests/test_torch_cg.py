"""The port's CG sampler solve against the JAX package's, in float64 on the CPU.

`ops/cg.cg_solve_sparse_plain` (the plain version of CG1, csrc/cg_solve.cu)
solves (z_diag / ve + K / vu) x = b over the live entries of K's padded
rows, with the plan's `z_diag` (diag(Z'D^-1 Z)) and `iv_len`. The JAX
package's `cg_solve` runs on the long form of the same system, as
`sample_random_cg` builds it (nextgp_tpu/engine/samplers/random_effects.py:
45-104): Z' (D^-1 (Z v)) by segment sums and K v over every padded slot.
The same inputs, from numpy seeds, go to both. At tol 1e-14 the solutions
agree to 1e-9 relative (the two sum in other orders, so they agree to
rounding, not to the bit); at the default tolerance the iteration counts
agree within one (where the residual crosses the threshold within rounding
of it, two orders of summation can stop one iteration apart). Cases: the
identity structure, a pedigree A^-1 whose rows have different live
lengths, weighted records, a level with no records, one level, and a solve
stopped by max_iter; the plan's z_diag and iv_len against the padded forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nextgp_tpu_torch as ngt
from nextgp_tpu.ops import cg as jcg
from nextgp_tpu_torch.data import pedigree as tped
from nextgp_tpu_torch.ops import cg as tcg

VAR_E, VAR_U = 1.3, 0.7


def _pedigree(q, seed):
    """A random pedigree of q animals (a fifth founders), listed parents
    first: rows of A^-1 from 1 entry (a founder with no offspring) to many
    (a parent of many)."""
    rng = np.random.default_rng(seed)
    ids = [f"a{i}" for i in range(q)]
    sires, dams = [None] * q, [None] * q
    for i in range(max(1, q // 5), q):
        s, d = rng.integers(0, max(1, i // 2), 2)  # parents among the first half: wide rows
        sires[i] = ids[s] if rng.uniform() > 0.1 else None
        dams[i] = ids[d] if s != d and rng.uniform() > 0.1 else None
    return tped.build_pedigree(ids, sires, dams)


def _case(kind, seed=0):
    """(z_idx, n_levels, weights or None, sparse_struct or None) of a case."""
    rng = np.random.default_rng(seed)
    if kind == "one-level":
        return np.zeros(5, np.int64), 1, None, None
    q = 60
    n = 90
    z_idx = rng.integers(0, q, n)
    z_idx[rng.uniform(size=n) < 0.1] = -1  # records of no level
    weights = rng.uniform(0.5, 2.0, n) if kind == "weighted" else None
    if kind == "empty-level":
        z_idx[z_idx == 7] = 3  # level 7 has no record
    if kind == "identity":
        return z_idx, q, weights, None
    ped = _pedigree(q, seed + 1)
    idx, val = tped.a_inverse_padded(ped)
    sire, dam, dsq = tped.a_inverse_factor(ped)
    return z_idx, q, weights, dict(iv_idx=idx, iv_val=val, sire=sire, dam=dam, dinv_sqrt=dsq)


CASES = ("identity", "pedigree", "weighted", "empty-level", "one-level")


def _assembled(kind, seed=0):
    """The port's plan and state for an intercept and the case's CG term."""
    z_idx, q, weights, ss = _case(kind, seed)
    n = z_idx.size
    y = np.random.default_rng(seed + 2).normal(size=n)
    spec = ngt.ModelSpec(
        y=y, fixed=[ngt.FixedTerm("int", np.ones(n))],
        random=[ngt.RandomTerm("a", None, prior=ngt.Random("A" if ss else "I", VAR_U, sampler="cg"),
                               z_idx=z_idx, n_levels=q, sparse_struct=ss)],
        residual=None if weights is None else ngt.RandomEffect(weights, VAR_E))
    plan, st = ngt.assemble(spec, device="cpu", dtype=torch.float64)
    return plan.random[0], st.random[0], z_idx, weights


def _system(kind, seed=0):
    """Both solvers' inputs: (the port's arguments but tol and max_iter,
    the JAX long-form matvec, b, x0)."""
    rp, rs, z_idx, weights = _assembled(kind, seed)
    q = rp.q
    rng = np.random.default_rng(seed + 3)
    b, x0 = rng.normal(size=q), rng.normal(size=q)
    d_inv = np.ones(z_idx.size) if weights is None else 1.0 / weights
    ive, ivu = 1.0 / VAR_E, 1.0 / VAR_U
    jidx = jnp.asarray(np.where(z_idx >= 0, z_idx, q))
    iv_idx, iv_val = jnp.asarray(rs.iv_idx.numpy()), jnp.asarray(rs.iv_val.numpy())

    def matvec(v):  # sample_random_cg's (random_effects.py:92-96)
        zv = jnp.asarray(d_inv) * jnp.concatenate([v, jnp.zeros((1,), v.dtype)])[jidx]
        zt = jax.ops.segment_sum(zv, jidx, num_segments=q + 1)[:q]
        return zt * ive + jnp.sum(iv_val * v[iv_idx], axis=1) * ivu

    port = (rp.z_diag * ive, rs.iv_idx, rs.iv_val, rp.iv_len, torch.tensor(ivu, dtype=torch.float64),
            torch.from_numpy(b), torch.from_numpy(x0))
    return port, matvec, b, x0


@pytest.mark.parametrize("kind", CASES)
def test_sparse_solve_matches_jax_at_a_tight_tolerance(kind):
    port, matvec, b, x0 = _system(kind)
    x, it, res = tcg.cg_solve_sparse_plain(*port, tol=1e-14, max_iter=1000)
    jx, jit_, jres = jcg.cg_solve(matvec, jnp.asarray(b), x0=jnp.asarray(x0), tol=1e-14, max_iter=1000)
    jx = np.asarray(jx)
    assert it.dtype == torch.int32 and it.shape == () and 0 < int(it) < 1000
    assert abs(int(it) - int(jit_)) <= 1
    np.testing.assert_allclose(x.numpy(), jx, rtol=0, atol=1e-9 * np.abs(jx).max())
    assert float(res) <= 1e-14 * np.linalg.norm(b) and float(jres) <= 1e-14 * np.linalg.norm(b)


@pytest.mark.parametrize("kind", CASES)
@pytest.mark.parametrize("seed", [0, 1])
def test_sparse_solve_iterations_match_jax_at_the_default_tolerance(kind, seed):
    """At the default tolerance (1e-8) the counts agree within one, and each
    solution satisfies its own stopping rule."""
    port, matvec, b, x0 = _system(kind, seed)
    x, it, res = tcg.cg_solve_sparse_plain(*port)
    _, jit_, _ = jcg.cg_solve(matvec, jnp.asarray(b), x0=jnp.asarray(x0))
    assert abs(int(it) - int(jit_)) <= 1
    assert float(res) <= 1e-8 * np.linalg.norm(b)
    resid = np.asarray(matvec(jnp.asarray(x.numpy()))) - b
    assert np.linalg.norm(resid) <= 1.01e-8 * np.linalg.norm(b)


@pytest.mark.parametrize("kind", ["identity", "pedigree"])
def test_sparse_solve_stops_at_max_iter(kind):
    """A tolerance no solve reaches: both stop at max_iter with the same x."""
    port, matvec, b, x0 = _system(kind)
    x, it, res = tcg.cg_solve_sparse_plain(*port, tol=1e-30, max_iter=3)
    jx, jit_, jres = jcg.cg_solve(matvec, jnp.asarray(b), x0=jnp.asarray(x0), tol=1e-30, max_iter=3)
    assert int(it) == int(jit_) == 3
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0, atol=1e-12 * np.abs(np.asarray(jx)).max())
    np.testing.assert_allclose(float(res), float(jres), rtol=1e-9)
    x, it, _ = tcg.cg_solve_sparse_plain(*port, tol=1e-30, max_iter=0)
    assert int(it) == 0 and torch.equal(x, port[-1])


@pytest.mark.parametrize("kind", CASES)
def test_plan_tables_match_the_padded_forms(kind):
    """iv_len: the padded rows' sums over the first iv_len entries are the
    sums over all of them, and the entry before each length is live;
    z_diag: Z'D^-1 Z of the one-hot Z, summed densely."""
    rp, rs, z_idx, weights = _assembled(kind)
    q = rp.q
    idx, val, ln = rs.iv_idx.numpy(), rs.iv_val.numpy(), rp.iv_len.numpy()
    assert rp.iv_len.dtype == torch.int32 and ln.shape == (q,) and (ln >= 1).all()
    k = np.arange(idx.shape[1])
    assert ((idx[k >= ln[:, None]] == 0) & (val[k >= ln[:, None]] == 0)).all()
    last = (idx[np.arange(q), ln - 1] != 0) | (val[np.arange(q), ln - 1] != 0)
    assert last.all()
    if kind in ("pedigree", "weighted", "empty-level"):
        assert len(set(ln.tolist())) > 2  # rows of different live lengths
    z = np.zeros((z_idx.size, q))
    z[np.flatnonzero(z_idx >= 0), z_idx[z_idx >= 0]] = 1.0
    d_inv = np.ones(z_idx.size) if weights is None else 1.0 / weights
    assert rp.z_diag.dtype == torch.float64
    np.testing.assert_allclose(rp.z_diag.numpy(), np.diag(z.T @ (d_inv[:, None] * z)), rtol=1e-15)
    if kind == "empty-level":
        assert rp.z_diag[7] == 0.0


def test_sparse_solve_dispatches_to_the_plain_version_on_the_cpu():
    port, _, _, _ = _system("pedigree")
    a = tcg.cg_solve_sparse(*port, tol=1e-10, max_iter=50)
    b = tcg.cg_solve_sparse_plain(*port, tol=1e-10, max_iter=50)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


# ------------------------------------------------------------------ CG1's layout


def _wide_tables(q=300, kw=100, seed=4):
    """Padded tables with rows of 0 to kw live entries, a few past 8 x 8
    (a row spanning more than five of CG1's chunks of 12)."""
    rng = np.random.default_rng(seed)
    ln = rng.integers(0, 6, q)
    ln[rng.choice(q, 5, replace=False)] = rng.integers(65, kw + 1, 5)
    ln[rng.choice(q, 5, replace=False)] = 0
    idx = np.where(np.arange(kw) < ln[:, None], rng.integers(0, q, (q, kw)), 0).astype(np.int32)
    val = np.where(np.arange(kw) < ln[:, None], rng.normal(size=(q, kw)), 0.0)
    return idx, val, ln.astype(np.int32)


def _tables(kind):
    if kind == "wide":
        return _wide_tables()
    rp, rs, _, _ = _assembled(kind)
    return rs.iv_idx.numpy(), rs.iv_val.numpy(), rp.iv_len.numpy()


def _full_cuts(ln, grid):
    return np.concatenate([[0], tcg.row_cuts(torch.from_numpy(ln), grid).numpy(), [ln.size]])


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("kind", CASES + ("wide",))
def test_row_cuts_split_the_rows_by_weight(kind, grid):
    """row_cuts against the padded tables: grid - 1 int32 cuts, in order,
    that cover every row once, and each block's weight (max(len, 1) +
    ROW_WEIGHT a row) within one row's weight of an equal share."""
    _, _, ln = _tables(kind)
    cuts = tcg.row_cuts(torch.from_numpy(ln), grid)
    assert cuts.dtype == torch.int32 and cuts.shape == (grid - 1,)
    full = _full_cuts(ln, grid)
    assert (np.diff(full) >= 0).all() and full[0] == 0 and full[-1] == ln.size
    w = np.maximum(ln, 1).astype(np.int64) + tcg.ROW_WEIGHT
    share = w.sum() / grid
    per_block = np.array([w[a:b].sum() for a, b in zip(full[:-1], full[1:])])
    assert per_block.sum() == w.sum() and (per_block <= share + w.max()).all()


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("kind", CASES + ("wide",))
def test_cg_layout_gives_each_block_its_chunks(kind, grid):
    """cg_layout against the padded tables: row_cuts' cuts, and each block's
    chunk slots (first, int64, from 0) as many as its rows' max(len, 1)
    entries fill chunks of CHUNK, in all no more than the scratch the
    wrapper sizes where it is given no layout (q kw / CHUNK + grid)."""
    idx, _, ln = _tables(kind)
    cuts, first = tcg.cg_layout(torch.from_numpy(ln), grid)
    assert torch.equal(cuts, tcg.row_cuts(torch.from_numpy(ln), grid))
    assert first.dtype == torch.int64 and first.shape == (grid + 1,) and int(first[0]) == 0
    full = _full_cuts(ln, grid)
    entries = np.array([np.maximum(ln[a:b], 1).sum() for a, b in zip(full[:-1], full[1:])])
    np.testing.assert_array_equal(np.diff(first.numpy()), -(-entries // tcg.CHUNK))
    assert int(first[-1]) <= ln.size * idx.shape[1] // tcg.CHUNK + grid


def _chunks(idx, val, ln, r0, r1, chunk):
    """CG1's compacted chunks of rows r0 .. r1 - 1 (csrc/cg_solve.cu,
    stage_rows): (heads, backs, words, values), a row with no live entry
    holding one (its own index, 0); a head is the first row (local) << 1,
    | 1 where that row began in an earlier chunk; a back is how many chunks
    back that row began where it also ends in this chunk, else 0; a word's
    top bit marks a row's last entry."""
    heads, backs, words, vals, e = [], [], [], [], 0
    for i in range(r0, r1):
        n = max(int(ln[i]), 1)
        first, last = e // chunk, (e + n - 1) // chunk
        for k in range(n):
            if e % chunk == 0:
                heads.append(((i - r0) << 1) | (k > 0))
                backs.append(e // chunk - first if k > 0 and e // chunk == last else 0)
                words.append([])
                vals.append([])
            words[-1].append((int(idx[i, k]) if ln[i] else i) | ((1 << 31) if k == n - 1 else 0))
            vals[-1].append(float(val[i, k]) if ln[i] else 0.0)
            e += 1
    return heads, backs, words, vals


def _walk(heads, backs, words, vals, v):
    """CG1's matvec over one block's chunks (csrc/cg_solve.cu, walk and
    chunk_runs): each row's sum, by row (local)."""
    out, tails, late = {}, {}, {}
    for c, (h, back) in enumerate(zip(heads, backs)):
        row, first, run, s = h >> 1, True, False, 0.0
        for w, a in zip(words[c], vals[c]):
            s = s + a * v[w & 0x7FFFFFFF] if run else a * v[w & 0x7FFFFFFF]
            run = True
            if w >> 31:
                if first and back:
                    late[c] = s
                else:
                    out[row] = s
                row, first, run = row + 1, False, False
        if run:
            tails[c] = s
    for c, back in enumerate(backs):  # after the block's barrier
        if back:
            out[heads[c] >> 1] = sum((tails[cc] for cc in range(c - back + 1, c)), tails[c - back]) + late[c]
    return out


@pytest.mark.parametrize("chunk", [3, 12])
@pytest.mark.parametrize("kind", CASES + ("wide",))
def test_chunk_walk_sums_the_padded_rows(kind, chunk):
    """CG1's layout held to the padded forms: the chunks of each block of
    row_cuts (12 entries as the kernel's, as many as cg_layout gives the
    block, or 3, so that most rows span chunks), walked as the kernel walks
    them, give every row once, with K v over its live entries
    (sparse_matvec_plain's sum) to rounding."""
    idx, val, ln = _tables(kind)
    q = ln.size
    v = np.random.default_rng(9).normal(size=q)
    ref = tcg.sparse_matvec_plain(torch.zeros(q, dtype=torch.float64), torch.from_numpy(idx),
                                  torch.from_numpy(val), torch.from_numpy(ln), 1.0,
                                  torch.from_numpy(v)).numpy()
    got = np.full(q, np.nan)
    full = _full_cuts(ln, 7)
    first = tcg.cg_layout(torch.from_numpy(ln), 7)[1].numpy()
    for b, (r0, r1) in enumerate(zip(full[:-1], full[1:])):
        heads, backs, words, vals = _chunks(idx, val, ln, r0, r1, chunk)
        assert sum(map(len, words)) == np.maximum(ln[r0:r1], 1).sum()
        if chunk == tcg.CHUNK:  # the block's chunks fill its slots of the layout
            assert len(words) == first[b + 1] - first[b]
        rows = _walk(heads, backs, words, vals, v)
        assert sorted(rows) == list(range(r1 - r0))
        for row, s in rows.items():
            got[r0 + row] = s
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-12)
