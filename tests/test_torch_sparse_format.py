"""The port's sparse layouts against the JAX reference, array for array.

Every field of ``SparseGridData`` and ``BucketedGridData`` (the flat
chunk view and its tables included) is ``np.array_equal`` to the
reference's, as are the host-side helpers.  The bucketed byte-budget
inequality is asserted only at tile-K skew >= ``BUCKET_SKEW_THRESHOLD``:
below it the reference itself breaks it (hypothesis seed 249 of
``tests/test_bucketed.py``), and ``auto`` never picks the bucketed layout
there.
"""

import numpy as np
import pytest
import torch

import repro.data.synthetic as jsyn
import repro.sparse.format as jf
import repro_torch.data.synthetic as tsyn
import repro_torch.sparse.format as tf


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.numpy()
    return np.asarray(a)


def _assert_fields_equal(t, j):
    assert type(t).__name__ == type(j).__name__
    for field in j._fields:
        a, b = getattr(t, field), getattr(j, field)
        if isinstance(b, tuple):
            assert len(a) == len(b), field
            for k, (x, z) in enumerate(zip(a, b)):
                assert np.array_equal(_np(x), _np(z)), f"{field}[{k}]"
                assert _np(x).dtype == _np(z).dtype, f"{field}[{k}] dtype"
        elif b is None or isinstance(b, (int, float)):
            assert a == b, field
        else:
            assert np.array_equal(_np(a), _np(b)), field
            assert _np(a).dtype == _np(b).dtype, f"{field} dtype"


def _problems(kind, m, d, density, seed):
    if kind == "skewed":
        kw = dict(m=m, d=d, density=density, alpha=1.3, seed=seed)
        return (jsyn.make_skewed_classification(**kw),
                tsyn.make_skewed_classification(**kw, device="cpu"))
    kw = dict(m=m, d=d, density=density, seed=seed)
    return (jsyn.make_classification(**kw),
            tsyn.make_classification(**kw, device="cpu"))


CASES = [("uniform", 75, 41, 0.18, 2, 1), ("uniform", 120, 90, 0.1, 4, 3),
         ("skewed", 120, 64, 0.15, 4, 1), ("skewed", 128, 96, 0.2, 4, 3),
         ("skewed", 75, 41, 0.15, 3, 3), ("uniform", 57, 66, 0.47, 4, 1),
         ("uniform", 5, 12, 0.4, 4, 1)]


@pytest.mark.parametrize("kind,m,d,density,p,row_batches", CASES)
def test_grids_equal_reference(kind, m, d, density, p, row_batches):
    jp, tp = _problems(kind, m, d, density, seed=p + row_batches)
    j_uni = jf.make_sparse_grid_data(jp, p, row_batches)
    t_uni = tf.make_sparse_grid_data(tp, p, row_batches, device="cpu")
    _assert_fields_equal(t_uni, j_uni)
    j_b = jf.make_bucketed_grid_data(jp, p, row_batches)
    t_b = tf.make_bucketed_grid_data(tp, p, row_batches, device="cpu")
    _assert_fields_equal(t_b, j_b)
    for q in range(p):
        for b in range(p):
            for x, z in zip(t_b.flat_tile(q, b), j_b.flat_tile(q, b)):
                assert np.array_equal(x, z)
    assert tf.grid_nbytes(t_uni) == jf.grid_nbytes(j_uni)
    assert tf.grid_nbytes(t_b) == jf.grid_nbytes(j_b)
    assert tf.packed_bytes_per_step(t_b) == jf.packed_bytes_per_step(j_b)
    assert tf.packed_bytes_per_step(t_uni) == \
        jf.packed_bytes_per_step(j_uni)
    kpt = tf.problem_k_per_tile(tp, p)
    assert np.array_equal(kpt, jf.problem_k_per_tile(jp, p))
    assert tf.tile_k_skew(kpt) == jf.tile_k_skew(kpt)
    assert tf.density(tp) == jf.density(jp)
    if tf.tile_k_skew(kpt) >= tf.BUCKET_SKEW_THRESHOLD:
        maps = sum(t.nbytes for t in (t_b.bucket_id, t_b.bucket_pos,
                                      t_b.chunk_lut, t_b.chunk_cnt))
        assert tf.grid_nbytes(t_b) <= tf.grid_nbytes(t_uni) + maps


def _powerlaw_csr(m, d, k, alpha, seed):
    rng = np.random.default_rng(seed)
    cols = jsyn.powerlaw_columns(rng, m, d, k, alpha)
    indptr = np.arange(m + 1, dtype=np.int64) * k
    return (cols.reshape(-1).astype(np.int32),
            rng.normal(0, 1, m * k).astype(np.float32), indptr,
            np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32))


@pytest.mark.parametrize("p,row_batches", [(4, 1), (4, 3)])
def test_csr_builders_and_probes_equal_reference(p, row_batches):
    idx, val, indptr, y = _powerlaw_csr(126, 96, 10, 1.3, seed=p)
    jc = jf.CSRMatrix(indptr, idx, val, (126, 96))
    tc = tf.CSRMatrix(indptr, idx, val, (126, 96))
    _assert_fields_equal(tf.sparse_grid_from_csr(tc, y, p, row_batches,
                                                 device="cpu"),
                         jf.sparse_grid_from_csr(jc, y, p, row_batches))
    tb = tf.bucketed_grid_from_csr(tc, y, p, row_batches, device="cpu")
    jb = jf.bucketed_grid_from_csr(jc, y, p, row_batches)
    _assert_fields_equal(tb, jb)
    assert len(tb.bucket_ks) >= 2
    kpt = tf.csr_k_per_tile(tc, p)
    assert np.array_equal(kpt, jf.csr_k_per_tile(jc, p))
    assert tf.tile_k_skew(kpt) == jf.tile_k_skew(kpt)
    w = np.random.default_rng(0).normal(size=96).astype(np.float32)
    a = np.random.default_rng(1).normal(size=126).astype(np.float32)
    assert np.array_equal(tc.matvec(w), jc.matvec(w))
    assert np.array_equal(tc.rmatvec(a), jc.rmatvec(a))
    assert np.array_equal(tc.toarray(), jc.toarray())
    assert tc.density == jc.density and tc.nnz == jc.nnz


# a row's entries in one block, for the block-ELL layout's edges: 32 = K
EDGE_ROW_NNZ = (0, 1, 16, 17, 32)


def _edge_rows_csr(kind, seed, p=4, mb=30, db=40):
    """A CSR over p shards of ``mb`` rows and p blocks of ``db`` columns:
    row i < 5 of shard q holds exactly ``EDGE_ROW_NNZ[i]`` columns, all in
    block (q + i) mod p (so K = 32 and rows whose every slot is live); the
    other rows 2-12 columns drawn ``kind``: "uniform", "power-law" (alpha
    1.3) or "hot column" (power-law, and column 0 in every row)."""
    rng = np.random.default_rng(seed)
    m, d = p * mb, p * db
    pop = None
    if kind != "uniform":
        pop = np.arange(1, d + 1, dtype=np.float64) ** -1.3
        pop /= pop.sum()
    rows = []
    for r in range(m):
        q, i = divmod(r, mb)
        if i < len(EDGE_ROW_NNZ):
            b = (q + i) % p
            rows.append(b * db + np.sort(rng.choice(db, EDGE_ROW_NNZ[i],
                                                    replace=False)))
            continue
        c = np.sort(rng.choice(d, rng.integers(2, 13), replace=False, p=pop))
        rows.append(np.union1d(c, [0]) if kind == "hot column" else c)
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum([len(r) for r in rows], out=indptr[1:])
    idx = np.concatenate(rows).astype(np.int32)
    val = rng.normal(0, 1, idx.size).astype(np.float32)
    y = np.where(rng.random(m) < 0.5, 1.0, -1.0).astype(np.float32)
    return indptr, idx, val, y, (m, d)


@pytest.mark.parametrize("row_batches", [1, 3])
@pytest.mark.parametrize("kind", ["uniform", "power-law", "hot column"])
def test_block_ell_live_slots_are_a_prefix(kind, row_batches):
    """What the block-ELL kernel's live-slot read relies on: each tile row
    holds its entries in slots [0, tile_row_nnz) in column order, and every
    slot at or past tile_row_nnz is (col 0, val 0.0); the live prefix
    equals the reference's layout."""
    indptr, idx, val, y, shape = _edge_rows_csr(kind, seed=row_batches)
    p, db = 4, shape[1] // 4
    t = tf.sparse_grid_from_csr(tf.CSRMatrix(indptr, idx, val, shape), y, p,
                                row_batches, device="cpu")
    j = jf.sparse_grid_from_csr(jf.CSRMatrix(indptr, idx, val, shape), y, p,
                                row_batches)
    trn = t.tile_row_nnz_g.numpy().astype(np.int64)        # (p, p, mb)
    assert t.K == max(EDGE_ROW_NNZ)
    assert set(EDGE_ROW_NNZ) <= set(np.unique(trn).tolist())
    assert np.array_equal(trn, np.asarray(j.tile_row_nnz_g))
    cols, vals = t.cols_g.numpy(), t.vals_g.numpy()
    pad = np.arange(t.K) >= trn[..., None]                 # (p, p, mb, K)
    assert (cols[pad] == 0).all() and (vals[pad] == 0.0).all()
    assert np.array_equal(cols[~pad], np.asarray(j.cols_g)[~pad])
    assert np.array_equal(vals[~pad], np.asarray(j.vals_g)[~pad])
    mb = t.mb
    for r in range(shape[0]):
        q, i = divmod(r, mb)
        c, v = idx[indptr[r]:indptr[r + 1]], val[indptr[r]:indptr[r + 1]]
        for b in range(p):
            sel = c // db == b
            k = int(sel.sum())
            assert trn[q, b, i] == k
            assert np.array_equal(cols[q, b, i, :k], c[sel] - b * db)
            assert np.array_equal(vals[q, b, i, :k], v[sel])


def test_choose_k_and_assign_k_buckets_equal_reference():
    for k in [0, 1, 7, 8, 9, 51, 64, 65, 300]:
        for pow2 in (False, True):
            assert tf.choose_k(k, pow2=pow2) == jf.choose_k(k, pow2=pow2)
    rng = np.random.default_rng(0)
    for trial in range(5):
        k_raw = rng.integers(1, 300, size=(6, 6))
        for mb in (2, 4):
            tw, tid = tf.assign_k_buckets(k_raw, max_buckets=mb)
            jw, jid = jf.assign_k_buckets(k_raw, max_buckets=mb)
            assert tw == jw and np.array_equal(tid, jid)
    assert (tf.SUBLANE, tf.K_CHUNK, tf.MAX_K_BUCKETS) == \
        (jf.SUBLANE, jf.K_CHUNK, jf.MAX_K_BUCKETS)
    assert tf.SPARSE_DENSITY_THRESHOLD == jf.SPARSE_DENSITY_THRESHOLD
    assert tf.BUCKET_SKEW_THRESHOLD == jf.BUCKET_SKEW_THRESHOLD
    assert tf.pad_to_multiple(13, 4) == jf.pad_to_multiple(13, 4)


def test_csr_and_tile_helpers_equal_reference():
    X = np.zeros((8, 16), np.float32)
    X[0, 0], X[0, 5], X[3, 0], X[7, 15] = 3.0, -1.0, 2.0, 0.5
    tt, jt = tf.SparseTile.from_dense(X), jf.SparseTile.from_dense(X)
    assert np.array_equal(tt.cols, np.asarray(jt.cols))
    assert np.array_equal(tt.vals, np.asarray(jt.vals))
    assert np.array_equal(tt.toarray(), X) and tt.K == jt.K
    tcsr, jcsr = tf.CSRMatrix.from_dense(X), jf.CSRMatrix.from_dense(X)
    for f in ("indptr", "indices", "values"):
        assert np.array_equal(getattr(tcsr, f), getattr(jcsr, f))
    joined = tf.CSRMatrix.from_shards([tf.CSRMatrix.from_dense(X[:3]),
                                       tf.CSRMatrix.from_dense(X[3:])], d=16)
    assert np.array_equal(joined.indptr, tcsr.indptr)
    assert np.array_equal(joined.toarray(), X)
    assert np.array_equal(tcsr.row_nnz(), jcsr.row_nnz())
    assert np.array_equal(tcsr.col_nnz(), jcsr.col_nnz())


def test_builders_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    csr = tf.CSRMatrix.from_dense(np.eye(8, dtype=np.float32))
    with pytest.raises(RuntimeError, match="cuda"):
        tf.sparse_grid_from_csr(csr, np.ones(8, np.float32), 2)
