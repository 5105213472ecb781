"""Block-sparse data layouts for DSO: CSR + padded block-ELL grid tiles.

The host side is numpy, exactly as in the reference, so every layout can
be compared with it array for array; only the device-resident arrays
(the packed tiles, the flat chunk view and the statistics the epoch reads)
become tensors on ``device``.

``CSRMatrix``
    Plain compressed-sparse-rows in numpy (indptr/indices/values), column
    indices ascending within each row.

``SparseTile``
    One (rows, db) grid tile packed as ELL: ``cols``/``vals`` (rows, K),
    padding slots ``val = 0`` at ``col = 0`` so gathers add exact zeros and
    scatter-adds are no-ops.

``SparseGridData``
    The p x p grid in block-ELL: ``cols_g``/``vals_g`` (p, p, mb, K),
    ``[q, b]`` processor q's tile of w-block b with block-local columns, K
    the max over tiles.

``BucketedGridData``
    The K-bucketed ragged grid: tiles grouped into <= ``MAX_K_BUCKETS``
    sublane-aligned widths.  The per-bucket rectangles stay host numpy;
    the device holds the *flat chunk view* — every tile as consecutive
    (mb, K_CHUNK) chunks of one buffer plus the ``chunk_lut``/``chunk_cnt``
    tables that the bucketed block-step kernel walks.

``SUBLANE``/``K_CHUNK`` = 8 are the TPU's float32 sublane multiple.  They
are kept so that the port's layouts equal the reference's array for array;
retuning the widths for the card is a separate, measured change.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import resolve_device


def pad_to_multiple(n: int, p: int) -> int:
    return ((n + p - 1) // p) * p


SUBLANE = 8    # float32 sublane multiple of the reference's layouts

#: below this nnz/(m*d) density the sparse layout wins
SPARSE_DENSITY_THRESHOLD = 0.1

#: at or above this per-tile-K skew (k_raw.max() / median) ``auto`` picks
#: the K-bucketed ragged layout
BUCKET_SKEW_THRESHOLD = 4.0

#: rectangular K-buckets per grid
MAX_K_BUCKETS = 4


def _np(a) -> np.ndarray:
    """Host numpy view of a tensor or array (tests, inspection)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def choose_k(max_row_nnz: int, *, align: int = SUBLANE,
             pow2: bool = False) -> int:
    """Packed width K for a tile whose densest row has ``max_row_nnz``:
    rounded up to ``align``; ``pow2`` additionally rounds to a power of
    two."""
    k = max(int(max_row_nnz), 1)
    k = -(-k // align) * align
    if pow2:
        k = 1 << (k - 1).bit_length()
    return k


class CSRMatrix(NamedTuple):
    """Compressed sparse rows (numpy, host-side interchange format)."""

    indptr: np.ndarray   # (m + 1,) int64
    indices: np.ndarray  # (nnz,) int32, ascending within each row
    values: np.ndarray   # (nnz,) float32
    shape: tuple[int, int]

    @property
    def m(self) -> int:
        return self.shape[0]

    @property
    def d(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def density(self) -> float:
        return self.nnz / float(max(1, self.m * self.d))

    def row_ids(self) -> np.ndarray:
        """(nnz,) row index of every stored entry."""
        return np.repeat(np.arange(self.m, dtype=np.int64),
                         np.diff(self.indptr))

    def row_nnz(self) -> np.ndarray:
        return np.diff(self.indptr).astype(np.float32)

    def col_nnz(self) -> np.ndarray:
        return np.bincount(self.indices, minlength=self.d) \
            .astype(np.float32)

    def matvec(self, w) -> np.ndarray:
        """X @ w without densifying."""
        w = np.asarray(w)
        contrib = self.values * w[self.indices]
        return np.bincount(self.row_ids(), weights=contrib,
                           minlength=self.m).astype(np.float32)

    def rmatvec(self, a) -> np.ndarray:
        """X.T @ a without densifying."""
        a = np.asarray(a)
        contrib = self.values * a[self.row_ids()]
        return np.bincount(self.indices, weights=contrib,
                           minlength=self.d).astype(np.float32)

    def toarray(self) -> np.ndarray:
        """Densify — tests only."""
        X = np.zeros(self.shape, np.float32)
        X[self.row_ids(), self.indices] = self.values
        return X

    @classmethod
    def from_dense(cls, X) -> "CSRMatrix":
        X = _np(X)
        ii, jj = np.nonzero(X)
        indptr = np.zeros(X.shape[0] + 1, np.int64)
        np.cumsum(np.bincount(ii, minlength=X.shape[0]), out=indptr[1:])
        return cls(indptr=indptr, indices=jj.astype(np.int32),
                   values=X[ii, jj].astype(np.float32), shape=X.shape)

    @classmethod
    def from_shards(cls, shards, d: int) -> "CSRMatrix":
        """Concatenate row-shard CSRMatrices (all with ``d`` columns)."""
        indptr = [np.zeros(1, np.int64)]
        for s in shards:
            if s.d != d:
                raise ValueError(f"shard has {s.d} columns, expected {d}")
            indptr.append(s.indptr[1:] + indptr[-1][-1])
        m = sum(len(p) for p in indptr[1:])
        return cls(indptr=np.concatenate(indptr),
                   indices=np.concatenate([s.indices for s in shards]),
                   values=np.concatenate([s.values for s in shards]),
                   shape=(m, d))


class SparseTile(NamedTuple):
    """One (rows, db) grid tile in padded ELL form (host numpy)."""

    cols: np.ndarray     # (rows, K) int32 tile-local column indices
    vals: np.ndarray     # (rows, K) float32, 0.0 in pads
    row_nnz: np.ndarray  # (rows,) float32 nnz per row within this tile
    db: int

    @property
    def K(self) -> int:
        return self.cols.shape[1]

    def toarray(self) -> np.ndarray:
        cols, vals = _np(self.cols), _np(self.vals)
        dense = np.zeros((cols.shape[0], self.db), np.float32)
        rows = np.arange(cols.shape[0])[:, None]
        np.add.at(dense, (np.broadcast_to(rows, cols.shape), cols), vals)
        return dense

    @classmethod
    def from_dense(cls, X_tile, *, k_align: int = SUBLANE,
                   pow2: bool = False) -> "SparseTile":
        X_tile = _np(X_tile)
        rows, db = X_tile.shape
        ii, jj = np.nonzero(X_tile)
        rn = np.bincount(ii, minlength=rows)
        K = choose_k(rn.max() if rows else 0, align=k_align, pow2=pow2)
        cols = np.zeros((rows, K), np.int32)
        vals = np.zeros((rows, K), np.float32)
        starts = np.zeros(rows + 1, np.int64)
        np.cumsum(rn, out=starts[1:])
        pos = np.arange(len(ii)) - starts[ii]
        cols[ii, pos] = jj
        vals[ii, pos] = X_tile[ii, jj]
        return cls(cols=cols, vals=vals, row_nnz=rn.astype(np.float32),
                   db=db)


class SparseGridData(NamedTuple):
    """Problem data on the p x p DSO grid in block-ELL form (tensors on
    one device; ``k_per_tile`` host numpy)."""

    cols_g: torch.Tensor    # (p, p, mb, K) int32
    vals_g: torch.Tensor    # (p, p, mb, K) float32
    yg: torch.Tensor        # (p, mb)
    row_nnz_g: torch.Tensor  # (p, mb)   |Omega_i|, >= 1
    col_nnz: torch.Tensor   # (d_pad,)   |Omega-bar_j|, >= 1
    row_valid: torch.Tensor  # (p, mb)  1.0 for real rows
    p: int
    mb: int
    db: int
    K: int
    tile_col_nnz_g: torch.Tensor = None   # (p, n_rb, d_pad)
    tile_row_nnz_g: torch.Tensor = None   # (p, p, mb)
    k_per_tile: np.ndarray = None         # (p, p) int


#: flat-chunk granularity of the bucketed layout's packed view
K_CHUNK = SUBLANE


class BucketedGridData(NamedTuple):
    """The p x p DSO grid in K-bucketed ragged block-ELL form.

    ``cols_b``/``vals_b`` per bucket (p, slots_k, mb, K_k) are host numpy;
    the flat chunk view ``cols_fl``/``vals_fl`` (p, n_chunks, mb, K_CHUNK)
    and the ``chunk_lut`` (p, p, n_kc) / ``chunk_cnt`` (p, p) tables live on
    the device.  ``chunk_lut`` entries past a tile's count repeat its last
    live chunk.
    """

    cols_b: tuple
    vals_b: tuple
    bucket_id: torch.Tensor   # (p, p) int32
    bucket_pos: torch.Tensor  # (p, p) int32
    yg: torch.Tensor
    row_nnz_g: torch.Tensor
    col_nnz: torch.Tensor
    row_valid: torch.Tensor
    p: int
    mb: int
    db: int
    bucket_ks: tuple
    tile_col_nnz_g: torch.Tensor = None
    tile_row_nnz_g: torch.Tensor = None
    k_per_tile: np.ndarray = None
    cols_fl: torch.Tensor = None
    vals_fl: torch.Tensor = None
    chunk_lut: torch.Tensor = None
    chunk_cnt: torch.Tensor = None

    def tile(self, q: int, b: int) -> SparseTile:
        """The packed tile of processor q / block b (tests, inspection)."""
        k = int(_np(self.bucket_id)[q, b])
        s = int(_np(self.bucket_pos)[q, b])
        return SparseTile(cols=self.cols_b[k][q, s],
                          vals=self.vals_b[k][q, s], row_nnz=None,
                          db=self.db)

    def flat_tile(self, q: int, b: int):
        """Tile (q, b) reassembled from the flat chunk view."""
        lut = _np(self.chunk_lut)[q, b]
        cnt = int(_np(self.chunk_cnt)[q, b])
        c = _np(self.cols_fl)[q, lut[:cnt]]
        v = _np(self.vals_fl)[q, lut[:cnt]]
        return (c.transpose(1, 0, 2).reshape(self.mb, cnt * K_CHUNK),
                v.transpose(1, 0, 2).reshape(self.mb, cnt * K_CHUNK))


def density(prob) -> float:
    """nnz / (m * d) of a ``Problem``."""
    return float(prob.nnz) / float(max(1, prob.m * prob.d))


class _ShardAddr(NamedTuple):
    """Packed ELL address of every stored entry of one processor shard."""

    idx: np.ndarray
    local_rows: np.ndarray
    blk: np.ndarray
    pos: np.ndarray
    vals: np.ndarray


def _shard_addressing(idx, local_rows, vals, mb: int, p: int, db: int,
                      rb: int, n_rb: int, d_pad: int):
    """Packed ELL address of one shard's entries (ascending (row, col))
    plus its per-tile statistics:
    ``(addr, k_raw_q, tile_row_nnz_q, tile_col_nnz_q)``."""
    blk = idx // db
    seg = local_rows * p + blk
    counts = np.bincount(seg, minlength=mb * p)
    k_raw_q = counts.reshape(mb, p).max(axis=0)
    trn_q = counts.reshape(mb, p).T.astype(np.float32)
    starts = np.zeros(mb * p + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(len(seg)) - starts[seg]
    tc_q = np.zeros((n_rb, d_pad), np.float32)
    if idx.size:
        batch = local_rows // rb
        keep = batch < n_rb                  # trailing truncated rows
        tc_q = np.bincount(batch[keep] * d_pad + idx[keep],
                           minlength=n_rb * d_pad) \
            .reshape(n_rb, d_pad).astype(np.float32)
    addr = _ShardAddr(idx=idx, local_rows=local_rows, blk=blk, pos=pos,
                      vals=vals)
    return addr, k_raw_q, trn_q, tc_q


def _tile_csr(csr: CSRMatrix, y, p: int, row_batches: int):
    """Layout-independent half of the grid tilers (host numpy): padding,
    every scaling statistic, the per-tile raw widths and the packed ELL
    address of each stored entry."""
    m, d = csr.shape
    m_pad, d_pad = pad_to_multiple(m, p), pad_to_multiple(d, p)
    mb, db = m_pad // p, d_pad // p
    rb = max(1, mb // row_batches)
    n_rb = mb // rb

    y_pad = np.zeros(m_pad, np.float32)
    y_pad[:m] = np.asarray(y, np.float32)
    row_nnz = np.ones(m_pad, np.float32)
    row_nnz[:m] = np.maximum(csr.row_nnz(), 1.0)
    col_nnz = np.ones(d_pad, np.float32)
    col_nnz[:d] = np.maximum(csr.col_nnz(), 1.0)
    row_valid = np.zeros(m_pad, np.float32)
    row_valid[:m] = 1.0

    tile_row_nnz = np.zeros((p, p, mb), np.float32)
    tile_col_nnz = np.zeros((p, n_rb, d_pad), np.float32)
    k_raw = np.zeros((p, p), np.int64)
    addrs: list[_ShardAddr] = []
    for q in range(p):
        r0, r1 = min(q * mb, m), min((q + 1) * mb, m)
        lo, hi = csr.indptr[r0], csr.indptr[r1]
        idx = csr.indices[lo:hi].astype(np.int64)
        local_rows = np.repeat(np.arange(r1 - r0, dtype=np.int64),
                               np.diff(csr.indptr[r0:r1 + 1])) \
            if r1 > r0 else np.zeros(0, np.int64)
        addr, k_raw[q], tile_row_nnz[q], tile_col_nnz[q] = \
            _shard_addressing(idx, local_rows, csr.values[lo:hi],
                              mb, p, db, rb, n_rb, d_pad)
        addrs.append(addr)

    shared = dict(
        yg=y_pad.reshape(p, mb), row_nnz_g=row_nnz.reshape(p, mb),
        col_nnz=col_nnz, row_valid=row_valid.reshape(p, mb),
        p=p, mb=mb, db=db, tile_col_nnz_g=tile_col_nnz,
        tile_row_nnz_g=tile_row_nnz, k_per_tile=k_raw)
    return shared, addrs


_DEVICE_FIELDS = ("yg", "row_nnz_g", "col_nnz", "row_valid",
                  "tile_col_nnz_g", "tile_row_nnz_g")


def _on_device(shared: dict, dev: torch.device) -> dict:
    out = dict(shared)
    for k in _DEVICE_FIELDS:
        out[k] = torch.as_tensor(shared[k], device=dev)
    return out


def sparse_grid_from_csr(csr: CSRMatrix, y, p: int, row_batches: int = 1,
                         *, k_align: int = SUBLANE, pow2: bool = False,
                         device="cuda") -> SparseGridData:
    """Tile a CSR matrix onto the p x p grid (uniform max-K) without ever
    densifying; the grid's tensors go to ``device``."""
    dev = resolve_device(device)
    shared, addrs = _tile_csr(csr, y, p, row_batches)
    return _pack_uniform(shared, addrs, dev, k_align=k_align, pow2=pow2)


def _pack_uniform(shared, addrs, dev, *, k_align: int = SUBLANE,
                  pow2: bool = False) -> SparseGridData:
    p, mb, db = shared["p"], shared["mb"], shared["db"]
    K = choose_k(int(shared["k_per_tile"].max()), align=k_align, pow2=pow2)
    cols_g = np.zeros((p, p, mb, K), np.int32)
    vals_g = np.zeros((p, p, mb, K), np.float32)
    for q, a in enumerate(addrs):
        if a.idx.size == 0:
            continue
        cols_g[q, a.blk, a.local_rows, a.pos] = \
            (a.idx - a.blk * db).astype(np.int32)
        vals_g[q, a.blk, a.local_rows, a.pos] = a.vals
    return SparseGridData(cols_g=torch.as_tensor(cols_g, device=dev),
                          vals_g=torch.as_tensor(vals_g, device=dev), K=K,
                          **_on_device(shared, dev))


def assign_k_buckets(k_per_tile, *, max_buckets: int = MAX_K_BUCKETS,
                     align: int = SUBLANE):
    """Group per-tile raw widths into <= ``max_buckets`` packed widths:
    start from each tile's aligned width, then merge upward the width whose
    promotion wastes the fewest padded slots.  Returns ``(widths,
    bucket_id)``."""
    k_raw = np.asarray(k_per_tile, np.int64)
    w_t = np.vectorize(lambda k: choose_k(int(k), align=align))(k_raw)
    widths = sorted(set(int(w) for w in w_t.ravel()))
    while len(widths) > max_buckets:
        costs = [(int((w_t == widths[i]).sum()) * (widths[i + 1] - widths[i]),
                  i) for i in range(len(widths) - 1)]
        _, i = min(costs)
        w_t[w_t == widths[i]] = widths[i + 1]
        widths.pop(i)
    bucket_id = np.searchsorted(widths, w_t).astype(np.int32)
    return tuple(widths), bucket_id


def bucketed_grid_from_csr(csr: CSRMatrix, y, p: int, row_batches: int = 1,
                           *, k_align: int = SUBLANE,
                           max_buckets: int = MAX_K_BUCKETS,
                           device="cuda") -> BucketedGridData:
    """Tile a CSR matrix onto the p x p grid in K-bucketed ragged form
    (same addressing pass and statistics as ``sparse_grid_from_csr``)."""
    dev = resolve_device(device)
    shared, addrs = _tile_csr(csr, y, p, row_batches)
    return _pack_bucketed(shared, addrs, dev, k_align=k_align,
                          max_buckets=max_buckets)


def _pack_bucketed(shared, addrs, dev, *, k_align: int = SUBLANE,
                   max_buckets: int = MAX_K_BUCKETS) -> BucketedGridData:
    p, mb, db = shared["p"], shared["mb"], shared["db"]
    widths, bucket_id = assign_k_buckets(shared["k_per_tile"],
                                         max_buckets=max_buckets,
                                         align=k_align)
    n_b = len(widths)
    bucket_pos = np.zeros((p, p), np.int32)
    t_per = np.zeros((p, n_b), np.int64)
    for q in range(p):
        for b in range(p):
            k = bucket_id[q, b]
            bucket_pos[q, b] = t_per[q, k]
            t_per[q, k] += 1
    slots = t_per.max(axis=0)
    cols_b = [np.zeros((p, int(slots[k]), mb, widths[k]), np.int32)
              for k in range(n_b)]
    vals_b = [np.zeros((p, int(slots[k]), mb, widths[k]), np.float32)
              for k in range(n_b)]
    for q, a in enumerate(addrs):
        if a.idx.size == 0:
            continue
        for b in range(p):
            msk = a.blk == b
            if not msk.any():
                continue
            k, s = int(bucket_id[q, b]), int(bucket_pos[q, b])
            cols_b[k][q, s, a.local_rows[msk], a.pos[msk]] = \
                (a.idx[msk] - b * db).astype(np.int32)
            vals_b[k][q, s, a.local_rows[msk], a.pos[msk]] = a.vals[msk]
    cols_fl, vals_fl, chunk_lut, chunk_cnt = _flat_chunk_view(
        cols_b, vals_b, widths, bucket_id, bucket_pos)
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    return BucketedGridData(
        cols_b=tuple(cols_b), vals_b=tuple(vals_b),
        bucket_id=t(bucket_id), bucket_pos=t(bucket_pos), bucket_ks=widths,
        cols_fl=t(cols_fl), vals_fl=t(vals_fl), chunk_lut=t(chunk_lut),
        chunk_cnt=t(chunk_cnt), **_on_device(shared, dev))


def _flat_chunk_view(cols_b, vals_b, widths, bucket_id, bucket_pos):
    """Pack per-bucket (p, slots_k, mb, K_k) rectangles into the flat
    (p, n_chunks, mb, K_CHUNK) chunk buffer + per-tile offset tables
    (bucket-major, then slot-major; dead lut entries clamped to the last
    live chunk)."""
    p = cols_b[0].shape[0] if cols_b else 0
    mb = cols_b[0].shape[2] if cols_b else 0
    n_per = np.asarray([w // K_CHUNK for w in widths], np.int64)
    base = np.zeros(len(widths) + 1, np.int64)
    parts_c, parts_v = [], []
    for k, w in enumerate(widths):
        s_k, n_k = cols_b[k].shape[1], int(n_per[k])
        base[k + 1] = base[k] + s_k * n_k
        for arr, parts in ((cols_b[k], parts_c), (vals_b[k], parts_v)):
            parts.append(arr.reshape(p, s_k, mb, n_k, K_CHUNK)
                         .transpose(0, 1, 3, 2, 4)
                         .reshape(p, s_k * n_k, mb, K_CHUNK))
    cols_fl = np.ascontiguousarray(np.concatenate(parts_c, axis=1))
    vals_fl = np.ascontiguousarray(np.concatenate(parts_v, axis=1))
    bucket_id = np.asarray(bucket_id)
    bucket_pos = np.asarray(bucket_pos)
    cnt = n_per[bucket_id]
    off = base[bucket_id] + bucket_pos * cnt
    n_kc = int(n_per.max())
    lut = off[..., None] + np.minimum(np.arange(n_kc), cnt[..., None] - 1)
    return (cols_fl, vals_fl, lut.astype(np.int32), cnt.astype(np.int32))


def make_sparse_grid_data(prob, p: int, row_batches: int = 1, *,
                          device="cuda", **kw) -> SparseGridData:
    """Sparse-layout grid from a dense ``Problem`` (tests / small data)."""
    csr = CSRMatrix.from_dense(prob.X)
    return sparse_grid_from_csr(csr, _np(prob.y), p, row_batches,
                                device=device, **kw)


def make_bucketed_grid_data(prob, p: int, row_batches: int = 1, *,
                            device="cuda", **kw) -> BucketedGridData:
    """Bucketed-layout grid from a dense ``Problem`` (tests / small
    data)."""
    csr = CSRMatrix.from_dense(prob.X)
    return bucketed_grid_from_csr(csr, _np(prob.y), p, row_batches,
                                  device=device, **kw)


# ------------------------------------------------- p -> p' re-blocking --
# Host numpy, as in the reference: the grid's tensors come to the host once,
# and a re-blocked grid goes back to the grid's own device at the end.


def grid_to_csr(data, m: int, d: int):
    """The global ``(m, d)`` ``CSRMatrix`` and labels (host numpy) of any
    grid layout: ``SparseGridData``, ``BucketedGridData`` or a dense
    ``GridData`` (anything with ``Xg``); ``m``/``d`` are the real sizes,
    trimming the tiler's padding.  Stored entries are the packed slots
    with ``vals != 0`` (the tilers' padding slots hold exactly 0 and the
    ingest drops explicit zeros), sorted back to (row, col) order, so a
    grid re-tiled from its CSR equals the grid, statistics included."""
    p, mb, db = data.p, data.mb, data.db
    if isinstance(data, BucketedGridData):
        qq, bb, ii, kk, vv = [], [], [], [], []
        bucket_id, bucket_pos = _np(data.bucket_id), _np(data.bucket_pos)
        for q in range(p):
            for b in range(p):
                k, s = int(bucket_id[q, b]), int(bucket_pos[q, b])
                vals = _np(data.vals_b[k][q, s])
                i, pos = np.nonzero(vals)
                qq.append(np.full(i.shape, q, np.int64))
                bb.append(np.full(i.shape, b, np.int64))
                ii.append(i.astype(np.int64))
                kk.append(_np(data.cols_b[k][q, s])[i, pos]
                          .astype(np.int64))
                vv.append(vals[i, pos])
        q_i, b_i, i_i = map(np.concatenate, (qq, bb, ii))
        local_cols, vals = np.concatenate(kk), np.concatenate(vv)
        rows, cols = q_i * mb + i_i, b_i * db + local_cols
    elif isinstance(data, SparseGridData):
        vals_g = _np(data.vals_g)
        q_i, b_i, i_i, pos = np.nonzero(vals_g)
        rows = q_i.astype(np.int64) * mb + i_i
        cols = (b_i.astype(np.int64) * db
                + _np(data.cols_g)[q_i, b_i, i_i, pos])
        vals = vals_g[q_i, b_i, i_i, pos]
    else:   # dense GridData-like
        X = _np(data.Xg).reshape(p * mb, -1)[:m, :d]
        return CSRMatrix.from_dense(X), _np(data.yg).reshape(-1)[:m]
    keep = (rows < m) & (cols < d)   # padding slots hold 0 anyway
    order = np.lexsort((cols[keep], rows[keep]))
    rows, cols, vals = rows[keep][order], cols[keep][order], vals[keep][order]
    indptr = np.zeros(m + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=m), out=indptr[1:])
    csr = CSRMatrix(indptr=indptr, indices=cols.astype(np.int32),
                    values=vals.astype(np.float32), shape=(m, d))
    return csr, _np(data.yg).reshape(-1)[:m]


def _grid_entries(data):
    """Stored entries of every processor shard of a packed grid, each in
    ascending (local row, global col) order (the order ``_tile_csr``
    receives them in from a CSR): per shard ``(idx, local_rows, vals)``,
    ``idx`` the global column."""
    p, db = data.p, data.db
    out = []
    if isinstance(data, SparseGridData):
        cols_g, vals_g = _np(data.cols_g), _np(data.vals_g)
        for q in range(p):
            # the tile cube walked row-major, (mb, p, K): nonzero yields
            # ascending (row, block, pos) = ascending (row, col)
            vq = vals_g[q].transpose(1, 0, 2)
            i, b, pos = np.nonzero(vq)
            idx = b * db + cols_g[q, b, i, pos].astype(np.int64)
            out.append((idx, i.astype(np.int64), vq[i, b, pos]))
    elif isinstance(data, BucketedGridData):
        bucket_id, bucket_pos = _np(data.bucket_id), _np(data.bucket_pos)
        for q in range(p):
            idx_l, row_l, val_l = [], [], []
            for b in range(p):
                k, s = int(bucket_id[q, b]), int(bucket_pos[q, b])
                vals = _np(data.vals_b[k][q, s])
                i, pos = np.nonzero(vals)
                idx_l.append(b * db + _np(data.cols_b[k][q, s])
                             [i, pos].astype(np.int64))
                row_l.append(i.astype(np.int64))
                val_l.append(vals[i, pos])
            idx = np.concatenate(idx_l)
            rows = np.concatenate(row_l)
            vals = np.concatenate(val_l)
            # block-major -> row-major; a stable sort keeps the blocks (and
            # the ascending columns within each) in order inside each row
            order = np.argsort(rows, kind="stable")
            out.append((idx[order], rows[order], vals[order]))
    else:
        raise TypeError(f"packed grid expected, got {type(data).__name__}")
    return out


def regrid_direct(data, m: int, d: int, p_new: int, row_batches: int = 1,
                  *, layout: str | None = None, k_align: int = SUBLANE,
                  pow2: bool = False, max_buckets: int = MAX_K_BUCKETS):
    """Re-block a packed grid onto the p' grid tile to tile, without the
    ``grid_to_csr`` round trip, on the grid's own device.

    Works when the padded sizes agree at both blockings and one of p, p'
    divides the other: a new shard is then r = p/p' old shards end to end
    (merge) or a contiguous row slice of one (split), both keeping the
    ascending (row, col) order, and the entries go through the same
    addressing pass and packers as a fresh tiling at p', so the result
    equals the round trip's grid field for field.  Returns ``None`` when
    the preconditions fail (``runtime.reshard.retile`` then takes the
    round trip).  ``layout`` may differ from the input's."""
    if not isinstance(data, (SparseGridData, BucketedGridData)):
        return None
    p, mb, db = data.p, data.mb, data.db
    if (pad_to_multiple(m, p) != pad_to_multiple(m, p_new)
            or pad_to_multiple(d, p) != pad_to_multiple(d, p_new)
            or (p % p_new and p_new % p)):
        return None
    if layout is None:
        layout = "bucketed" if isinstance(data, BucketedGridData) \
            else "sparse"
    if layout not in ("sparse", "bucketed"):
        return None
    m_pad, d_pad = p * mb, p * db
    mb2, db2 = m_pad // p_new, d_pad // p_new
    rb = max(1, mb2 // row_batches)
    n_rb = mb2 // rb

    old = _grid_entries(data)
    ents = []
    if p_new <= p:       # merge: new shard q' = old shards q'*r .. +r-1
        r = p // p_new
        for q2 in range(p_new):
            grp = old[q2 * r:(q2 + 1) * r]
            ents.append((np.concatenate([g[0] for g in grp]),
                         np.concatenate([g[1] + j * mb
                                         for j, g in enumerate(grp)]),
                         np.concatenate([g[2] for g in grp])))
    else:                # split: old shard q -> s contiguous row slices
        s = p_new // p
        for q in range(p):
            idx, rows, vals = old[q]
            cut = np.searchsorted(rows, np.arange(s + 1) * mb2)
            for j in range(s):
                lo, hi = cut[j], cut[j + 1]
                ents.append((idx[lo:hi], rows[lo:hi] - j * mb2,
                             vals[lo:hi]))

    tile_row_nnz = np.zeros((p_new, p_new, mb2), np.float32)
    tile_col_nnz = np.zeros((p_new, n_rb, d_pad), np.float32)
    k_raw = np.zeros((p_new, p_new), np.int64)
    addrs = []
    for q2, (idx, rows, vals) in enumerate(ents):
        addr, k_raw[q2], tile_row_nnz[q2], tile_col_nnz[q2] = \
            _shard_addressing(idx, rows, vals, mb2, p_new, db2,
                              rb, n_rb, d_pad)
        addrs.append(addr)
    # equal padded sizes keep the global row and column orders, so the
    # shard-shaped statistics re-block by a reshape
    shared = dict(
        yg=_np(data.yg).reshape(p_new, mb2),
        row_nnz_g=_np(data.row_nnz_g).reshape(p_new, mb2),
        col_nnz=_np(data.col_nnz),
        row_valid=_np(data.row_valid).reshape(p_new, mb2),
        p=p_new, mb=mb2, db=db2, tile_col_nnz_g=tile_col_nnz,
        tile_row_nnz_g=tile_row_nnz, k_per_tile=k_raw)
    dev = data.yg.device
    if layout == "sparse":
        return _pack_uniform(shared, addrs, dev, k_align=k_align, pow2=pow2)
    return _pack_bucketed(shared, addrs, dev, k_align=k_align,
                          max_buckets=max_buckets)


def csr_k_per_tile(csr: CSRMatrix, p: int) -> np.ndarray:
    """(p, p) per-tile raw packed widths — the ``auto`` skew probe, O(nnz)
    without building any grid."""
    m, d = csr.shape
    mb = pad_to_multiple(m, p) // p
    db = pad_to_multiple(d, p) // p
    k_raw = np.zeros((p, p), np.int64)
    for q in range(p):
        r0, r1 = min(q * mb, m), min((q + 1) * mb, m)
        lo, hi = csr.indptr[r0], csr.indptr[r1]
        if hi <= lo:
            continue
        local_rows = np.repeat(np.arange(r1 - r0, dtype=np.int64),
                               np.diff(csr.indptr[r0:r1 + 1]))
        seg = local_rows * p + csr.indices[lo:hi].astype(np.int64) // db
        k_raw[q] = np.bincount(seg, minlength=mb * p).reshape(mb, p) \
            .max(axis=0)
    return k_raw


def problem_k_per_tile(prob, p: int) -> np.ndarray:
    """``csr_k_per_tile`` for an in-memory dense ``Problem``."""
    X = _np(prob.X)
    m, d = X.shape
    m_pad, d_pad = pad_to_multiple(m, p), pad_to_multiple(d, p)
    nz = np.zeros((m_pad, d_pad), bool)
    nz[:m, :d] = X != 0
    mb, db = m_pad // p, d_pad // p
    return nz.reshape(p, mb, p, db).sum(axis=3).max(axis=1) \
        .astype(np.int64)


def tile_k_skew(k_per_tile) -> float:
    """``k_raw.max() / median`` (>= 1.0)."""
    k = np.maximum(np.asarray(k_per_tile, np.float64), 1.0)
    return float(k.max() / max(float(np.median(k)), 1.0))


def grid_nbytes(data) -> int:
    """Device-resident bytes of the packed tile arrays, from shapes."""
    if isinstance(data, BucketedGridData):
        return int(data.cols_fl.nbytes + data.vals_fl.nbytes
                   + data.bucket_id.nbytes + data.bucket_pos.nbytes
                   + data.chunk_lut.nbytes + data.chunk_cnt.nbytes)
    return int(data.cols_g.nbytes + data.vals_g.nbytes)


def packed_bytes_per_step(data) -> float:
    """Mean packed-tile bytes streamed per tile step (cols i32 + vals
    f32, mean over tiles)."""
    if isinstance(data, BucketedGridData):
        ks = np.asarray(data.bucket_ks)[_np(data.bucket_id)]
        return float(8 * data.mb * ks.mean())
    return float(8 * data.mb * data.K)
