"""The sparse block-step kernels' plain versions against the JAX reference.

The port's kernels are batched over the p processors of an inner
iteration; each processor's result is held against the reference's
Pallas kernels run in interpret mode (``repro.kernels.ops`` with
``interpret=True``, as ``tests/test_sparse.py`` runs them) and against
the independent oracles of both packages' ``ref.py``.  Six (loss, reg)
pairs x ``row_batches`` {1, 3}, with mb = 31 so that ``row_batches=3``
leaves a trailing row, which must pass through unchanged.  Tolerance
1e-5 (rtol and atol).  The CUDA kernels themselves run only on the card
(``chip_smoke.py``); here the wrappers' routing is checked.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, dso_sparse, ops, ref
from repro_torch.kernels.dso_update import _primal_update, active_block_stats
from repro_torch.sparse.format import (CSRMatrix, bucketed_grid_from_csr,
                                       sparse_grid_from_csr)

LOSS_REG_PAIRS = [("hinge", "l2"), ("hinge", "l1"), ("logistic", "l2"),
                  ("logistic", "l1"), ("square", "l2"), ("square", "l1")]
TOL = dict(rtol=1e-5, atol=1e-5)
P, M_ROWS, D = 4, 124, 96          # mb = 31, db = 24


# rows of _grids(edges=True): a row's entries in one block (24 = K there)
EDGE_ROW_NNZ = (0, 1, 16, 17, 24)


def _grids(row_batches, hot=False, edges=False):
    """Uniform and bucketed grids of one power-law CSR (>= 3 buckets).
    ``hot``: column 0 lies in every row besides the power-law draws, the
    column on which the shared route of the bucketed launch A sums every
    row's contribution in one CTA.  ``edges``: the block-ELL launch's
    edges instead: processors 0 and 3 hold nothing in their blocks at
    ``_blk_ids()`` (empty active tiles), and row i < 5 of each processor
    q's shard holds exactly ``EDGE_ROW_NNZ[i]`` entries, all in one block:
    q's active block for processors 1 and 2, the next one for 0 and 3 (so
    K = 24 = db: rows whose every slot is live)."""
    rng = np.random.default_rng(13 if edges else 12 if hot else 11)
    pop = np.arange(1, D + 1, dtype=np.float64) ** -1.3
    pop /= pop.sum()
    ks = rng.integers(2, 40, M_ROWS)          # ragged rows: 3 tile widths
    rows = [np.sort(rng.choice(D, size=k, replace=False, p=pop))
            for k in ks]
    if hot:
        rows = [np.union1d(r, [0]) for r in rows]
    if edges:
        mb, db = M_ROWS // P, D // P
        blk = _blk_ids().tolist()
        for r in range(M_ROWS):
            q, i = divmod(r, mb)
            if q in (0, 3):
                rows[r] = rows[r][rows[r] // db != blk[q]]
            if i < len(EDGE_ROW_NNZ):
                b = blk[q] if q in (1, 2) else (blk[q] + 1) % P
                rows[r] = b * db + np.sort(rng.choice(
                    db, EDGE_ROW_NNZ[i], replace=False))
    ks = np.array([len(r) for r in rows])
    cols = np.concatenate(rows)
    indptr = np.zeros(M_ROWS + 1, np.int64)
    np.cumsum(ks, out=indptr[1:])
    vals = rng.normal(0, 1, indptr[-1]).astype(np.float32)
    csr = CSRMatrix(indptr, cols.astype(np.int32), vals, (M_ROWS, D))
    y = np.where(rng.random(M_ROWS) < 0.5, 1.0, -1.0).astype(np.float32)
    return (sparse_grid_from_csr(csr, y, P, row_batches, device="cpu"),
            bucketed_grid_from_csr(csr, y, P, row_batches, device="cpu"))


def _state(grid, loss, seed=3):
    rng = np.random.default_rng(seed)
    p, mb, db = grid.p, grid.mb, grid.db
    y = grid.yg.numpy()
    alpha = y * rng.uniform(0.05, 0.95, (p, mb))
    if loss == "square":
        alpha = rng.normal(0, 0.5, (p, mb))
    f = lambda a: torch.tensor(np.asarray(a, np.float32))   # noqa: E731
    return dict(w_grid=f(rng.normal(0, 0.1, (p, db))),
                gw_grid=f(np.abs(rng.normal(0, 0.01, (p, db)))),
                alpha=f(alpha),
                ga=f(np.abs(rng.normal(0, 0.01, (p, mb)))))


def _scalars(loss, m):
    box = {"hinge": 31.6, "logistic": 26.3, "square": float("inf")}[loss]
    return (0.5, float(np.float32(1e-3)), float(m), -box, box)


def _blk_ids():
    return torch.tensor([2, 0, 3, 1], dtype=torch.int32)


def _jax_block(grid, st, q, b, row_batches):
    db = grid.db
    sl = slice(b * db, (b + 1) * db)
    return dict(y=grid.yg[q].numpy(), w=st["w_grid"][b].numpy(),
                alpha=st["alpha"][q].numpy(), gw=st["gw_grid"][b].numpy(),
                ga=st["ga"][q].numpy(),
                trn=grid.tile_row_nnz_g[q, b].numpy(),
                tcn=grid.tile_col_nnz_g[q, :row_batches, sl].numpy(),
                rn=grid.row_nnz_g[q].numpy(), cn=grid.col_nnz[sl].numpy())


def _check(name, got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **TOL)


def _check_processor(new, old, q, b, want, mk):
    """Processor q's slice of the batched in-place result vs a reference
    (w, alpha, gw, ga) tuple; rows past mk must be untouched."""
    w2, a2, gw2, ga2 = want
    _check(f"w q={q}", new["w_grid"][b], w2)
    _check(f"alpha q={q}", new["alpha"][q], a2)
    _check(f"gw q={q}", new["gw_grid"][b], gw2)
    _check(f"ga q={q}", new["ga"][q], ga2)
    for k in ("alpha", "ga"):
        assert torch.equal(new[k][q, mk:], old[k][q, mk:])


def _args(grid, st):
    return (grid.yg, st["w_grid"], st["alpha"], st["gw_grid"], st["ga"],
            grid.tile_row_nnz_g, grid.tile_col_nnz_g, grid.row_nnz_g,
            grid.col_nnz)


@pytest.mark.parametrize("row_batches", [1, 3])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_sparse_block_step_matches_reference(loss, reg, row_batches):
    _check_sparse_step(_grids(row_batches)[0], loss, reg, row_batches)


@pytest.mark.parametrize("row_batches", [1, 3])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_sparse_block_step_on_edge_rows_matches_reference(loss, reg,
                                                          row_batches):
    """Rows of 0, 1, 16, 17 and K live slots and empty active tiles: the
    edges of the block-ELL kernel's live-slot read and of the folded
    primal phase's skipped columns."""
    grid, _ = _grids(row_batches, edges=True)
    trn = grid.tile_row_nnz_g[torch.arange(P), _blk_ids().long()]
    assert grid.K == grid.db == max(EDGE_ROW_NNZ)
    assert {0, 1, 16, 17, grid.K} <= set(trn.long().unique().tolist())
    assert bool((trn[0] == 0).all()) and bool((trn[3] == 0).all())
    _check_sparse_step(grid, loss, reg, row_batches)


def _check_sparse_step(grid, loss, reg, row_batches):
    """The plain uniform-grid block step against the reference's
    interpret-mode Pallas kernel and both packages' oracles."""
    old = _state(grid, loss)
    new = {k: v.clone() for k, v in old.items()}
    scal = _scalars(loss, M_ROWS)
    blk = _blk_ids()
    dso_sparse.dso_sparse_block_step_plain(
        grid.cols_g, grid.vals_g, blk, *_args(grid, new), scal,
        row_batches=row_batches, loss_name=loss, reg_name=reg)
    mk = (grid.mb // row_batches) * row_batches
    sc = np.asarray(scal, np.float32)
    for q in range(P):
        b = int(blk[q])
        j = _jax_block(grid, old, q, b, row_batches)
        cols, vals = grid.cols_g[q, b].numpy(), grid.vals_g[q, b].numpy()
        kern = jops.dso_sparse_block_step(
            cols, vals, j["y"], j["w"], j["alpha"], j["gw"], j["ga"],
            j["trn"], j["tcn"], j["rn"], j["cn"], sc,
            row_batches=row_batches, loss_name=loss, reg_name=reg,
            interpret=True)
        _check_processor(new, old, q, b, kern, mk)
        oracle = ref.dso_sparse_block_step_ref(
            grid.cols_g[q, b][:mk], grid.vals_g[q, b][:mk],
            torch.from_numpy(j["y"][:mk]), old["w_grid"][b].clone(),
            old["alpha"][q][:mk].clone(), old["gw_grid"][b].clone(),
            old["ga"][q][:mk].clone(), grid.row_nnz_g[q][:mk],
            grid.col_nnz[b * grid.db:(b + 1) * grid.db], scal,
            row_batches=row_batches, loss_name=loss, reg_name=reg)
        j_oracle = jref.dso_sparse_block_step_ref(
            *map(jnp.asarray, (cols[:mk], vals[:mk], j["y"][:mk], j["w"],
                               j["alpha"][:mk], j["gw"], j["ga"][:mk],
                               j["rn"][:mk], j["cn"], sc)),
            row_batches=row_batches, loss_name=loss, reg_name=reg)
        for x, z, name in zip(oracle, j_oracle, "w alpha gw ga".split()):
            _check(f"oracle {name}", x, z)
        _check("oracle w", new["w_grid"][b], oracle[0])
        _check("oracle alpha", new["alpha"][q][:mk], oracle[1])


@pytest.mark.parametrize("row_batches", [1, 3])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_bucketed_block_step_matches_reference(loss, reg, row_batches):
    _check_bucketed_step(*_grids(row_batches), loss, reg, row_batches)


@pytest.mark.parametrize("row_batches", [1, 3])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_bucketed_block_step_with_a_hot_column_matches_reference(
        loss, reg, row_batches):
    """Column 0 in every row on top of the power-law draws: it lies in w
    block 0, so every processor's tile of that block holds it in every
    row."""
    uni, grid = _grids(row_batches, hot=True)
    assert bool((uni.cols_g[:, 0, :, 0] == 0).all())   # every row's first
    assert bool((uni.vals_g[:, 0, :, 0] != 0).all())   # slot: column 0
    _check_bucketed_step(uni, grid, loss, reg, row_batches)


def _check_bucketed_step(uni, grid, loss, reg, row_batches):
    """The plain bucketed block step against the uniform layout's, the
    reference's interpret-mode Pallas kernel and the port's oracle."""
    assert len(grid.bucket_ks) >= 3
    old = _state(grid, loss)
    new = {k: v.clone() for k, v in old.items()}
    scal = _scalars(loss, M_ROWS)
    blk = _blk_ids()
    dso_sparse.dso_bucketed_block_step_plain(
        grid.cols_fl, grid.vals_fl, grid.chunk_lut, grid.chunk_cnt, blk,
        *_args(grid, new), scal, row_batches=row_batches, loss_name=loss,
        reg_name=reg)
    # the same block step on the uniform layout agrees (identical tiles)
    via_uni = {k: v.clone() for k, v in old.items()}
    dso_sparse.dso_sparse_block_step_plain(
        uni.cols_g, uni.vals_g, blk, *_args(uni, via_uni), scal,
        row_batches=row_batches, loss_name=loss, reg_name=reg)
    for k in new:
        _check(f"bucketed vs uniform {k}", new[k], via_uni[k])
    mk = (grid.mb // row_batches) * row_batches
    sc = np.asarray(scal, np.float32)
    for q in range(P):
        b = int(blk[q])
        j = _jax_block(grid, old, q, b, row_batches)
        lut, cnt = grid.chunk_lut[q, b], grid.chunk_cnt[q, b]
        kern = jops.dso_bucketed_block_step(
            grid.cols_fl[q].numpy(), grid.vals_fl[q].numpy(), lut.numpy(),
            cnt.numpy(), j["y"], j["w"], j["alpha"], j["gw"], j["ga"],
            j["trn"], j["tcn"], j["rn"], j["cn"], sc,
            row_batches=row_batches, loss_name=loss, reg_name=reg,
            interpret=True)
        _check_processor(new, old, q, b, kern, mk)
        oracle = ref.dso_bucketed_block_step_ref(
            grid.cols_fl[q][:, :mk], grid.vals_fl[q][:, :mk], lut, cnt,
            torch.from_numpy(j["y"][:mk]), old["w_grid"][b].clone(),
            old["alpha"][q][:mk].clone(), old["gw_grid"][b].clone(),
            old["ga"][q][:mk].clone(), grid.row_nnz_g[q][:mk],
            grid.col_nnz[b * grid.db:(b + 1) * grid.db], scal,
            row_batches=row_batches, loss_name=loss, reg_name=reg)
        _check("oracle w", new["w_grid"][b], oracle[0])
        _check("oracle alpha", new["alpha"][q][:mk], oracle[1])
        _check("oracle ga", new["ga"][q][:mk], oracle[3])


@pytest.mark.parametrize("db,limit,route", [
    (1000, 4000, "shared"),              # at the budget
    (999, 4000, "shared"),               # below it
    # past the budget the global route was taken until the hot route came;
    # these cases keep the ids they had then (their route is the 3rd value)
    pytest.param(1001, 4000, "hot", id="1001-4000-global"),   # above it
    (5240, 232448, "shared"),            # real-sim's blocks on an H100
    (58112, 232448, "shared"),           # the widest that fits there
    pytest.param(338798, 232448, "hot",  # news20's blocks
                 id="338798-232448-global"),
    (58113, 232448, "hot"),              # one column past it
])
def test_bucketed_route_by_db_and_the_cards_limit(db, limit, route):
    assert dso_sparse.bucketed_route(db, limit) == route
    assert route in dso_sparse.BUCKETED_ROUTES


def _hot_table_numpy(cnt, p, db, slots):
    """The hot table by numpy: per block, columns by count descending,
    then index ascending; the first min(slots, db) get slots 0, 1, ..."""
    h = min(slots, db)
    hot = np.full((p, db), -1, np.int32)
    cols = np.zeros((p, h), np.int32)
    for b in range(p):
        c = cnt[b * db:(b + 1) * db]
        order = np.lexsort((np.arange(db), -c))[:h]
        hot[b, order] = np.arange(h)
        cols[b] = order
    return hot, cols


@pytest.mark.parametrize("p,db,slots,levels,seed", [
    (4, 24, 5, 3, 0),          # few slots, many ties
    (4, 24, 24, 3, 1),         # every column has a slot
    (4, 24, 100, 50, 2),       # more slots than columns
    (3, 1000, 64, 4, 3),       # heavy ties across the cut
    (1, 7, 3, 1, 4),           # all counts equal: the lowest indices
    (2, 5000, 777, 10000, 5),  # counts nearly distinct
])
def test_hot_table_matches_a_numpy_reference(p, db, slots, levels, seed):
    rng = np.random.default_rng(seed)
    cnt = rng.integers(1, levels + 1, p * db).astype(np.float32)
    hot, cols = dso_sparse.hot_table(torch.from_numpy(cnt), p, db, slots)
    want_hot, want_cols = _hot_table_numpy(cnt, p, db, slots)
    h = min(slots, db)
    assert hot.dtype == torch.int32 and cols.dtype == torch.int32
    assert tuple(hot.shape) == (p, db) and tuple(cols.shape) == (p, h)
    assert np.array_equal(hot.numpy(), want_hot)
    assert np.array_equal(cols.numpy(), want_cols)
    for b in range(p):
        row = hot[b].numpy()
        live = row >= 0
        assert live.sum() == h                       # h slots per block
        assert np.array_equal(np.sort(row[live]), np.arange(h))  # unique
        assert np.array_equal(cols[b].numpy()[row[live]],
                              np.flatnonzero(live))  # slot -> its column
        c = cnt[b * db:(b + 1) * db]
        if h < db:                                   # the hottest columns
            assert c[live].min() >= c[~live].max()


def test_bucketed_launch_refuses_an_unknown_route_or_a_bad_table():
    """The launcher raises on a route that does not exist and on a hot
    table given to the wrong route or of the wrong shape, before any
    kernel is built or launched."""
    _, bgrid = _grids(1)
    st = _state(bgrid, "logistic")
    a_args = (bgrid.cols_fl, bgrid.vals_fl, bgrid.chunk_lut, bgrid.chunk_cnt,
              _blk_ids(), bgrid.yg, st["w_grid"], st["alpha"], st["ga"],
              bgrid.tile_row_nnz_g, bgrid.row_nnz_g,
              torch.zeros_like(st["w_grid"]), 0, bgrid.mb, 0.5, 124.0,
              "logistic")
    table = dso_sparse.hot_table(bgrid.col_nnz, P, bgrid.db, 8)
    with pytest.raises(ValueError, match="no bucketed route"):
        dso_sparse.launch_bucketed_dual_scatter(*a_args, route="cuda_cores")
    with pytest.raises(ValueError, match="hot table"):
        dso_sparse.launch_bucketed_dual_scatter(*a_args, route="hot")
    with pytest.raises(ValueError, match="hot table"):
        dso_sparse.launch_bucketed_dual_scatter(*a_args, route="shared",
                                                hot=table)
    with pytest.raises(ValueError, match="hot table must be"):
        dso_sparse.launch_bucketed_dual_scatter(
            *a_args, route="hot", hot=(table[0][:, :-1], table[1]))


def test_primal_update_and_probe_plain_versions():
    grid, _ = _grids(3)
    st = _state(grid, "hinge")
    blk = _blk_ids()
    acc = torch.randn(P, grid.db, generator=torch.Generator().manual_seed(0))
    scal = _scalars("hinge", M_ROWS)
    w_old, gw_old = st["w_grid"].clone(), st["gw_grid"].clone()
    ops.dso_primal_update(blk, st["w_grid"], st["gw_grid"], acc.clone(),
                          grid.tile_col_nnz_g, grid.col_nnz, 1, scal,
                          reg_name="l2")
    for q in range(P):
        b = int(blk[q])
        sl = slice(b * grid.db, (b + 1) * grid.db)
        w2, _ = _primal_update("l2", w_old[b], gw_old[b], acc[q],
                               grid.tile_col_nnz_g[q, 1, sl],
                               grid.col_nnz[sl], scal)
        _check("primal", st["w_grid"][b], w2)
    cols = torch.tensor(np.arange(64).reshape(8, 8) % 5, dtype=torch.int32)
    w = torch.arange(128, dtype=torch.float32)
    out = ops.sparse_probe(cols, w)
    want = np.zeros(128, np.float32)
    np.add.at(want, cols.numpy().ravel(), w.numpy()[cols.numpy().ravel()])
    assert np.array_equal(out.numpy(), want)


@pytest.mark.parametrize("reg", ["l2", "l1"])
def test_primal_update_leaves_an_empty_column_bit_for_bit(reg):
    """What the folded step's primal phase relies on when it skips a
    column of count 0: with tcn = 0 and acc = 0 the step leaves w (0, the
    box's ends, anywhere inside it) and gw (0 or not) bit for bit as they
    were."""
    scal = _scalars("hinge", M_ROWS)
    w_hi = float(np.float32(scal[4]))
    rng = np.random.default_rng(5)
    w = torch.tensor(np.concatenate([[0.0, w_hi, -w_hi],
                                     rng.uniform(-w_hi, w_hi, 61)]),
                     dtype=torch.float32)
    cn = torch.tensor(rng.integers(1, 50, w.numel()), dtype=torch.float32)
    zero = torch.zeros_like(w)
    for gw in (zero, torch.tensor(np.abs(rng.normal(0, 1, w.numel())),
                                  dtype=torch.float32)):
        w2, gw2 = _primal_update(reg, w, gw, zero, zero, cn,
                                 scal[:3] + (-w_hi, w_hi))
        assert torch.equal(w2.view(torch.int32), w.view(torch.int32))
        assert torch.equal(gw2.view(torch.int32), gw.view(torch.int32))


@pytest.mark.parametrize("reg", ["l2", "l1"])
def test_primal_update_of_the_live_columns_equals_the_full_one(reg):
    """On a power-law grid, for every row tile: the primal step of only the
    columns the tile holds (tcn > 0), the others kept, equals the step of
    every column bit for bit, with acc = X^T alpha of the tile's rows (0
    on the columns it does not hold)."""
    grid, _ = _grids(3)
    st = _state(grid, "logistic")
    scal = _scalars("logistic", M_ROWS)
    b = _blk_ids().long()
    q = torch.arange(P)
    cn, _, tcn = active_block_stats(grid.tile_row_nnz_g, grid.tile_col_nnz_g,
                                    grid.col_nnz, b)
    w, gw = st["w_grid"][b], st["gw_grid"][b]
    rb = grid.mb // 3
    for s in range(3):
        rows = slice(s * rb, (s + 1) * rb)
        c = grid.cols_g[q, b][:, rows].reshape(P, -1).long()
        v = grid.vals_g[q, b][:, rows] * st["alpha"][:, rows, None]
        acc = torch.zeros_like(w).scatter_add_(1, c, v.reshape(P, -1))
        t = tcn[:, s]
        live = t != 0
        assert bool(live.any()) and not bool(live.all())
        assert bool((acc[~live] == 0).all())
        w_all, gw_all = _primal_update(reg, w, gw, acc, t, cn, scal)
        w_live, gw_live = w.clone(), gw.clone()
        w_live[live], gw_live[live] = _primal_update(
            reg, w[live], gw[live], acc[live], t[live], cn[live], scal)
        assert torch.equal(w_live.view(torch.int32), w_all.view(torch.int32))
        assert torch.equal(gw_live.view(torch.int32),
                           gw_all.view(torch.int32))


class _FailingLibrary:
    """A kernel library whose every entry point records its arguments and
    returns cudaErrorCooperativeLaunchTooLarge (720)."""

    def __init__(self):
        self.calls = []
        self.lib = self

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 720
        return entry


@pytest.mark.parametrize("route", ["block-ELL", "shared", "hot"])
def test_folded_launchers_raise_on_an_error_from_their_entry(monkeypatch,
                                                             route):
    """A folded step whose cooperative launch the card refuses raises,
    through ``build.check``: the launcher passes the entry point's error
    on, with as many arguments as its signature has."""
    failing = _FailingLibrary()
    monkeypatch.setattr(dso_sparse, "library", lambda: failing)
    monkeypatch.setattr(dso_sparse, "_stream", lambda t: 0)
    uni, grid = _grids(1)
    st = _state(grid, "hinge")
    scal = _scalars("hinge", M_ROWS)
    rows = (st["w_grid"], st["gw_grid"], st["alpha"], st["ga"],
            grid.tile_row_nnz_g, grid.row_nnz_g, grid.tile_col_nnz_g,
            grid.col_nnz)
    if route == "block-ELL":
        entry = "dso_sparse_block_step"
        acc = torch.zeros(dso_sparse.ELL_ACC_COPIES * P, grid.db)
        launch = lambda: dso_sparse.launch_sparse_block_step(  # noqa: E731
            uni.cols_g, uni.vals_g, _blk_ids(), uni.yg, *rows, acc, 0,
            uni.mb, scal, "hinge", "l2")
    else:
        entry = f"dso_bucketed_block_step_{route}"
        hot = dso_sparse.hot_table(grid.col_nnz, P, grid.db, 8) \
            if route == "hot" else None
        launch = lambda: dso_sparse.launch_bucketed_block_step(  # noqa: E731
            grid.cols_fl, grid.vals_fl, grid.chunk_lut, grid.chunk_cnt,
            _blk_ids(), grid.yg, *rows, torch.zeros(P, grid.db), 0, grid.mb,
            scal, "hinge", "l2", route=route, hot=hot)
    with pytest.raises(RuntimeError, match=f"{entry}: CUDA launch failed "
                                           f"with cudaError 720"):
        launch()
    [(name, args)] = failing.calls
    assert name == entry and len(args) == len(build.SIGNATURES[entry])


def test_wrappers_route_cpu_tensors_to_the_plain_version():
    grid, bgrid = _grids(3)
    scal = _scalars("logistic", M_ROWS)
    a, b = _state(grid, "logistic"), _state(grid, "logistic")
    dso_sparse.dso_sparse_block_step_plain(
        grid.cols_g, grid.vals_g, _blk_ids(), *_args(grid, a), scal,
        row_batches=3, loss_name="logistic", reg_name="l1")
    before = ops.launch_counts()
    ops.dso_sparse_block_step(
        grid.cols_g, grid.vals_g, _blk_ids(), *_args(grid, b), scal,
        row_batches=3, loss_name="logistic", reg_name="l1")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    c, d = _state(bgrid, "square"), _state(bgrid, "square")
    dso_sparse.dso_bucketed_block_step_plain(
        bgrid.cols_fl, bgrid.vals_fl, bgrid.chunk_lut, bgrid.chunk_cnt,
        _blk_ids(), *_args(bgrid, c), scal, row_batches=3,
        loss_name="square", reg_name="l2")
    ops.dso_bucketed_block_step(
        bgrid.cols_fl, bgrid.vals_fl, bgrid.chunk_lut, bgrid.chunk_cnt,
        _blk_ids(), *_args(bgrid, d), scal, row_batches=3,
        loss_name="square", reg_name="l2")
    for k in c:
        assert torch.equal(c[k], d[k]), k
    assert ops.launch_counts() == before     # the plain path launches none


def test_wrappers_refuse_bad_inputs_and_other_devices():
    grid, _ = _grids(1)
    st = _state(grid, "hinge")
    scal = _scalars("hinge", M_ROWS)
    with pytest.raises(TypeError, match="blk_ids"):
        ops.dso_sparse_block_step(
            grid.cols_g, grid.vals_g, _blk_ids().long(), *_args(grid, st),
            scal, row_batches=1, loss_name="hinge", reg_name="l2")
    strided_w = st["w_grid"].repeat(1, 2)[:, ::2]     # same shape, strided
    with pytest.raises(ValueError, match="contiguous"):
        ops.dso_sparse_block_step(
            grid.cols_g, grid.vals_g, _blk_ids(), grid.yg, strided_w,
            *_args(grid, st)[2:], scal, row_batches=1, loss_name="hinge",
            reg_name="l2")
    meta = {k: v.to("meta") for k, v in st.items()}
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.dso_sparse_block_step(
            grid.cols_g.to("meta"), grid.vals_g.to("meta"),
            _blk_ids().to("meta"),
            *(t.to("meta") for t in _args(grid, meta)), scal,
            row_batches=1, loss_name="hinge", reg_name="l2")


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs the kernels")
    with pytest.raises(RuntimeError, match="cuda"):
        ops.sparse_kernel_error(torch.device("cuda"))
    assert ops.sparse_kernel_error(torch.device("cpu")) is not None
