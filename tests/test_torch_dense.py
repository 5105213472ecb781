"""The port's dense slice against the JAX reference (CPU, small sizes).

Inputs are made with numpy from a seed and handed to both packages:

- ``make_grid_data`` equals the reference's field for field
  (``np.array_equal``) with m and d that p does not divide;
- ``engine.update.block_tile_step`` within 1e-6 of the reference's;
- the plain versions of the dense kernels, ``dso_block_step_plain`` and
  ``dso_tile_step_plain`` (what ``ops.dso_block_step`` /
  ``ops.dso_tile_step`` run on CPU tensors), within 1e-5 of the reference's
  Pallas kernels run in interpret mode, its one-launch path and its
  ``force_scan`` path, with a trailing row that must pass through, also
  at block widths 1, 3 and 5 and on a tile whose row stride is not a
  multiple of 4 (the dense kernel's head, tail and 4-byte paths);
- ``solve`` on the three dense backends within 1e-5 of the reference's
  ``solve(backend="dense_jnp")`` for {cyclic, lpt} x six (loss, reg) pairs
  at the reference's own sizes (m 120, d 60; l1's sign flips are
  sensitive at other sizes);
- a reference ``GridData`` and ``DSOState`` carried across as numpy arrays
  continue in the port like the reference;
- the legacy two-pass tile step (``ops.dso_tile_step(twopass=True)``, its
  plain version on CPU tensors) within 1e-5 of the reference's two-pass
  Pallas kernels in interpret mode and of the port's fused step, for the
  six pairs;
- the port's dense oracles ``dso_tile_step_ref`` and ``dso_block_step_ref``
  within 1e-5 of the reference's;
- ``solve`` on ``dense_jnp`` at the engine's corners (``CORNERS``: p 1, 3
  and 5, shapes they do not divide, alpha0 0 and 0.3, row_batches 1 and
  2) within 1e-5 of the reference's.

The dense CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.synthetic as jsyn
import repro.engine as je
import repro_torch.data.synthetic as tsyn
import repro_torch.engine as te
from repro.engine import update as jupdate
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core.losses import w_bounds
from repro_torch.engine import schedules as tsched
from repro_torch.engine import update as tupdate
from repro_torch.kernels import dso_update, ops
from repro_torch.kernels import ref as tref

LOSS_REG_PAIRS = [("hinge", "l2"), ("hinge", "l1"), ("logistic", "l2"),
                  ("logistic", "l1"), ("square", "l2"), ("square", "l1")]
TOL = dict(rtol=1e-5, atol=1e-5)
P = 4


def _check(name, got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               err_msg=name, **tol)


def _pair(loss, reg, seed=1, m=120, d=60):
    """The same problem in both packages, in the dense regime (density
    0.15 >= the sparse threshold 0.1)."""
    if loss == "square":
        kw = dict(m=m, d=d, density=0.15, seed=seed, reg=reg)
        return (jsyn.make_regression(**kw),
                tsyn.make_regression(**kw, device="cpu"))
    kw = dict(m=m, d=d, density=0.15, loss=loss, lam=1e-3, seed=seed,
              reg=reg)
    return (jsyn.make_classification(**kw),
            tsyn.make_classification(**kw, device="cpu"))


def _scalars(loss, m, lam=1e-3):
    lo, hi = w_bounds(loss, lam)
    return (0.5, float(np.float32(lam)), float(m), lo, hi)


def _state(p, mb, db, y, loss, seed=3):
    rng = np.random.default_rng(seed)
    alpha = y * rng.uniform(0.05, 0.95, (p, mb))
    if loss == "square":
        alpha = rng.normal(0, 0.5, (p, mb))
    f = lambda a: torch.tensor(np.asarray(a, np.float32))   # noqa: E731
    return dict(w_grid=f(rng.normal(0, 0.1, (p, db))),
                gw_grid=f(np.abs(rng.normal(0, 0.01, (p, db)))),
                alpha=f(alpha),
                ga=f(np.abs(rng.normal(0, 0.01, (p, mb)))))


# ------------------------------------------------------------ the grid --


@pytest.mark.parametrize("stats_rows", [5, 1 << 13])
@pytest.mark.parametrize("row_batches", [1, 3])
@pytest.mark.parametrize("p", [2, 4])
def test_make_grid_data_matches_reference(p, row_batches, stats_rows,
                                          monkeypatch):
    """Also when the statistics are counted in several passes of rows
    (``stats_rows`` 5 cuts every row batch)."""
    monkeypatch.setattr(te.data, "_STATS_ROWS", stats_rows)
    kw = dict(m=61, d=47, density=0.3, seed=7)      # 61, 47: odd
    jp = jsyn.make_classification(**kw)
    tp = tsyn.make_classification(**kw, device="cpu")
    j = je.data.make_grid_data(jp, p, row_batches)
    t = te.make_grid_data(tp, p, row_batches)
    assert type(t).__name__ == "GridData"
    assert t._fields == j._fields
    for f in j._fields:
        a, b = getattr(t, f), getattr(j, f)
        if f in ("p", "mb", "db"):
            assert a == b, f
        else:
            assert a.dtype == torch.float32, f
            assert np.array_equal(a.numpy(), np.asarray(b)), f
    tile = te.as_tile_data(t)
    assert tile.layout == "dense" and tile.arrays[0] is t.Xg
    te.check_tile_stats(t, row_batches)
    with pytest.raises(ValueError, match="make_grid_data"):
        te.check_tile_stats(t, row_batches + 1)
    assert te.tile_dims(t) == te.tile_dims(tile) == (p, t.mb, t.db)


def test_make_grid_data_without_padding_adds_no_copy_of_x():
    _, tp = _pair("hinge", "l2")                 # 120 x 60, p = 4
    g = te.make_grid_data(tp, P, 3)
    assert g.Xg.data_ptr() == tp.X.data_ptr()
    assert g.Xg.shape == (P, 30, 60)


# ---------------------------------------------------------- tile math --


@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_block_tile_step_matches_reference(loss, reg):
    rng = np.random.default_rng(2)
    rows, db = 23, 17
    X = (rng.normal(0, 1, (rows, db))
         * (rng.random((rows, db)) < 0.6)).astype(np.float32)
    y = np.where(rng.random(rows) < 0.5, 1.0, -1.0).astype(np.float32)
    st = _state(1, rows, db, y[None], loss)
    vec = {k: v[0].numpy() for k, v in st.items()}
    rn = rng.integers(1, 9, rows).astype(np.float32)
    cn = rng.integers(1, 9, db).astype(np.float32)
    lo, hi = w_bounds(loss, 1e-3)
    kw = dict(eta_t=0.5, lam=1e-3, m=float(rows), loss_name=loss,
              reg_name=reg, use_adagrad=True, w_lo=lo, w_hi=hi)
    arrs = dict(X_tile=X, y_tile=y, w_blk=vec["w_grid"],
                alpha_blk=vec["alpha"], gw_blk=vec["gw_grid"],
                ga_blk=vec["ga"], row_nnz_tile=rn, col_nnz_blk=cn)
    want = jupdate.block_tile_step(
        **{k: jnp.asarray(v) for k, v in arrs.items()}, **kw)
    got = tupdate.block_tile_step(
        **{k: torch.from_numpy(v) for k, v in arrs.items()}, **kw)
    for g, w, name in zip(got, want, "w alpha gw ga".split()):
        _check(name, g, w, dict(rtol=1e-6, atol=1e-6))
    # a leading batch dimension is the same step per slice (a batched
    # product may sum in another order)
    stack = {k: torch.from_numpy(np.stack([v, v[::-1].copy()]))
             for k, v in arrs.items()}
    batched = tupdate.block_tile_step(**stack, **kw)
    flipped = tupdate.block_tile_step(
        **{k: s[1] for k, s in stack.items()}, **kw)
    for g, a, b in zip(batched, got, flipped):
        _check("batch 0", g[0], a, dict(rtol=1e-6, atol=1e-6))
        _check("batch 1", g[1], b, dict(rtol=1e-6, atol=1e-6))


# -------------------------------------------------- the kernels' plain --


def _grid(row_batches):
    """A 124 x 96 problem with zeros: p = 4, mb = 31 (row_batches = 3
    leaves a trailing row), db = 24."""
    _, tp = _pair("hinge", "l2", seed=11, m=124, d=96)
    return te.make_grid_data(tp, P, row_batches)


@pytest.mark.parametrize("row_batches", [1, 3])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_dso_block_step_plain_matches_reference(loss, reg, row_batches):
    grid = _grid(row_batches)
    p, mb, db = grid.p, grid.mb, grid.db
    old = _state(p, mb, db, grid.yg.numpy(), loss)
    new = {k: v.clone() for k, v in old.items()}
    scal = _scalars(loss, 124)
    blk = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    args = (grid.yg, new["w_grid"], new["alpha"], new["gw_grid"], new["ga"],
            grid.tile_row_nnz_g, grid.tile_col_nnz_g, grid.row_nnz_g,
            grid.col_nnz)
    dso_update.dso_block_step_plain(grid.Xg, blk, *args, scal,
                                    row_batches=row_batches, loss_name=loss,
                                    reg_name=reg)
    # the wrapper routes CPU tensors to the plain version, launching none
    via_ops = {k: v.clone() for k, v in old.items()}
    before = ops.launch_counts()
    ops.dso_block_step(grid.Xg, blk, grid.yg, via_ops["w_grid"],
                       via_ops["alpha"], via_ops["gw_grid"], via_ops["ga"],
                       *args[5:], scal, row_batches=row_batches,
                       loss_name=loss, reg_name=reg)
    assert ops.launch_counts() == before
    for k in new:
        assert torch.equal(via_ops[k], new[k]), k
    mk = (mb // row_batches) * row_batches
    sc = np.asarray(scal, np.float32)
    for q in range(p):
        b = int(blk[q])
        cols = slice(b * db, (b + 1) * db)
        j = dict(X=grid.Xg[q, :, cols].numpy(), y=grid.yg[q].numpy(),
                 w=old["w_grid"][b].numpy(), alpha=old["alpha"][q].numpy(),
                 gw=old["gw_grid"][b].numpy(), ga=old["ga"][q].numpy(),
                 trn=grid.tile_row_nnz_g[q, b].numpy(),
                 tcn=grid.tile_col_nnz_g[q, :row_batches, cols].numpy(),
                 rn=grid.row_nnz_g[q].numpy(), cn=grid.col_nnz[cols].numpy())
        for force_scan in (False, True):
            w2, a2, gw2, ga2 = jops.dso_block_step(
                j["X"], j["y"], j["w"], j["alpha"], j["gw"], j["ga"],
                j["trn"], j["tcn"], j["rn"], j["cn"], sc,
                row_batches=row_batches, loss_name=loss, reg_name=reg,
                interpret=True, force_scan=force_scan)
            tag = f"q={q} force_scan={force_scan}"
            _check(f"w {tag}", new["w_grid"][b], w2)
            _check(f"alpha {tag}", new["alpha"][q], a2)
            _check(f"gw {tag}", new["gw_grid"][b], gw2)
            _check(f"ga {tag}", new["ga"][q], ga2)
        for k in ("alpha", "ga"):                 # trailing rows untouched
            assert torch.equal(new[k][q, mk:], old[k][q, mk:])
        if row_batches == 1:                      # no zeros derived: oracle
            oracle = jref.dso_block_step_ref(
                *map(jnp.asarray, (j["X"], j["y"], j["w"], j["alpha"],
                                   j["gw"], j["ga"], j["rn"], j["cn"], sc)),
                row_batches=1, loss_name=loss, reg_name=reg)
            _check(f"oracle w q={q}", new["w_grid"][b], oracle[0])


@pytest.mark.parametrize("kind", ["block", "tile"])
@pytest.mark.parametrize("db", [1, 3, 5])
def test_dense_plain_steps_at_narrow_blocks_match_reference(db, kind):
    """The block widths under a 16-byte slot of the dense kernel (db 1, 3,
    5): the block step on a p = 4 grid with a padded column and a trailing
    row at row_batches 3 (mb 10), and the tile step on a view whose row stride
    (4 db + 1) is not a multiple of 4; plain versions within 1e-5 of the
    reference's interpret-mode Pallas."""
    loss, reg = "logistic", "l2"
    if kind == "block":
        _, tp = _pair(loss, reg, seed=db, m=39, d=4 * db - 1)
        grid = te.make_grid_data(tp, P, 3)
        p, mb = grid.p, grid.mb
        assert grid.db == db
        old = _state(p, mb, db, grid.yg.numpy(), loss)
        new = {k: v.clone() for k, v in old.items()}
        blk = torch.tensor([3, 2, 0, 1], dtype=torch.int32)
        scal = _scalars(loss, 39)
        dso_update.dso_block_step_plain(
            grid.Xg, blk, grid.yg, new["w_grid"], new["alpha"],
            new["gw_grid"], new["ga"], grid.tile_row_nnz_g,
            grid.tile_col_nnz_g, grid.row_nnz_g, grid.col_nnz, scal,
            row_batches=3, loss_name=loss, reg_name=reg)
        sc = np.asarray(scal, np.float32)
        for q in range(p):
            b = int(blk[q])
            cols = slice(b * db, (b + 1) * db)
            want = jops.dso_block_step(
                grid.Xg[q, :, cols].numpy(), grid.yg[q].numpy(),
                old["w_grid"][b].numpy(), old["alpha"][q].numpy(),
                old["gw_grid"][b].numpy(), old["ga"][q].numpy(),
                grid.tile_row_nnz_g[q, b].numpy(),
                grid.tile_col_nnz_g[q, :3, cols].numpy(),
                grid.row_nnz_g[q].numpy(), grid.col_nnz[cols].numpy(), sc,
                row_batches=3, loss_name=loss, reg_name=reg, interpret=True)
            for name, g, w in zip("w alpha gw ga".split(),
                                  (new["w_grid"][b], new["alpha"][q],
                                   new["gw_grid"][b], new["ga"][q]), want):
                _check(f"{name} q={q}", g, w)
        return
    rng = np.random.default_rng(db)
    M, ld = 37, 4 * db + 1
    big = (rng.normal(0, 1, (M, ld))
           * (rng.random((M, ld)) < 0.7)).astype(np.float32)
    X = np.ascontiguousarray(big[:, 1:1 + db])
    y = np.where(rng.random(M) < 0.5, 1.0, -1.0).astype(np.float32)
    st = _state(1, M, db, y[None], loss)
    v = {k: t[0].numpy() for k, t in st.items()}
    rn = np.maximum((big != 0).sum(1), 1).astype(np.float32)
    cn = np.maximum((X != 0).sum(0) + 1, 1).astype(np.float32)
    scal = _scalars(loss, M)
    want = jops.dso_tile_step(X, y, v["w_grid"], v["alpha"], v["gw_grid"],
                              v["ga"], rn, cn, np.asarray(scal, np.float32),
                              loss_name=loss, reg_name=reg, interpret=True)
    T = torch.from_numpy
    view = T(big)[:, 1:1 + db]
    assert view.stride(0) % 4 != 0
    got = ops.dso_tile_step(view, T(y), T(v["w_grid"]), T(v["alpha"]),
                            T(v["gw_grid"]), T(v["ga"]), T(rn), T(cn), scal,
                            loss_name=loss, reg_name=reg)
    for name, g, w in zip("w alpha gw ga".split(), got, want):
        _check(name, g, w)


@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_dso_tile_step_plain_matches_reference(loss, reg):
    rng = np.random.default_rng(4)
    M, D = 37, 50                       # not multiples of (256, 512)
    big = (rng.normal(0, 1, (M, D + 9))
           * (rng.random((M, D + 9)) < 0.5)).astype(np.float32)
    X = np.ascontiguousarray(big[:, 4:4 + D])
    y = np.where(rng.random(M) < 0.5, 1.0, -1.0).astype(np.float32)
    st = _state(1, M, D, y[None], loss)
    v = {k: t[0].numpy() for k, t in st.items()}
    rn = np.maximum((big != 0).sum(1), 1).astype(np.float32)
    cn = np.maximum((X != 0).sum(0) + 2, 1).astype(np.float32)
    scal = _scalars(loss, M)
    want = jops.dso_tile_step(X, y, v["w_grid"], v["alpha"], v["gw_grid"],
                              v["ga"], rn, cn, np.asarray(scal, np.float32),
                              loss_name=loss, reg_name=reg, interpret=True)
    T = torch.from_numpy
    vecs = (T(y), T(v["w_grid"]), T(v["alpha"]), T(v["gw_grid"]),
            T(v["ga"]), T(rn), T(cn))
    before = ops.launch_counts()
    got = ops.dso_tile_step(T(X), *vecs, scal, loss_name=loss, reg_name=reg)
    strided = ops.dso_tile_step(T(big)[:, 4:4 + D], *vecs, scal,
                                loss_name=loss, reg_name=reg)
    nz = T(X) != 0
    plain = dso_update.dso_tile_step_plain(
        T(X), *vecs, scal, loss_name=loss, reg_name=reg,
        tile_row_nnz=nz.sum(1).float(), tile_col_nnz=nz.sum(0).float())
    assert ops.launch_counts() == before
    for name, g, s, pl, w in zip("w alpha gw ga".split(), got, strided,
                                 plain, want):
        _check(name, g, w)
        assert torch.equal(g, s) and torch.equal(g, pl), name
    assert torch.equal(vecs[1], T(v["w_grid"]))     # inputs unchanged


def _tile_problem(loss, seed=4):
    """A 37 x 50 tile (not multiples of the reference's (256, 512) blocks)
    cut from a wider array, with its vectors; numpy."""
    rng = np.random.default_rng(seed)
    M, D = 37, 50
    big = (rng.normal(0, 1, (M, D + 9))
           * (rng.random((M, D + 9)) < 0.5)).astype(np.float32)
    X = np.ascontiguousarray(big[:, 4:4 + D])
    y = np.where(rng.random(M) < 0.5, 1.0, -1.0).astype(np.float32)
    st = _state(1, M, D, y[None], loss)
    v = {k: t[0].numpy() for k, t in st.items()}
    rn = np.maximum((big != 0).sum(1), 1).astype(np.float32)
    cn = np.maximum((X != 0).sum(0) + 2, 1).astype(np.float32)
    return big, X, (y, v["w_grid"], v["alpha"], v["gw_grid"], v["ga"], rn,
                    cn)


@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_dso_tile_step_twopass_matches_reference(loss, reg):
    big, X, vecs = _tile_problem(loss)
    M, D = X.shape
    scal = _scalars(loss, M)
    kw = dict(loss_name=loss, reg_name=reg)
    want = jops.dso_tile_step(X, *vecs, np.asarray(scal, np.float32), **kw,
                              interpret=True, twopass=True)
    T = torch.from_numpy
    tv = tuple(map(T, vecs))
    before = ops.launch_counts()
    got = ops.dso_tile_step(T(X), *tv, scal, **kw, twopass=True)
    strided = ops.dso_tile_step(T(big)[:, 4:4 + D], *tv, scal, **kw,
                                twopass=True)
    fused = ops.dso_tile_step(T(X), *tv, scal, **kw)
    assert ops.launch_counts() == before
    for name, g, s, f, w in zip("w alpha gw ga".split(), got, strided,
                                fused, want):
        _check(name, g, w)
        _check(f"{name} vs fused", g, f)
        assert torch.equal(g, s), name
    assert torch.equal(tv[2], T(vecs[2]))           # inputs unchanged


@pytest.mark.parametrize("row_batches", [1, 3])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_dense_oracles_match_reference(loss, reg, row_batches):
    """``dso_block_step_ref`` over 3 row tiles (a trailing row), and
    ``dso_tile_step_ref`` once over the whole tile."""
    _, X, vecs = _tile_problem(loss, seed=6)
    scal = _scalars(loss, X.shape[0])
    kw = dict(loss_name=loss, reg_name=reg)
    j_args = [jnp.asarray(a) for a in (X, *vecs,
                                       np.asarray(scal, np.float32))]
    t_args = [torch.from_numpy(a) for a in (X, *vecs)] + [scal]
    got = tref.dso_block_step_ref(*t_args, row_batches=row_batches, **kw)
    want = jref.dso_block_step_ref(*j_args, row_batches=row_batches, **kw)
    if row_batches == 1:
        tile = tref.dso_tile_step_ref(*t_args, **kw)
        for g, t in zip(got, tile):
            assert torch.equal(g, t)
        want = jref.dso_tile_step_ref(*j_args, **kw)
    for name, g, w in zip("w alpha gw ga".split(), got, want):
        _check(name, g, w)


def test_dense_wrappers_refuse_bad_inputs():
    grid = _grid(1)
    st = _state(grid.p, grid.mb, grid.db, grid.yg.numpy(), "hinge")
    blk = torch.tensor([1, 0, 3, 2], dtype=torch.int32)
    rest = (grid.tile_row_nnz_g, grid.tile_col_nnz_g, grid.row_nnz_g,
            grid.col_nnz, _scalars("hinge", 124))
    kw = dict(row_batches=1, loss_name="hinge", reg_name="l2")
    with pytest.raises(TypeError, match="blk_ids"):
        ops.dso_block_step(grid.Xg, blk.long(), grid.yg, st["w_grid"],
                           st["alpha"], st["gw_grid"], st["ga"], *rest, **kw)
    with pytest.raises(ValueError, match="Xg"):
        ops.dso_block_step(grid.Xg[:, :-1], blk, grid.yg, st["w_grid"],
                           st["alpha"], st["gw_grid"], st["ga"], *rest, **kw)
    X = grid.Xg[0]
    vecs = (grid.yg[0], st["w_grid"].reshape(-1), st["alpha"][0],
            st["gw_grid"].reshape(-1), st["ga"][0], grid.row_nnz_g[0],
            grid.col_nnz)
    with pytest.raises(ValueError, match="tile_row_nnz"):
        ops.dso_tile_step(X, *vecs, rest[-1], loss_name="hinge",
                          reg_name="l2", twopass=True,
                          tile_col_nnz=(X != 0).sum(0).float())
    with pytest.raises(ValueError, match="column stride"):
        ops.dso_tile_step(X.t(), *vecs, rest[-1], loss_name="hinge",
                          reg_name="l2")


# --------------------------------------------------------------- solve --


@functools.lru_cache(maxsize=None)
def _reference_run(loss, reg, schedule):
    jp, _ = _pair(loss, reg)
    return je.solve(jp, backend="dense_jnp", schedule=schedule, p=P,
                    epochs=3, eta0=0.5, row_batches=3)


@pytest.mark.parametrize("schedule", ["cyclic", "lpt"])
@pytest.mark.parametrize("backend", ["dense_jnp", "dense_pallas_block",
                                     "dense_pallas_fused"])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_dense_solve_matches_reference(loss, reg, backend, schedule):
    r_j = _reference_run(loss, reg, schedule)
    _, tp = _pair(loss, reg)
    r_t = te.solve(tp, backend=backend, schedule=schedule, p=P, epochs=3,
                   eta0=0.5, row_batches=3, device="cpu")
    _check("w", r_t.w, r_j.w)
    _check("alpha", r_t.alpha, r_j.alpha)
    assert len(r_t.history) == len(r_j.history)
    for h_t, h_j in zip(r_t.history, r_j.history):
        assert h_t.keys() == h_j.keys() and h_t["epoch"] == h_j["epoch"]
        for k in h_j:
            _check(k, h_t[k], h_j[k])


def test_grid_and_state_carried_across_continue_like_the_reference():
    jp, tp = _pair("logistic", "l2", seed=3)
    kw = dict(backend="dense_jnp", p=P, eta0=0.5, row_batches=3,
              alpha0=0.0005, eval_hook=None)
    j2 = je.solve(jp, epochs=2, **kw)
    j3 = je.solve(jp, epochs=3, **kw)
    j_grid = je.data.make_grid_data(jp, P, 3)
    grid = te.tile_data_from_arrays(
        {k: np.asarray(v) for k, v in j_grid._asdict().items()},
        device="cpu")
    mine = te.make_grid_data(tp, P, 3)
    assert isinstance(grid, te.GridData)
    for f in te.GridData._fields:
        a, b = getattr(grid, f), getattr(mine, f)
        assert (a == b) if f in ("p", "mb", "db") else torch.equal(a, b), f
    state = te.state_from_arrays(
        {k: np.asarray(v) for k, v in j2.state._asdict().items()},
        device="cpu")
    lam, m, loss, reg, _, w_lo, w_hi = te.prob_meta(tp)
    state = te.run_epochs(grid, state, tsched.cyclic_perms(1, P),
                          te.eta_schedule(0.5, 2, 1, True), lam, m, w_lo,
                          w_hi, backend="dense_pallas_block",
                          loss_name=loss, reg_name=reg, row_batches=3)
    assert state.epoch == 3
    for k in ("w_grid", "gw_grid", "alpha", "ga"):
        _check(k, getattr(state, k), getattr(j3.state, k))
    r = te.solve(grid, backend="pallas", loss_name=loss, reg_name=reg,
                 lam=1e-3, m=tp.m, d=tp.d, p=P, epochs=3, eta0=0.5,
                 row_batches=3, alpha0=0.0005, device="cpu")
    _check("w from the carried grid", r.w, j3.w)


# (p, m, d, alpha0, row_batches): as in tests/test_torch_engine.py
CORNERS = [(p, m, d, a0, rb) for p in (1, 3, 5)
           for m, d in ((121, 61), (37, 200))
           for a0 in (0.0, 0.3) for rb in (1, 2)]


@pytest.mark.parametrize("p,m,d,alpha0,row_batches", CORNERS)
def test_dense_solve_corners_match_reference(p, m, d, alpha0, row_batches):
    """logistic/l2 on dense_jnp, cyclic, 2 epochs, eta0 0.5; w, alpha and
    the history within 1e-5."""
    jp, tp = _pair("logistic", "l2", seed=3, m=m, d=d)
    run = dict(backend="dense_jnp", schedule="cyclic", p=p, epochs=2,
               eta0=0.5, alpha0=alpha0, row_batches=row_batches)
    r_j, r_t = je.solve(jp, **run), te.solve(tp, device="cpu", **run)
    _check("w", r_t.w, r_j.w)
    _check("alpha", r_t.alpha, r_j.alpha)
    assert len(r_t.history) == len(r_j.history)
    for h_t, h_j in zip(r_t.history, r_j.history):
        assert h_t.keys() == h_j.keys() and h_t["epoch"] == h_j["epoch"]
        for k in h_j:
            _check(k, h_t[k], h_j[k])
