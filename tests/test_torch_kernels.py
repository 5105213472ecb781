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
from repro_torch.kernels import dso_sparse, ops, ref
from repro_torch.sparse.format import (CSRMatrix, bucketed_grid_from_csr,
                                       sparse_grid_from_csr)

LOSS_REG_PAIRS = [("hinge", "l2"), ("hinge", "l1"), ("logistic", "l2"),
                  ("logistic", "l1"), ("square", "l2"), ("square", "l1")]
TOL = dict(rtol=1e-5, atol=1e-5)
P, M_ROWS, D = 4, 124, 96          # mb = 31, db = 24


def _grids(row_batches):
    """Uniform and bucketed grids of one power-law CSR (>= 3 buckets)."""
    rng = np.random.default_rng(11)
    pop = np.arange(1, D + 1, dtype=np.float64) ** -1.3
    pop /= pop.sum()
    ks = rng.integers(2, 40, M_ROWS)          # ragged rows: 3 tile widths
    cols = np.concatenate([np.sort(rng.choice(D, size=k, replace=False,
                                              p=pop)) for k in ks])
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
    grid, _ = _grids(row_batches)
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
    uni, grid = _grids(row_batches)
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
    from repro_torch.kernels.dso_update import _primal_update
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
