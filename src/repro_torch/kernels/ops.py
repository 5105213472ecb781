"""Wrappers of the port's kernels: checks, routing, truncation and launch
counts.

Each wrapper routes by the device its tensors lie on: CPU tensors go to
the kernel's plain PyTorch version, CUDA tensors launch the kernel or
raise.  Nothing falls back from the card to the plain version; the
tensors' device alone decides (the reference's ``REPRO_FORCE_INTERPRET``
switch has no counterpart).  Before its first launch on a device a
sparse wrapper runs the capability probe (``sparse_kernel_error``); when
it fails the wrapper raises ``ValueError`` naming the plain backend.

Each wrapper counts its kernel launches in a plain int attribute,
``<wrapper>.launches``, incremented only where the kernel is launched:

    dso_sparse_block_step.launches    the folded block step (launch A and
                                      launch B in one cooperative launch
                                      per row tile), uniform block-ELL
                                      grid; with ``every_column`` launch A
                                      alone (the "warp" kernel), one a
                                      row tile, then launch B alone
                                      (counted on ``dso_primal_update``)
    dso_bucketed_block_step.launches  the folded block step, flat chunk
                                      view, db past the shared budget: the
                                      hot route (the block's hottest
                                      columns summed in shared memory)
    _dso_bucketed_block_step_shared.launches
                                      ... its shared route (the sums in
                                      shared memory; listed as
                                      ``dso_bucketed_block_step_shared``)
    dso_block_step.launches           dense launch A, p processors
    dso_tile_step.launches            dense launch A, one tile
    _dso_tile_step_twopass.launches   the two-pass step's primal pass and
                                      its dual pass (two per step; listed
                                      as ``dso_tile_step_twopass``)
    dso_primal_update.launches        launch B alone (the dense steps',
                                      the wrapper's own and the sparse
                                      steps' with ``every_column``; they
                                      fold it in otherwise)
    sparse_probe.launches             the probe kernel
    swa_attention.launches            sliding-window attention, the
                                      packed route (bf16 with another Dh
                                      or alignment: q, k, v packed into an
                                      aligned workspace, then the bf16
                                      tensor-core kernel; one count per
                                      call)
    _swa_attention_tc.launches        ... its bf16 tensor-core kernel (Dh a
                                      multiple of 8, aligned; listed as
                                      ``swa_attention_tc``)
    _swa_attention_tf32x3.launches    ... its float32 tensor-core kernel
                                      (split TF32; listed as
                                      ``swa_attention_tf32x3``)
    _swa_attention_bwd.launches       ... its backward kernels (dq, then
                                      dk and dv) on bf16 in place (listed
                                      as ``swa_attention_bwd``; one count
                                      per backward)
    _swa_attention_bwd_packed.launches
                                      ... on a packed bf16 copy (listed as
                                      ``swa_attention_bwd_packed``)
    _swa_attention_bwd_f32.launches   ... in float32 (listed as
                                      ``swa_attention_bwd_f32``)
    ssd_scan.launches                 the Mamba2 SSD scan
    _ssd_scan_bwd.launches            ... its backward (the state
                                      adjoint's two launches and the chunk
                                      gradients; listed as
                                      ``ssd_scan_bwd``; one count per
                                      backward)
    dso_serial_epoch.launches         the paper-exact serial epoch (one
                                      launch per epoch; replaces no
                                      pallas_call)
    sgd_epoch.launches                an AdaGrad SGD epoch of every worker
                                      (SGD: 1, PSGD: p thread-block
                                      clusters; one launch per epoch;
                                      replaces no pallas_call)
    dcd_epoch.launches                a DCD epoch (one cluster, one launch
                                      per epoch; replaces no pallas_call)

A sparse block step makes one folded launch per row tile, so one inner
iteration of the epoch is ``row_batches`` launches for all p processors
together, and one epoch ``p * row_batches``; none of them counts on
``dso_primal_update``.  A dense block step launches A then B once per row
tile (``2 * row_batches`` per inner iteration).  ``dso_tile_step`` is one
A and one B for one processor's tile; its two-pass form is the primal
pass, B and the dual pass.
"""

from __future__ import annotations

import functools
import weakref

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import baselines as _baselines
from repro_torch.kernels import dso_serial, dso_sparse, dso_update
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import swa_attention as _swa


def _route(*tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raises on a mix or on any
    other device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors lie on several devices: "
                         f"{sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise ValueError(f"kernel wrappers take CPU or CUDA tensors, got "
                     f"{str(dev)!r}")


def _expect(name: str, t: torch.Tensor, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_state(blk_ids, yg, w_grid, alpha, gw_grid, ga, trn_g, tcn_g,
                 rn_g, col_nnz, row_batches: int):
    p, mb = yg.shape
    db = w_grid.shape[1]
    f32 = torch.float32
    _expect("blk_ids", blk_ids, torch.int32, (p,))
    for name, t, shape in (("yg", yg, (p, mb)), ("w_grid", w_grid, (p, db)),
                           ("alpha", alpha, (p, mb)),
                           ("gw_grid", gw_grid, (p, db)), ("ga", ga, (p, mb)),
                           ("tile_row_nnz_g", trn_g, (p, p, mb)),
                           ("row_nnz_g", rn_g, (p, mb)),
                           ("col_nnz", col_nnz, (p * db,))):
        _expect(name, t, f32, shape)
    if tcn_g.dim() != 3 or tcn_g.shape[0] != p or tcn_g.shape[2] != p * db:
        raise ValueError(f"tile_col_nnz_g must be (p, n_rb, p*db) = "
                         f"({p}, n_rb, {p * db}), got {tuple(tcn_g.shape)}")
    _expect("tile_col_nnz_g", tcn_g, f32, tcn_g.shape)
    if not 1 <= row_batches <= tcn_g.shape[1]:
        raise ValueError(f"row_batches={row_batches} outside 1.."
                         f"{tcn_g.shape[1]} (the stats' row grouping)")
    if mb // row_batches != mb // tcn_g.shape[1]:
        raise ValueError("tile_col_nnz_g was built for another row grouping")


def _scalars(scalars):
    if len(scalars) != 5:
        raise ValueError("scalars must be (eta, lam, m, w_lo, w_hi)")
    return tuple(float(s) for s in scalars)


def _require_probe(device: torch.device, plain_backend: str):
    err = sparse_kernel_error(device)
    if err is not None:
        raise ValueError(
            f"the sparse CUDA kernels cannot run on {str(device)!r} (probe "
            f"failed: {err.splitlines()[0]}); use the {plain_backend!r} "
            f"backend, the plain PyTorch version")


# ------------------------------------------------------------------ probe --

_PROBE_N_W = 128


def _probe_inputs(device):
    g = torch.Generator().manual_seed(0)
    cols = torch.randint(0, _PROBE_N_W, (8, 8), generator=g,
                         dtype=torch.int32)
    w = torch.randn(_PROBE_N_W, generator=g)
    return cols.to(device), w.to(device)


def sparse_probe(cols, w):
    """The capability probe kernel (replaces the reference's
    ``_mosaic_sparse_gather_error`` pallas_call, ``ops.py:223``): a 2-D
    gather from ``w`` at the (8, 8) ``cols`` scatter-added back into a
    zeroed vector of w's size."""
    _expect("cols", cols, torch.int32, cols.shape)
    _expect("w", w, torch.float32, (w.numel(),))
    if not _route(cols, w):
        return dso_sparse.probe_plain(cols, w)
    out = torch.empty_like(w)
    dso_sparse.launch_probe(cols, w, out)
    sparse_probe.launches += 1
    return out


sparse_probe.launches = 0


@functools.lru_cache(maxsize=None)
def sparse_kernel_error(device) -> str | None:
    """Build the kernel library, launch the probe on ``device`` and compare
    it with its plain version.  ``None`` when the kernels can run there,
    else the reason.  Cached per device (``sparse_kernel_error.
    cache_clear()`` forgets the verdicts).  Raises ``RuntimeError`` when
    ``device`` is the card and there is none."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return f"{str(dev)!r} is not a CUDA device"
    try:
        cols, w = _probe_inputs(dev)
        got = sparse_probe(cols, w)
        torch.cuda.synchronize(dev)
    except (RuntimeError, OSError) as e:   # nvcc, loading, or a launch
        return f"{type(e).__name__}: {e}"
    want = dso_sparse.probe_plain(cols, w)
    err = float((got - want).abs().max())
    if not err <= 1e-6:
        return f"probe disagrees with its plain version: max|d| = {err}"
    return None


# ------------------------------------------------------------ block steps --


def dso_primal_update(blk_ids, w_grid, gw_grid, acc, tcn_g, col_nnz, s: int,
                      scalars, *, reg_name: str):
    """Launch B (in place): the primal Eq.-8 step of row tile ``s`` for
    every processor's active block from the (p, db) ``acc`` = X^T alpha,
    which it then zeroes."""
    p, db = w_grid.shape
    for name, t, shape in (("w_grid", w_grid, (p, db)),
                           ("gw_grid", gw_grid, (p, db)),
                           ("acc", acc, (p, db)),
                           ("col_nnz", col_nnz, (p * db,))):
        _expect(name, t, torch.float32, shape)
    _expect("blk_ids", blk_ids, torch.int32, (p,))
    if tcn_g.dim() != 3 or tcn_g.shape[0] != p or tcn_g.shape[2] != p * db:
        raise ValueError(f"tile_col_nnz_g must be (p, n_rb, p*db) = "
                         f"({p}, n_rb, {p * db}), got {tuple(tcn_g.shape)}")
    _expect("tile_col_nnz_g", tcn_g, torch.float32, tcn_g.shape)
    if not 0 <= s < tcn_g.shape[1]:
        raise ValueError(f"row tile {s} outside the stats' "
                         f"{tcn_g.shape[1]} row batches")
    scal = _scalars(scalars)
    if not _route(blk_ids, w_grid, gw_grid, acc, tcn_g, col_nnz):
        dso_sparse.primal_update_plain(blk_ids, w_grid, gw_grid, acc, tcn_g,
                                       col_nnz, s, scal, reg_name)
        return
    _launch_primal(blk_ids, w_grid, gw_grid, acc, tcn_g, col_nnz, s, scal,
                   reg_name)


dso_primal_update.launches = 0


def _launch_primal(blk_ids, w_grid, gw_grid, acc, tcn_g, col_nnz, s, scal,
                   reg_name):
    """Launch B on tensors already checked, counted on
    ``dso_primal_update``."""
    dso_sparse.launch_primal_update(blk_ids, w_grid, gw_grid, acc, tcn_g,
                                    col_nnz, s, scal, reg_name)
    dso_primal_update.launches += 1


# Launch B, alone or folded, leaves ``acc`` zeroed, so one (p, db)
# accumulator per device and shape serves every block step on the current
# stream (the folded step needs it zero: it skips the columns its row tile
# does not hold, whose acc it then leaves as it found it).  A step takes it out
# while it runs and puts it back when it is done, so a step that raises
# leaves no half-summed buffer behind.
_ACC: dict = {}


def _take_acc(w_grid, copies: int = 1):
    p, db = w_grid.shape
    shape = torch.Size((copies * p, db))
    acc = _ACC.pop((w_grid.device, shape), None)
    return w_grid.new_zeros(shape) if acc is None else acc


def _give_acc(acc):
    _ACC[(acc.device, acc.shape)] = acc


def dso_sparse_block_step(cols_g, vals_g, blk_ids, yg, w_grid, alpha,
                          gw_grid, ga, tile_row_nnz_g, tile_col_nnz_g,
                          row_nnz_g, col_nnz, scalars, *, row_batches: int,
                          loss_name: str, reg_name: str,
                          every_column: bool = False):
    """All ``row_batches`` sequential tile steps of every processor's
    active block ``blk_ids[q]`` of the uniform block-ELL grid, in place on
    ``w_grid``, ``gw_grid``, ``alpha`` and ``ga``.

    Shapes as in ``dso_sparse.dso_sparse_block_step_plain``.  Rows past
    ``(mb // row_batches) * row_batches`` pass through unchanged (the
    reference's truncation, ops.py:267-277).  On the card: one
    cooperative launch per row tile (``csrc/dso_sparse.cu``), launch A
    on each row's live slots and launch B on the columns the row tile
    holds; the others' w and gw stay as they are, which is the step's
    result for any w inside its box (every state the engine makes).
    ``every_column`` (for a state that may hold w outside its box, which
    the plain step clamps in every column): launch A alone, then launch B
    on every column, per row tile.
    """
    p, mb = yg.shape
    _check_state(blk_ids, yg, w_grid, alpha, gw_grid, ga, tile_row_nnz_g,
                 tile_col_nnz_g, row_nnz_g, col_nnz, row_batches)
    if cols_g.dim() != 4 or tuple(cols_g.shape[:3]) != (p, p, mb):
        raise ValueError(f"cols_g must be (p, p, mb, K) = ({p}, {p}, {mb}, "
                         f"K), got {tuple(cols_g.shape)}")
    _expect("cols_g", cols_g, torch.int32, cols_g.shape)
    _expect("vals_g", vals_g, torch.float32, cols_g.shape)
    scal = _scalars(scalars)
    args = (blk_ids, yg, w_grid, alpha, gw_grid, ga, tile_row_nnz_g,
            tile_col_nnz_g, row_nnz_g, col_nnz)
    if not _route(cols_g, vals_g, *args):
        dso_sparse.dso_sparse_block_step_plain(
            cols_g, vals_g, blk_ids, yg, w_grid, alpha, gw_grid, ga,
            tile_row_nnz_g, tile_col_nnz_g, row_nnz_g, col_nnz, scal,
            row_batches=row_batches, loss_name=loss_name, reg_name=reg_name)
        return
    _require_probe(yg.device, "sparse_jnp")
    rb = mb // row_batches
    if every_column:
        acc = _take_acc(w_grid)
        for s in range(row_batches):
            dso_sparse.launch_sparse_dual_scatter(
                cols_g, vals_g, blk_ids, yg, w_grid, alpha, ga,
                tile_row_nnz_g, row_nnz_g, acc, s * rb, rb, scal[0],
                scal[2], loss_name, kernel="warp")
            dso_sparse_block_step.launches += 1
            _launch_primal(blk_ids, w_grid, gw_grid, acc, tile_col_nnz_g,
                           col_nnz, s, scal, reg_name)
        _give_acc(acc)
        return
    acc = _take_acc(w_grid, dso_sparse.ELL_ACC_COPIES)
    for s in range(row_batches):
        dso_sparse.launch_sparse_block_step(
            cols_g, vals_g, blk_ids, yg, w_grid, gw_grid, alpha, ga,
            tile_row_nnz_g, row_nnz_g, tile_col_nnz_g, col_nnz, acc, s, rb,
            scal, loss_name, reg_name)
        dso_sparse_block_step.launches += 1
    _give_acc(acc)


dso_sparse_block_step.launches = 0


def dso_bucketed_block_step(cols_fl, vals_fl, chunk_lut, chunk_cnt, blk_ids,
                            yg, w_grid, alpha, gw_grid, ga, tile_row_nnz_g,
                            tile_col_nnz_g, row_nnz_g, col_nnz, scalars, *,
                            row_batches: int, loss_name: str, reg_name: str,
                            every_column: bool = False):
    """The K-bucketed counterpart of ``dso_sparse_block_step`` on the flat
    chunk view: cols_fl/vals_fl (p, n_chunks, mb, K_CHUNK), chunk_lut
    (p, p, n_kc), chunk_cnt (p, p).  Each processor streams only the live
    chunks of its active tile.  Same truncation (ops.py:307-317) and
    in-place contract.  On the card ``dso_sparse.bucketed_route`` picks
    the route from db and the card's shared-memory limit, with no
    fallback; each route makes one cooperative launch per row tile, as
    ``dso_sparse_block_step`` does, and counts its own launches.  The hot
    route's table is built on the first step of a grid and kept for its
    later steps (``grid_hot_table``).  ``every_column``: as
    ``dso_sparse_block_step``'s, launch A alone on the route's kernel,
    then launch B; counted as the route's step and ``dso_primal_update``."""
    p, mb = yg.shape
    _check_state(blk_ids, yg, w_grid, alpha, gw_grid, ga, tile_row_nnz_g,
                 tile_col_nnz_g, row_nnz_g, col_nnz, row_batches)
    if cols_fl.dim() != 4 or cols_fl.shape[0] != p or cols_fl.shape[2] != mb:
        raise ValueError(f"cols_fl must be (p, n_chunks, mb, K_CHUNK) with "
                         f"p={p}, mb={mb}, got {tuple(cols_fl.shape)}")
    _expect("cols_fl", cols_fl, torch.int32, cols_fl.shape)
    _expect("vals_fl", vals_fl, torch.float32, cols_fl.shape)
    if chunk_lut.dim() != 3 or tuple(chunk_lut.shape[:2]) != (p, p):
        raise ValueError(f"chunk_lut must be (p, p, n_kc), got "
                         f"{tuple(chunk_lut.shape)}")
    _expect("chunk_lut", chunk_lut, torch.int32, chunk_lut.shape)
    _expect("chunk_cnt", chunk_cnt, torch.int32, (p, p))
    scal = _scalars(scalars)
    args = (chunk_lut, chunk_cnt, blk_ids, yg, w_grid, alpha, gw_grid, ga,
            tile_row_nnz_g, tile_col_nnz_g, row_nnz_g, col_nnz)
    if not _route(cols_fl, vals_fl, *args):
        dso_sparse.dso_bucketed_block_step_plain(
            cols_fl, vals_fl, chunk_lut, chunk_cnt, blk_ids, yg, w_grid,
            alpha, gw_grid, ga, tile_row_nnz_g, tile_col_nnz_g, row_nnz_g,
            col_nnz, scal, row_batches=row_batches, loss_name=loss_name,
            reg_name=reg_name)
        return
    _require_probe(yg.device, "sparse_bucketed_jnp")
    db = w_grid.shape[1]
    route = dso_sparse.bucketed_route(db, shared_memory_limit(yg.device))
    hot = grid_hot_table(col_nnz, p, db) if route == "hot" else None
    rb = mb // row_batches
    acc = _take_acc(w_grid)
    for s in range(row_batches):
        if every_column:
            dso_sparse.launch_bucketed_dual_scatter(
                cols_fl, vals_fl, chunk_lut, chunk_cnt, blk_ids, yg, w_grid,
                alpha, ga, tile_row_nnz_g, row_nnz_g, acc, s * rb, rb,
                scal[0], scal[2], loss_name, route=route, hot=hot)
            counter = _dso_bucketed_block_step_shared \
                if route == "shared" else dso_bucketed_block_step
            counter.launches += 1
            _launch_primal(blk_ids, w_grid, gw_grid, acc, tile_col_nnz_g,
                           col_nnz, s, scal, reg_name)
            continue
        args = (cols_fl, vals_fl, chunk_lut, chunk_cnt, blk_ids, yg, w_grid,
                gw_grid, alpha, ga, tile_row_nnz_g, row_nnz_g,
                tile_col_nnz_g, col_nnz, acc, s, rb, scal, loss_name,
                reg_name)
        if route == "shared":
            _dso_bucketed_block_step_shared(*args)
        else:
            dso_sparse.launch_bucketed_block_step(*args, route="hot",
                                                  hot=hot)
            dso_bucketed_block_step.launches += 1
    _give_acc(acc)


dso_bucketed_block_step.launches = 0


def _dso_bucketed_block_step_shared(*args):
    """A row tile of the bucketed block step on the shared route, on
    tensors ``dso_bucketed_block_step`` has checked, counted on its own."""
    dso_sparse.launch_bucketed_block_step(*args, route="shared")
    _dso_bucketed_block_step_shared.launches += 1


_dso_bucketed_block_step_shared.launches = 0

# The hot tables of the grids on the card, by the id of the grid's col_nnz
# tensor: (a weak reference to it, its version, the table).  An entry goes
# when its tensor does, and a col_nnz changed in place is a new grid.
_HOT: dict = {}


def grid_hot_table(col_nnz, p: int, db: int):
    """The hot route's table of the grid whose column counts are
    ``col_nnz``: ``dso_sparse.hot_table`` at the card's ``hot_slots``,
    built on its first step and kept while col_nnz lives unchanged."""
    key = id(col_nnz)
    hit = _HOT.get(key)
    if hit is not None and hit[0]() is col_nnz \
            and hit[1] == col_nnz._version:
        return hit[2]
    table = dso_sparse.hot_table(col_nnz, p, db, hot_slots(col_nnz.device))
    _HOT[key] = (weakref.ref(col_nnz, lambda _, k=key: _HOT.pop(k, None)),
                 col_nnz._version, table)
    return table


@functools.lru_cache(maxsize=None)
def hot_slots(device) -> int:
    """The hot route's float32 sums per CTA on the card ``device``: its
    SM's shared memory split ``dso_sparse.HOT_SMEM_SHARE`` ways, read once
    per device."""
    with torch.cuda.device(device):
        return dso_sparse.hot_slots()[0]


@functools.lru_cache(maxsize=None)
def shared_memory_limit(device) -> int:
    """Bytes of shared memory one CTA may take on the card ``device`` (its
    opt-in limit), read once per device."""
    return int(torch.cuda.get_device_properties(device)
               .shared_memory_per_block_optin)


# -------------------------------------------------------------- dense --
#
# The reference's ``dso_block_step`` picks one launch or, where the (bm, bd)
# X block would not fit its VMEM budget, a scan of ``dso_tile_step``
# (``force_scan``, ops.py:134-137).  The CUDA kernel takes any (mb, db), so
# there is no such test and no fallback here; the scan survives as the
# ``dense_pallas_fused`` backend.


def dso_block_step(Xg, blk_ids, yg, w_grid, alpha, gw_grid, ga,
                   tile_row_nnz_g, tile_col_nnz_g, row_nnz_g, col_nnz,
                   scalars, *, row_batches: int, loss_name: str,
                   reg_name: str):
    """All ``row_batches`` sequential tile steps of every processor's
    active block ``blk_ids[q]`` of the dense grid ``Xg`` (p, mb, p * db),
    in place on ``w_grid``, ``gw_grid``, ``alpha`` and ``ga``; the
    counterpart of the reference's ``ops.dso_block_step`` batched over the
    p processors.

    Shapes as in ``dso_update.dso_block_step_plain``.  Rows past
    ``(mb // row_batches) * row_batches`` pass through unchanged (the
    reference's truncation, ops.py:184-186).  On the card: launch A
    (``csrc/dso_update.cu``) then launch B per row tile, each covering all
    p processors, reading the active blocks in place from ``Xg``.
    """
    p, mb = yg.shape
    _check_state(blk_ids, yg, w_grid, alpha, gw_grid, ga, tile_row_nnz_g,
                 tile_col_nnz_g, row_nnz_g, col_nnz, row_batches)
    _expect("Xg", Xg, torch.float32, (p, mb, col_nnz.shape[0]))
    scal = _scalars(scalars)
    if not _route(Xg, blk_ids, yg, w_grid, alpha, gw_grid, ga,
                  tile_row_nnz_g, tile_col_nnz_g, row_nnz_g, col_nnz):
        dso_update.dso_block_step_plain(
            Xg, blk_ids, yg, w_grid, alpha, gw_grid, ga, tile_row_nnz_g,
            tile_col_nnz_g, row_nnz_g, col_nnz, scal,
            row_batches=row_batches, loss_name=loss_name, reg_name=reg_name)
        return
    rb = mb // row_batches
    d_pad = Xg.shape[2]
    acc = _take_acc(w_grid)
    for s in range(row_batches):
        dso_update.launch_dense_dual_scatter(
            Xg, d_pad, mb * d_pad, blk_ids, yg, w_grid, alpha, ga,
            tile_row_nnz_g, row_nnz_g, acc, s * rb, rb, scal[0], scal[2],
            loss_name)
        dso_block_step.launches += 1
        _launch_primal(blk_ids, w_grid, gw_grid, acc, tile_col_nnz_g,
                       col_nnz, s, scal, reg_name)
    _give_acc(acc)


dso_block_step.launches = 0

# blk_ids = [0] of a single-tile step, one per device
_TILE_BLK: dict = {}


def _tile_blk(device):
    blk = _TILE_BLK.get(device)
    if blk is None:
        blk = _TILE_BLK[device] = torch.zeros(1, dtype=torch.int32,
                                              device=device)
    return blk


def dso_tile_step(X, y, w, alpha, gw, ga, row_nnz, col_nnz, scalars, *,
                  loss_name: str, reg_name: str, tile_row_nnz=None,
                  tile_col_nnz=None, twopass: bool = False):
    """One dense Jacobi tile step over all of X (M, D), the reference's
    ``ops.dso_tile_step``: y/alpha/ga/row_nnz (M,), w/gw/col_nnz (D,),
    ``scalars`` = (eta, lam, m, w_lo, w_hi).  Returns new (w, alpha, gw,
    ga); the inputs are not changed.

    ``tile_row_nnz``/``tile_col_nnz`` are X's per-row/per-column nonzero
    counts; when absent they are derived here, once, outside the kernel.
    X may be a row-strided view (unit column stride), such as one
    processor's active block of a dense grid.  The reference's block
    shapes (``bm``, ``bd``) and ``interpret`` have no counterpart: the
    CUDA kernel takes any (M, D).  On the card: launch A and launch B with
    p = 1 and block 0.  ``twopass=True`` runs the legacy two-pass step
    (``_dso_tile_step_twopass``), which derives its tile counts itself and
    so refuses ``tile_row_nnz``/``tile_col_nnz``, as the reference does
    (ops.py:64-67).
    """
    if twopass:
        if tile_row_nnz is not None or tile_col_nnz is not None:
            raise ValueError(
                "dso_tile_step(twopass=True) derives the tile counts in "
                "its kernels; tile_row_nnz/tile_col_nnz would be silently "
                "ignored")
        return _dso_tile_step_twopass(X, y, w, alpha, gw, ga, row_nnz,
                                      col_nnz, scalars, loss_name=loss_name,
                                      reg_name=reg_name)
    M, D = _check_tile(X, y, w, alpha, gw, ga, row_nnz, col_nnz)
    if tile_row_nnz is None:
        tile_row_nnz = (X != 0).sum(dim=1)
    if tile_col_nnz is None:
        tile_col_nnz = (X != 0).sum(dim=0)
    trn = tile_row_nnz.to(torch.float32).contiguous()
    tcn = tile_col_nnz.to(torch.float32).contiguous()
    _expect("tile_row_nnz", trn, torch.float32, (M,))
    _expect("tile_col_nnz", tcn, torch.float32, (D,))
    scal = _scalars(scalars)
    if not _route(X, y, w, alpha, gw, ga, row_nnz, col_nnz, trn, tcn):
        return dso_update.dso_tile_step_plain(
            X, y, w, alpha, gw, ga, row_nnz, col_nnz, scal,
            loss_name=loss_name, reg_name=reg_name, tile_row_nnz=trn,
            tile_col_nnz=tcn)
    w2, a2, gw2, ga2 = w.clone(), alpha.clone(), gw.clone(), ga.clone()
    blk = _tile_blk(X.device)
    w_grid, gw_grid = w2.view(1, D), gw2.view(1, D)
    tcn_g = tcn.view(1, 1, D)
    acc = _take_acc(w_grid)
    dso_update.launch_dense_dual_scatter(
        X, X.stride(0), 0, blk, y.view(1, M), w_grid, a2.view(1, M),
        ga2.view(1, M), trn.view(1, 1, M), row_nnz.view(1, M), acc, 0, M,
        scal[0], scal[2], loss_name)
    dso_tile_step.launches += 1
    _launch_primal(blk, w_grid, gw_grid, acc, tcn_g, col_nnz, 0, scal,
                   reg_name)
    _give_acc(acc)
    return w2, a2, gw2, ga2


dso_tile_step.launches = 0


def _check_tile(X, y, w, alpha, gw, ga, row_nnz, col_nnz):
    """(M, D) of a tile step's X, a 2-D float32 tensor with unit column
    stride and rows at least D apart; the vectors float32, contiguous,
    (M,) or (D,)."""
    if X.dim() != 2 or X.dtype != torch.float32:
        raise TypeError(f"X must be a 2-D float32 tensor, got "
                        f"{X.dtype} of shape {tuple(X.shape)}")
    M, D = X.shape
    if X.stride(1) != 1 or (M > 1 and X.stride(0) < D):
        raise ValueError(f"X must have unit column stride and rows at "
                         f"least D apart, got strides {X.stride()}")
    for name, t, shape in (("y", y, (M,)), ("w", w, (D,)),
                           ("alpha", alpha, (M,)), ("gw", gw, (D,)),
                           ("ga", ga, (M,)), ("row_nnz", row_nnz, (M,)),
                           ("col_nnz", col_nnz, (D,))):
        _expect(name, t, torch.float32, shape)
    return M, D


def _dso_tile_step_twopass(X, y, w, alpha, gw, ga, row_nnz, col_nnz,
                           scalars, *, loss_name: str, reg_name: str):
    """The legacy two-pass tile step over X (M, D), the reference's
    ``dso_tile_step_pallas_twopass`` (kernel row 6): the same contract and
    result as ``dso_tile_step``, but X is read twice and each pass derives
    its nonzero counts from X.  Returns new (w, alpha, gw, ga).

    On the card: the primal pass (X^T alpha and the column counts into a
    zeroed accumulator), launch B fed those counts, and the dual pass (X w,
    the row counts and the dual step); both passes read the input w and
    alpha, on the kernels the entry points pick by X's row stride and
    width (``dso_update.twopass_route`` reports which).  It is the
    baseline the fused step is held against; no backend runs it.
    """
    M, D = _check_tile(X, y, w, alpha, gw, ga, row_nnz, col_nnz)
    scal = _scalars(scalars)
    if not _route(X, y, w, alpha, gw, ga, row_nnz, col_nnz):
        return dso_update.dso_tile_step_twopass_plain(
            X, y, w, alpha, gw, ga, row_nnz, col_nnz, scal,
            loss_name=loss_name, reg_name=reg_name)
    # launch B updates w and gw in place; the dual pass writes every row
    # of the new alpha and ga
    w2, gw2 = w.clone(), gw.clone()
    a2, ga2 = torch.empty_like(alpha), torch.empty_like(ga)
    w_grid, gw_grid = w2.view(1, D), gw2.view(1, D)
    cnt = torch.zeros_like(w)
    acc = _take_acc(w_grid)
    dso_update.launch_twopass_primal(X, alpha, acc.view(D), cnt)
    _dso_tile_step_twopass.launches += 1
    _launch_primal(_tile_blk(X.device), w_grid, gw_grid, acc,
                   cnt.view(1, 1, D), col_nnz, 0, scal, reg_name)
    _give_acc(acc)
    dso_update.launch_twopass_dual(X, w, alpha, a2, ga, ga2, y, row_nnz,
                                   scal[0], scal[2], loss_name)
    _dso_tile_step_twopass.launches += 1
    return w2, a2, gw2, ga2


_dso_tile_step_twopass.launches = 0


# -------------------------------------------------------- LM kernels --


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class SWAAttention(torch.autograd.Function):
    """Sliding-window attention with its gradient.

    ``apply(forward, backward, kw, q, k, v)``: ``forward(q, k, v, **kw)``
    returns (out, lse), the output and each row's logsumexp (B, Hq, Tq)
    float32; ``backward(q, k, v, out, lse, dout, **kw)`` returns (dq, dk,
    dv) in q's, k's and v's types.  On the card they are the kernels'
    launches (``_swa_launch(lse=True)``, ``_swa_bwd_launch``); the tests
    pass the plain pair (``swa_attention_plain(return_lse=True)``,
    ``swa_attention_bwd_plain``).  The forward saves q, k, v, out and lse;
    nothing is recomputed but the probabilities, from lse, inside the
    backward."""

    @staticmethod
    def forward(ctx, forward, backward, kw, q, k, v):
        out, lse = forward(q, k, v, **kw)
        ctx.backward, ctx.kw = backward, kw
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        grads = ctx.backward(q, k, v, out, lse, dout.contiguous(), **ctx.kw)
        return (None, None, None, *grads)


class SSDScan(torch.autograd.Function):
    """The Mamba2 SSD scan with its gradient.

    ``apply(forward, backward, kw, x, dt, A, B, C)``: ``forward(x, dt, A,
    B, C, **kw)`` returns (y, states, decay), the float32 state entering
    each chunk (b, h, n_chunks, n, dh) and the chunks' total decays (b, h,
    n_chunks); ``backward(x, dt, A, B, C, states, decay, dy, **kw)``
    returns (dx, ddt, dA, dB, dC).  On the card they are the kernels'
    launches (``_ssd_launch(save=True)``, whose chunk-state workspace is
    kept, and ``_ssd_scan_bwd``); the tests pass the plain pair
    (``ssd_scan_plain(return_states=True)``, ``ssd_scan_bwd_plain``).
    Each gradient is returned in its input's type."""

    @staticmethod
    def forward(ctx, forward, backward, kw, x, dt, A, B, C):
        y, states, decay = forward(x, dt, A, B, C, **kw)
        ctx.backward, ctx.kw = backward, kw
        ctx.save_for_backward(x, dt, A, B, C, states, decay)
        return y

    @staticmethod
    def backward(ctx, dy):
        *inputs, states, decay = ctx.saved_tensors
        grads = ctx.backward(*inputs, states, decay, dy.contiguous(),
                             **ctx.kw)
        return (None, None, None,
                *(g.to(t.dtype) for g, t in zip(grads, inputs)))


def swa_attention(q, k, v, *, window: int, causal: bool = True,
                  q_offset: int = 0):
    """Sliding-window attention, the reference's ``ops.swa_attention``:
    q (B, Hq, Tq, Dh), k and v (B, Hkv, Tk, Dh), all float32 or all bf16,
    Hq % Hkv == 0; returns (B, Hq, Tq, Dh) in q's type.  See
    ``kernels/swa_attention.py`` for the masking.

    The reference's tile sizes (``bq``, ``bk``) and ``interpret`` have no
    counterpart, and nothing is padded: the kernels mask the ragged ends
    themselves.  So ``causal=False`` with a Tk that 64 does not divide
    attends to no padded key, unlike the reference's padded call.  On the
    card the tensors must be contiguous and Dh at most 128, and
    ``_swa.swa_route`` picks the route: split TF32 on the tensor cores
    for float32, the bf16 tensor-core kernel on q, k, v in place for bf16
    with Dh a multiple of 8 (16-byte-aligned data), the same kernel on a
    packed, aligned copy for the rest; each route counts its own calls.
    Under grad mode with an input that requires grad, the call runs
    inside ``SWAAttention``: the same launch (and count) also writes the
    rows' logsumexp, and the backward launches the backward kernels of
    the route that the backward's tensors take (``_swa_bwd_launch``,
    counted on its own).
    """
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k, v must be 4-D (B, H, T, Dh)")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must all be float32 or all bf16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    B, Hq, Tq, Dh = q.shape
    Hkv, Tk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, Hkv, Tk, Dh) or v.shape != k.shape \
            or Hq % Hkv != 0:
        raise ValueError(f"k and v must be (B, Hkv, Tk, Dh) with Hq % Hkv "
                         f"== 0 for q {tuple(q.shape)}, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    window, q_offset = int(window), int(q_offset)
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    kw = dict(window=window, causal=bool(causal), q_offset=q_offset)
    if not _route(q, k, v):
        return _swa.swa_attention_plain(q, k, v, **kw)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on the card")
    if _wants_grad(q, k, v):
        return SWAAttention.apply(functools.partial(_swa_launch, lse=True),
                                  _swa_bwd_launch, kw, q, k, v)
    return _swa_launch(q, k, v, **kw)


def _swa_launch(q, k, v, *, window: int, causal: bool, q_offset: int,
                lse: bool = False):
    """``swa_attention``'s launch on checked CUDA tensors: the route's
    kernel into a new output; with ``lse``, (out, the rows' logsumexp
    (B, Hq, Tq) float32) from the same launch."""
    B, Hq, Tq, Dh = q.shape
    out = torch.empty_like(q)
    route = _swa.swa_route(q.dtype, Dh, aligned=all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, out)))
    if -(-Tq // _swa.QUERY_TILES[route]) > 65535:
        raise ValueError(f"Tq {Tq} exceeds the kernel's grid of 65,535 "
                         f"query tiles")
    rows = torch.empty(B, Hq, Tq, dtype=torch.float32, device=q.device) \
        if lse else None
    kw = dict(window=window, causal=causal, q_offset=q_offset,
              scale=1.0 / Dh ** 0.5, lse=rows)
    if route == "tf32x3":
        _swa_attention_tf32x3(q, k, v, out, **kw)
    elif route == "tensor_cores":
        _swa_attention_tc(q, k, v, out, **kw)
    else:
        _swa.launch_swa_attention(q, k, v, out, **kw)
        swa_attention.launches += 1
    return (out, rows) if lse else out


swa_attention.launches = 0


def _swa_bwd_launch(q, k, v, o, lse, do, *, window: int, causal: bool,
                    q_offset: int):
    """The backward of ``swa_attention`` on the card: (dq, dk, dv) in q's,
    k's and v's types from the saved q, k, v, output and logsumexp and
    the upstream gradient ``do``, by the backward kernels of the route
    that these tensors take: float32 on ``_swa_attention_bwd_f32``; bf16
    with Dh a multiple of 8 and q, k, v, do 16-byte aligned in place on
    ``_swa_attention_bwd``; any other bf16 on a packed copy,
    ``_swa_attention_bwd_packed``.  Each counts its calls: bf16 three
    launches (D = rowsum(do o), the dq kernel, then the dk/dv kernel),
    five on the packed route (two pack launches first); float32 two (dq,
    which takes D, then dk/dv)."""
    B, Hq, Tq, Dh = q.shape
    Tk = k.shape[2]
    if -(-max(Tq, Tk) // 64) > 65535:
        raise ValueError(f"Tq {Tq} or Tk {Tk} exceeds the backward "
                         f"kernels' grid of 65,535 tiles of 64")
    do = do.to(q.dtype).contiguous()
    grads = tuple(torch.empty_like(t) for t in (q, k, v))
    route = _swa.swa_route(q.dtype, Dh, aligned=all(
        t.data_ptr() % 16 == 0 for t in (q, k, v, do)))
    args = (q, k, v, o, lse, do, *grads)
    kw = dict(window=window, causal=causal, q_offset=q_offset,
              scale=1.0 / Dh ** 0.5)
    if route == "tf32x3":
        _swa_attention_bwd_f32(*args, **kw)
    elif route == "tensor_cores":
        _swa_attention_bwd(*args, **kw)
    else:
        _swa_attention_bwd_packed(*args, **kw)
    return grads


def _swa_attention_bwd(*args, **kw):
    """The bf16 backward kernels (wgmma, TMA) on q, k, v and do in place,
    counted."""
    _swa.launch_swa_attention_bwd(*args, **kw)
    _swa_attention_bwd.launches += 1


_swa_attention_bwd.launches = 0


def _swa_attention_bwd_packed(*args, **kw):
    """The bf16 backward kernels on a packed copy, counted."""
    _swa.launch_swa_attention_bwd_packed(*args, **kw)
    _swa_attention_bwd_packed.launches += 1


_swa_attention_bwd_packed.launches = 0


def _swa_attention_bwd_f32(*args, **kw):
    """The float32 backward kernels (split TF32 on the tensor cores),
    counted."""
    _swa.launch_swa_attention_bwd(*args, **kw)
    _swa_attention_bwd_f32.launches += 1


_swa_attention_bwd_f32.launches = 0


def _swa_attention_tc(q, k, v, out, **kw):
    """The tensor-core route of ``swa_attention`` on tensors it has
    checked, counted on its own."""
    _swa.launch_swa_attention_tc(q, k, v, out, **kw)
    _swa_attention_tc.launches += 1


_swa_attention_tc.launches = 0


def _swa_attention_tf32x3(q, k, v, out, **kw):
    """The float32 route of ``swa_attention`` (split TF32 on the tensor
    cores) on tensors it has checked, counted on its own."""
    _swa.launch_swa_attention_tf32x3(q, k, v, out, **kw)
    _swa_attention_tf32x3.launches += 1


_swa_attention_tf32x3.launches = 0


def ssd_scan(x, dt, A, B, C, *, chunk: int | None = None):
    """The Mamba2 SSD scan, the reference's ``ops.ssd_scan``: x (b, t, h,
    dh) float32 or bf16; dt (b, t, h), A (h,), B and C (b, t, n) floating;
    returns y like x.  ``chunk`` defaults to ``min(128, max(8, t))`` as in
    the reference; the reference's ``interpret`` has no counterpart.  On
    the card dt, A, B and C are taken as float32 (a copy when they are
    not), dh must be at most ``_ssd.MAX_HEAD_DIM`` (else ``ValueError``),
    and a state size n whose shared memory does not fit one CTA makes the
    launch fail with ``RuntimeError``.  One call is three CUDA launches
    (chunk states, state passing, chunk output), counted as one.  Under
    grad mode with an input that requires grad, the call runs inside
    ``SSDScan``: the same launches (and count) keep their chunk-state
    workspace for the backward, whose three launches (the state adjoint's
    two, the chunk gradients) count on ``_ssd_scan_bwd``; dt's, A's, B's
    and C's gradients come back in their callers' types."""
    if x.dim() != 4 or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be a 4-D float32 or bf16 tensor, got "
                        f"{x.dtype} of shape {tuple(x.shape)}")
    b, t, h, dh = x.shape
    if B.dim() != 3 or tuple(B.shape[:2]) != (b, t) or C.shape != B.shape \
            or tuple(dt.shape) != (b, t, h) or tuple(A.shape) != (h,):
        raise ValueError(f"for x {tuple(x.shape)}: dt must be (b, t, h), "
                         f"A (h,), B and C (b, t, n); got {tuple(dt.shape)}"
                         f", {tuple(A.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    for name, a in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not a.is_floating_point():
            raise TypeError(f"{name} must be floating, got {a.dtype}")
    chunk = int(chunk or min(_ssd.DEFAULT_CHUNK, max(8, t)))
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    if not _route(x, dt, A, B, C):
        return _ssd.ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    if not x.is_contiguous():
        raise ValueError("x must be contiguous on the card")
    if dh > _ssd.MAX_HEAD_DIM:
        raise ValueError(f"the SSD kernels take dh <= {_ssd.MAX_HEAD_DIM}, "
                         f"got {dh}")
    if _wants_grad(x, dt, A, B, C):
        return SSDScan.apply(functools.partial(_ssd_launch, save=True),
                             _ssd_scan_bwd, dict(chunk=chunk),
                             x, dt, A, B, C)
    return _ssd_launch(x, dt, A, B, C, chunk=chunk)


def _ssd_launch(x, dt, A, B, C, *, chunk: int, save: bool = False):
    """``ssd_scan``'s launch on checked CUDA tensors: dt, A, B, C as
    float32 copies, y new; with ``save``, (y, the states entering each
    chunk, the chunks' decays) from the same launches."""
    f32 = [a.to(torch.float32).contiguous() for a in (dt, A, B, C)]
    y = torch.empty_like(x)
    states, decay = _ssd.launch_ssd_scan(x, *f32, y, chunk=chunk)
    ssd_scan.launches += 1
    return (y, states, decay) if save else y


ssd_scan.launches = 0


def _ssd_grad_plan(x, B, C, *, chunk: int) -> _ssd.GradPlan:
    """The chunk-gradient launch ``_ssd_scan_bwd`` makes for these tensors:
    ``_ssd.chunk_grad_plan`` at x's and B's shapes and types and the
    card's shared memory (B and C passed in bf16 when both are bf16)."""
    return _ssd.chunk_grad_plan(
        B.shape[-1], chunk, x.shape[2], x.dtype == torch.bfloat16,
        B.dtype == C.dtype == torch.bfloat16,
        shared_memory_limit(x.device), _ssd.chunk_grad_smem)


def _ssd_scan_bwd(x, dt, A, B, C, states, decay, dy, *, chunk: int):
    """The backward of ``ssd_scan`` on the card: (dx, ddt, dA, dB, dC)
    from the saved inputs, states and decays and the upstream gradient
    ``dy``: the three backward launches (counted once, listed as
    ``ssd_scan_bwd``; where ``_ssd_grad_plan`` sends the chunk gradients
    to the CUDA-core kernel, counted once more as ``ssd_scan_bwd_fma``),
    then dB and dC summed over the head groups' partials and dA over
    (batch, chunk) by ``torch.sum`` (a fixed order: no atomics).  dx is in
    x's type, the rest float32."""
    b, t, h, _ = x.shape
    n = B.shape[-1]
    f32 = torch.float32
    plan = _ssd_grad_plan(x, B, C, chunk=chunk)
    dtf, Af, Bf, Cf = (a.to(f32).contiguous() for a in (dt, A, B, C))
    Bk, Ck = ((B.contiguous(), C.contiguous()) if plan.bc_bf16
              else (None, None))
    dy = dy.to(x.dtype).contiguous()
    dx = torch.empty_like(x)
    ddt = torch.empty(b, t, h, dtype=f32, device=x.device)
    dAp = torch.empty_like(decay)
    dBp = torch.empty(b, t, -(-h // plan.g), n, dtype=f32, device=x.device)
    dCp = torch.empty_like(dBp)
    launch = _ssd.launch_ssd_scan_bwd if plan.tc else _ssd_scan_bwd_fma
    launch(x, dtf, Af, Bf, Cf, states, decay, dy, dx, ddt, dBp, dCp, dAp,
           chunk=chunk, plan=plan, Bk=Bk, Ck=Ck)
    _ssd_scan_bwd.launches += 1
    return dx, ddt, dAp.sum((0, 2)), dBp.sum(2), dCp.sum(2)


def _ssd_scan_bwd_fma(*args, **kw):
    """The backward launches with the chunk gradients on the CUDA-core
    ``ssd_chunk_grad_kernel``, the route ``_ssd_grad_plan`` takes where
    the tensor-core kernel does not fit (chunks past 128, n past 128,
    float32 B and C at n 128), counted on its own."""
    _ssd.launch_ssd_scan_bwd(*args, **kw)
    _ssd_scan_bwd_fma.launches += 1


_ssd_scan_bwd_fma.launches = 0
_ssd_scan_bwd.launches = 0

# ---------------------------------------------------------------- serial --


def dso_serial_epoch(ii, jj, vv, order, w, alpha, gw, ga, y, row_nnz,
                     col_nnz, scalars, *, loss_name: str, reg_name: str,
                     use_adagrad: bool = True):
    """One paper-exact serial epoch (Algorithm 1 at p = 1), in place on
    ``w``, ``gw`` (d,) and ``alpha``, ``ga`` (m,): the nonzeros (ii, jj,
    vv) (nnz,) visited in ``order`` (nnz,), a permutation of 0..nnz-1,
    each taking the Eq.-8 step; ``scalars`` = (eta, lam, m, w_lo, w_hi).
    On the card one launch of ``csrc/dso_serial.cu``'s rounds kernel, as
    ``serial_epoch_route`` plans it; the indices are not checked there, so
    they must lie in range."""
    nnz, (m, d) = ii.numel(), (alpha.numel(), w.numel())
    for name, t, dtype, n in (("ii", ii, torch.int32, nnz),
                              ("jj", jj, torch.int32, nnz),
                              ("vv", vv, torch.float32, nnz),
                              ("order", order, torch.int32, nnz),
                              ("w", w, torch.float32, d),
                              ("gw", gw, torch.float32, d),
                              ("col_nnz", col_nnz, torch.float32, d),
                              ("alpha", alpha, torch.float32, m),
                              ("ga", ga, torch.float32, m),
                              ("y", y, torch.float32, m),
                              ("row_nnz", row_nnz, torch.float32, m)):
        _expect(name, t, dtype, (n,))
    if loss_name not in dso_update.LOSS_IDS \
            or reg_name not in dso_update.REG_IDS:
        raise ValueError(f"unknown loss/reg {loss_name!r}/{reg_name!r}")
    scal = _scalars(scalars)
    args = (ii, jj, vv, order, w, alpha, gw, ga, y, row_nnz, col_nnz)
    if not _route(*args):
        dso_serial.serial_epoch_plain(*args, scal, loss_name, reg_name,
                                      use_adagrad)
        return
    plan = serial_epoch_route(m, d, nnz,
                              smem_limit=shared_memory_limit(w.device),
                              max_cluster=serial_max_cluster(w.device))
    dso_serial.launch_serial_epoch(*args, scal, loss_name, reg_name,
                                   use_adagrad, plan=plan)
    dso_serial_epoch.launches += 1


dso_serial_epoch.launches = 0


def serial_epoch_route(m: int, d: int, nnz: int, *, smem_limit: int,
                       max_cluster: int) -> dso_serial.SerialPlan:
    """The plan of a serial epoch over nnz nonzeros of an (m, d) problem on
    a card whose block may take ``smem_limit`` bytes of shared memory and
    whose largest cluster of the global kernel is ``max_cluster``: the
    window, the threads, the cluster and staged or global
    (``dso_serial.serial_plan``).  Raises ``ValueError`` when none fits."""
    return dso_serial.serial_plan(m, d, nnz, smem_limit=smem_limit,
                                  max_cluster=max_cluster)


@functools.lru_cache(maxsize=None)
def serial_max_cluster(device) -> int:
    """The largest cluster of the global serial kernel the card ``device``
    can hold (``dso_serial.max_cluster``), read once per device."""
    with torch.cuda.device(device):
        return dso_serial.max_cluster()

# ------------------------------------------------------------- baselines --


def _check_rows_x(X, y):
    if X.dim() != 2:
        raise ValueError(f"X must be (m, d), got {tuple(X.shape)}")
    _expect("X", X, torch.float32, X.shape)
    _expect("y", y, torch.float32, (X.shape[0],))


def sgd_epoch_route(d: int, batch: int = 1, *, smem_limit: int,
                    max_cluster: int) -> _baselines.EpochPlan:
    """The plan of an SGD epoch kernel over d columns at ``batch`` rows a
    step on a card whose blocks may take ``smem_limit`` bytes of shared
    memory and whose largest cluster is ``max_cluster`` blocks: the
    cluster's blocks, the slice width and staged or global
    (``baselines.epoch_plan``).  Raises ``ValueError`` when none fits."""
    return _baselines.epoch_plan("sgd", d, batch, smem_limit=smem_limit,
                                 max_cluster=max_cluster)


def dcd_epoch_route(d: int, *, smem_limit: int,
                    max_cluster: int) -> _baselines.EpochPlan:
    """The plan of a DCD epoch kernel over d columns, as
    ``sgd_epoch_route``'s."""
    return _baselines.epoch_plan("dcd", d, 1, smem_limit=smem_limit,
                                 max_cluster=max_cluster)


@functools.lru_cache(maxsize=None)
def max_cluster(device) -> int:
    """The largest cluster of the baselines' epoch kernels the card
    ``device`` can hold (``baselines.max_cluster``), read once per
    device."""
    with torch.cuda.device(device):
        return _baselines.max_cluster()


def _card_limits(t) -> dict:
    return dict(smem_limit=shared_memory_limit(t.device),
                max_cluster=max_cluster(t.device))


def sgd_epoch(X, y, rows, w, acc, eta0: float, lam: float, *,
              loss_name: str, reg_name: str, batch: int = 1):
    """One AdaGrad SGD epoch (the reference's ``_sgd_epoch``) for each of
    n workers, in place on ``w`` and ``acc`` (n, d): worker q visits the
    rows ``rows[q]`` ((n, nsteps * batch) int32; -1 a padding row with x
    and y 0) of X (m, d) in steps of ``batch``.  On the card one launch of
    ``csrc/baselines.cu`` (a thread-block cluster per worker, as
    ``sgd_epoch_route`` plans it); the row ids are not checked there, so
    they must lie in -1 .. m-1."""
    _check_rows_x(X, y)
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    if rows.dim() != 2 or rows.shape[1] % batch:
        raise ValueError(f"rows must be (n_workers, nsteps * batch), got "
                         f"{tuple(rows.shape)} at batch {batch}")
    _expect("rows", rows, torch.int32, rows.shape)
    shape = (rows.shape[0], X.shape[1])
    _expect("w", w, torch.float32, shape)
    _expect("acc", acc, torch.float32, shape)
    if loss_name not in dso_update.LOSS_IDS \
            or reg_name not in dso_update.REG_IDS:
        raise ValueError(f"unknown loss/reg {loss_name!r}/{reg_name!r}")
    args = (X, y, rows, w, acc, float(eta0), float(lam), loss_name,
            reg_name, int(batch))
    if not _route(X, y, rows, w, acc):
        _baselines.sgd_epoch_plain(*args)
        return
    if X.shape[1] == 0 or rows.shape[0] == 0:
        return
    plan = sgd_epoch_route(X.shape[1], int(batch), **_card_limits(w))
    _baselines.launch_sgd_epoch(*args, plan=plan)
    sgd_epoch.launches += 1


sgd_epoch.launches = 0


def dcd_epoch(X, y, perm, w, beta, lam: float, xnorm2):
    """One hinge-loss dual coordinate descent epoch (the reference's
    ``_dcd_epoch``), in place on ``w`` (d,) and ``beta`` (m,): the rows
    ``perm`` ((n,) int32; ids may repeat) of X (m, d) in turn; ``xnorm2``
    (m,) holds each row's squared norm.  On the card one launch of
    ``csrc/baselines.cu`` (one thread-block cluster, as
    ``dcd_epoch_route`` plans it); the row ids are not checked there, so
    they must lie in 0 .. m-1."""
    _check_rows_x(X, y)
    m, d = X.shape
    if perm.dim() != 1:
        raise ValueError(f"perm must be 1-D, got {tuple(perm.shape)}")
    _expect("perm", perm, torch.int32, perm.shape)
    _expect("w", w, torch.float32, (d,))
    _expect("beta", beta, torch.float32, (m,))
    _expect("xnorm2", xnorm2, torch.float32, (m,))
    args = (X, y, perm, w, beta, float(lam), xnorm2)
    if not _route(X, y, perm, w, beta, xnorm2):
        _baselines.dcd_epoch_plain(*args)
        return
    if d == 0:
        return
    plan = dcd_epoch_route(d, **_card_limits(w))
    _baselines.launch_dcd_epoch(*args, plan=plan)
    dcd_epoch.launches += 1


dcd_epoch.launches = 0


_COUNTED = (sparse_probe, dso_primal_update, dso_sparse_block_step,
            dso_bucketed_block_step, _dso_bucketed_block_step_shared,
            dso_block_step, dso_tile_step,
            _dso_tile_step_twopass, swa_attention, _swa_attention_tc,
            _swa_attention_tf32x3, _swa_attention_bwd,
            _swa_attention_bwd_packed, _swa_attention_bwd_f32, ssd_scan,
            _ssd_scan_bwd, _ssd_scan_bwd_fma, dso_serial_epoch, sgd_epoch,
            dcd_epoch)


def reset_launch_counts():
    """Set every wrapper's launch count to 0."""
    for fn in _COUNTED:
        fn.launches = 0


def launch_counts() -> dict:
    """Each wrapper's launch count by its public name (the two-pass
    step's under ``dso_tile_step_twopass``, the tensor-core attention's
    under ``swa_attention_tc`` and ``swa_attention_tf32x3``, the
    attention's backward under ``swa_attention_bwd`` (bf16 in place),
    ``swa_attention_bwd_packed`` and ``swa_attention_bwd_f32``, the SSD
    scan's under ``ssd_scan_bwd`` (its CUDA-core chunk gradients also
    under ``ssd_scan_bwd_fma``), the bucketed shared route's under
    ``dso_bucketed_block_step_shared``)."""
    return {fn.__name__.lstrip("_"): fn.launches for fn in _COUNTED}
