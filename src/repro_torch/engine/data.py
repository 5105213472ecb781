"""Grid state and the common ``TileData`` view consumed by every backend.

The p x p DSO grid exists in three layouts: dense row shards
(``GridData``, built by ``make_grid_data``), uniform block-ELL tiles
(``SparseGridData``) and K-bucketed tiles (``BucketedGridData``).
``as_tile_data`` turns any of them into a ``TileData`` whose ``arrays``
field carries the layout payload — ``(Xg,)`` dense, ``(cols_g, vals_g)``
block-ELL, the flat chunk view ``(cols_fl, vals_fl, chunk_lut,
chunk_cnt)`` K-bucketed (or, for the ``*_switch`` backends, the
per-bucket rectangles and the (p, p) bucket maps) — next to the labels,
scaling statistics and padding masks.

``state_from_arrays`` / ``tile_data_from_arrays`` take dicts of numpy
arrays under the reference's field names, so a JAX run's state or grid
(``np.asarray`` of each leaf) continues in the port.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.losses import get_loss, w_bounds
from repro_torch.device import resolve_device
from repro_torch.sparse.format import (BucketedGridData, SparseGridData,
                                       pad_to_multiple)


class GridData(NamedTuple):
    """Problem data laid out on the p x p DSO grid (row-major padding),
    tensors on one device.  The ``tile_*_nnz_g`` fields are the grid's
    static sparsity statistics, counted once by ``make_grid_data``."""

    Xg: torch.Tensor         # (p, mb, d_pad)  row shard per processor
    yg: torch.Tensor         # (p, mb)
    row_nnz_g: torch.Tensor  # (p, mb)   |Omega_i|, >= 1
    col_nnz: torch.Tensor    # (d_pad,)  |Omega-bar_j|, >= 1
    row_valid: torch.Tensor  # (p, mb)   1.0 for real rows, 0.0 padding
    p: int
    mb: int                  # rows per processor
    db: int                  # columns per block
    # [q, s, j]: nnz of column j within row batch s of processor q's shard
    tile_col_nnz_g: torch.Tensor = None   # (p, n_rb, d_pad)
    # [q, b, i]: nnz of row i of processor q within block b's columns
    tile_row_nnz_g: torch.Tensor = None   # (p, p, mb)


class TileData(NamedTuple):
    """Layout-agnostic view of the grid (tensors on one device)."""

    arrays: tuple                  # (Xg,) | (cols_g, vals_g) | chunk view
    yg: torch.Tensor               # (p, mb)
    row_nnz_g: torch.Tensor        # (p, mb)
    col_nnz: torch.Tensor          # (d_pad,)
    row_valid: torch.Tensor        # (p, mb)
    tile_col_nnz_g: torch.Tensor   # (p, n_rb, d_pad)
    tile_row_nnz_g: torch.Tensor   # (p, p, mb)

    @property
    def layout(self) -> str:
        n = len(self.arrays)
        if n in (1, 2):
            return ("dense", "sparse")[n - 1]
        if n >= 4 and n % 2 == 0:
            return "bucketed"     # the flat chunk view or the rectangles
        raise ValueError(f"no layout has a {n}-array payload")


class DSOState(NamedTuple):
    """Solver state.  The epoch driver updates the tensors IN PLACE (the
    reference donates them to its jitted scan); ``epoch`` is a Python int
    replaced at each epoch."""

    w_grid: torch.Tensor    # (p, db)  w block by block id
    gw_grid: torch.Tensor   # (p, db)  its AdaGrad accumulator
    alpha: torch.Tensor     # (p, mb)
    ga: torch.Tensor        # (p, mb)
    epoch: int


def as_tile_data(data, *, bucketed_payload: str = "flat") -> TileData:
    """``GridData`` | ``SparseGridData`` | ``BucketedGridData`` |
    ``TileData`` -> ``TileData``.

    ``bucketed_payload`` picks the bucketed layout's payload (each backend
    names its own, ``TileBackend.payload``): ``"flat"``, the flat chunk
    view the one-kernel backends stream; ``"buckets"``, the per-bucket
    rectangles ``(cols_0, vals_0, ..., cols_{n-1}, vals_{n-1})`` (uploaded
    here from their host numpy form to the grid's device) followed by
    ``bucket_id`` and ``bucket_pos``, which the ``*_switch`` backends
    dispatch over."""
    if isinstance(data, TileData):
        return data
    if isinstance(data, BucketedGridData):
        if bucketed_payload == "flat":
            arrays = (data.cols_fl, data.vals_fl, data.chunk_lut,
                      data.chunk_cnt)
        elif bucketed_payload == "buckets":
            dev = data.yg.device
            arrays = tuple(torch.as_tensor(a, device=dev)
                           for cv in zip(data.cols_b, data.vals_b)
                           for a in cv) + (data.bucket_id, data.bucket_pos)
        else:
            raise ValueError(f"bucketed_payload must be 'flat' or "
                             f"'buckets', got {bucketed_payload!r}")
    elif isinstance(data, SparseGridData):
        arrays = (data.cols_g, data.vals_g)
    elif isinstance(data, GridData):
        arrays = (data.Xg,)
    else:
        raise TypeError(f"{type(data).__name__} is not grid data")
    return TileData(arrays=arrays, yg=data.yg, row_nnz_g=data.row_nnz_g,
                    col_nnz=data.col_nnz, row_valid=data.row_valid,
                    tile_col_nnz_g=data.tile_col_nnz_g,
                    tile_row_nnz_g=data.tile_row_nnz_g)


def tile_dims(data) -> tuple[int, int, int]:
    """(p, mb, db) of any grid container, from shapes alone."""
    if isinstance(data, TileData):
        p, mb = data.yg.shape
        return p, mb, data.col_nnz.shape[0] // p
    return data.p, data.mb, data.db


#: rows per processor of one pass of ``make_grid_data``'s statistics
_STATS_ROWS = 1 << 13


def make_grid_data(prob, p: int, row_batches: int = 1) -> GridData:
    """Dense-layout grid of a ``Problem``, on the Problem's own device: X
    padded with zero rows and columns to multiples of p and cut into p row
    shards, and the static tile statistics counted on the device (X never
    goes through the host).  When no padding is needed ``Xg`` is a view of
    ``prob.X``, so the grid adds no copy of X; the statistics are counted
    ``_STATS_ROWS`` rows per processor at a time, so their scratch stays
    small beside X."""
    m, d = prob.m, prob.d
    m_pad, d_pad = pad_to_multiple(m, p), pad_to_multiple(d, p)
    mb, db = m_pad // p, d_pad // p
    dev = prob.device
    f32 = torch.float32
    if (m_pad, d_pad) == (m, d):
        Xg = prob.X.to(f32).contiguous().view(p, mb, d_pad)
    else:
        X = torch.zeros((m_pad, d_pad), dtype=f32, device=dev)
        X[:m, :d] = prob.X
        Xg = X.view(p, mb, d_pad)

    def rows(v, pad: float):
        out = torch.full((m_pad,), pad, dtype=f32, device=dev)
        out[:m] = v
        return out.view(p, mb)

    col_nnz = torch.ones(d_pad, dtype=f32, device=dev)
    col_nnz[:d] = prob.col_nnz
    rb = max(1, mb // row_batches)
    n_rb = mb // rb
    tile_col_nnz = torch.zeros((p, n_rb, d_pad), dtype=f32, device=dev)
    tile_row_nnz = torch.empty((p, p, mb), dtype=f32, device=dev)
    for r0 in range(0, mb, _STATS_ROWS):
        r1 = min(r0 + _STATS_ROWS, mb)
        nz = Xg[:, r0:r1] != 0                        # (p, rows, d_pad)
        tile_row_nnz[:, :, r0:r1] = \
            nz.view(p, r1 - r0, p, db).sum(dim=3).transpose(1, 2)
        batch = torch.arange(r0, r1, device=dev) // rb
        keep = batch < n_rb                           # rows past the batches
        tile_col_nnz.index_add_(1, batch[keep], nz[:, keep].to(f32))
    return GridData(
        Xg=Xg, yg=rows(prob.y, 0.0), row_nnz_g=rows(prob.row_nnz, 1.0),
        col_nnz=col_nnz, row_valid=rows(1.0, 0.0), p=p, mb=mb, db=db,
        tile_col_nnz_g=tile_col_nnz, tile_row_nnz_g=tile_row_nnz)


def init_state(prob, data, alpha0: float = 0.0) -> DSOState:
    """``init_state_data`` with the loss read from the ``Problem``."""
    return init_state_data(prob.loss_name, data, alpha0)


def init_state_data(loss_name: str, data, alpha0: float = 0.0) -> DSOState:
    """Fresh state on the grid's device: w = 0, alpha = alpha0 projected
    onto the loss's domain (0 on padding rows), AdaGrad sums 0."""
    p, mb, db = tile_dims(data)
    dev = data.yg.device
    alpha = torch.full((p, mb), float(alpha0), dtype=torch.float32,
                       device=dev)
    alpha = get_loss(loss_name).project_alpha(alpha, data.yg) * data.row_valid
    return DSOState(
        w_grid=torch.zeros((p, db), dtype=torch.float32, device=dev),
        gw_grid=torch.zeros((p, db), dtype=torch.float32, device=dev),
        alpha=alpha.contiguous(),
        ga=torch.zeros((p, mb), dtype=torch.float32, device=dev),
        epoch=0)


def state_from_arrays(arrays: dict, device="cuda") -> DSOState:
    """``DSOState`` from numpy arrays under the reference's field names
    (``w_grid``, ``gw_grid``, ``alpha``, ``ga``, ``epoch``); the tensors
    are fresh copies on ``device``."""
    dev = resolve_device(device)

    def t(k):
        return torch.tensor(np.asarray(arrays[k], np.float32), device=dev)

    return DSOState(w_grid=t("w_grid"), gw_grid=t("gw_grid"),
                    alpha=t("alpha"), ga=t("ga"),
                    epoch=int(np.asarray(arrays["epoch"])))


def tile_data_from_arrays(arrays: dict, device="cuda"):
    """Grid data from numpy arrays under the reference's field names: a
    ``TileData`` from its fields, ``arrays["arrays"]`` being the layout
    payload tuple; or, from ``GridData``'s fields (``Xg``, ..., ``p``,
    ``mb``, ``db``), a dense ``GridData``.  Int payload arrays become
    int32, the rest float32."""
    dev = resolve_device(device)

    def t(a):
        a = np.asarray(a)
        dt = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        return torch.tensor(a.astype(dt), device=dev)

    if "Xg" in arrays:
        return GridData(**{k: int(np.asarray(arrays[k]))
                           if k in ("p", "mb", "db") else t(arrays[k])
                           for k in GridData._fields})
    return TileData(arrays=tuple(t(a) for a in arrays["arrays"]),
                    **{k: t(arrays[k]) for k in TileData._fields
                       if k != "arrays"})


_LAYOUT_BUILDERS = {"dense": "make_grid_data",
                    "sparse": "sparse_grid_from_csr",
                    "bucketed": "bucketed_grid_from_csr"}


def check_tile_stats(data, row_batches: int):
    """The stats' tile height must equal the epoch's tile height, or the
    per-tile counts silently describe the wrong row grouping."""
    layout = as_tile_data(data).layout
    builder = _LAYOUT_BUILDERS[layout]
    mb = data.yg.shape[1]
    if data.tile_col_nnz_g is None:
        raise ValueError(f"grid data lacks tile stats: build it with "
                         f"{builder}")
    if mb // data.tile_col_nnz_g.shape[1] != mb // row_batches:
        raise ValueError(f"grid stats built for a different row grouping: "
                         f"{builder}(..., row_batches={row_batches}) "
                         f"required")


def gather_w(state: DSOState, d: int) -> torch.Tensor:
    return state.w_grid.reshape(-1)[:d]


def gather_alpha(state: DSOState, m: int) -> torch.Tensor:
    return state.alpha.reshape(-1)[:m]


def eta_schedule(eta0: float, t0: int, n: int, use_adagrad: bool) -> list:
    """Per-epoch step sizes for epochs t0+1 .. t0+n as float32 values
    (1/sqrt(t) when the AdaGrad scaling is off — Theorem 1's schedule)."""
    etas = np.asarray([eta0 if use_adagrad else eta0 / np.sqrt(t)
                       for t in range(t0 + 1, t0 + n + 1)], np.float32)
    return [float(e) for e in etas]


def prob_meta(prob):
    """(lam, m, loss_name, reg_name, use_adagrad, w_lo, w_hi) of a Problem,
    every number a float32 value."""
    w_lo, w_hi = w_bounds(prob.loss_name, prob.lam)
    return (float(np.float32(prob.lam)), float(np.float32(prob.m)),
            prob.loss_name, prob.reg_name, True, w_lo, w_hi)
