"""Grid state and the common ``TileData`` view consumed by every backend.

``as_tile_data`` turns a ``SparseGridData`` or a ``BucketedGridData`` into
a ``TileData`` whose ``arrays`` field carries the layout payload —
``(cols_g, vals_g)`` for block-ELL, the flat chunk view ``(cols_fl,
vals_fl, chunk_lut, chunk_cnt)`` for K-bucketed — next to the labels,
scaling statistics and padding masks.  The dense ``GridData`` and
``make_grid_data`` come with the dense slice.

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
from repro_torch.sparse.format import BucketedGridData, SparseGridData


class TileData(NamedTuple):
    """Layout-agnostic view of the grid (tensors on one device)."""

    arrays: tuple                  # (cols_g, vals_g) | flat chunk view
    yg: torch.Tensor               # (p, mb)
    row_nnz_g: torch.Tensor        # (p, mb)
    col_nnz: torch.Tensor          # (d_pad,)
    row_valid: torch.Tensor        # (p, mb)
    tile_col_nnz_g: torch.Tensor   # (p, n_rb, d_pad)
    tile_row_nnz_g: torch.Tensor   # (p, p, mb)

    @property
    def layout(self) -> str:
        if len(self.arrays) == 2:
            return "sparse"
        if len(self.arrays) == 4:
            return "bucketed"
        raise ValueError(f"no layout has a {len(self.arrays)}-array payload "
                         f"in this slice (the dense layout comes later)")


class DSOState(NamedTuple):
    """Solver state.  The epoch driver updates the tensors IN PLACE (the
    reference donates them to its jitted scan); ``epoch`` is a Python int
    replaced at each epoch."""

    w_grid: torch.Tensor    # (p, db)  w block by block id
    gw_grid: torch.Tensor   # (p, db)  its AdaGrad accumulator
    alpha: torch.Tensor     # (p, mb)
    ga: torch.Tensor        # (p, mb)
    epoch: int


def as_tile_data(data) -> TileData:
    """``SparseGridData`` | ``BucketedGridData`` | ``TileData`` ->
    ``TileData``."""
    if isinstance(data, TileData):
        return data
    if isinstance(data, BucketedGridData):
        arrays = (data.cols_fl, data.vals_fl, data.chunk_lut, data.chunk_cnt)
    elif isinstance(data, SparseGridData):
        arrays = (data.cols_g, data.vals_g)
    else:
        raise NotImplementedError(
            f"{type(data).__name__}: only the sparse and bucketed layouts "
            f"are ported; the dense GridData comes with the dense slice "
            f"(ROADMAP queue 1)")
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


def tile_data_from_arrays(arrays: dict, device="cuda") -> TileData:
    """``TileData`` from numpy arrays under the reference's ``TileData``
    field names; ``arrays["arrays"]`` is the layout payload tuple (int
    payload arrays become int32, the rest float32)."""
    dev = resolve_device(device)

    def t(a):
        a = np.asarray(a)
        dt = np.int32 if np.issubdtype(a.dtype, np.integer) else np.float32
        return torch.tensor(a.astype(dt), device=dev)

    return TileData(arrays=tuple(t(a) for a in arrays["arrays"]),
                    **{k: t(arrays[k]) for k in TileData._fields
                       if k != "arrays"})


_LAYOUT_BUILDERS = {"sparse": "sparse_grid_from_csr",
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
