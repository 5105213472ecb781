"""Live p -> p' resharding of a checkpointed DSO run.

The p chosen at ingest fixes the grid: the tile layout, the per-tile
statistics and the blocked state.  Resharding rebuilds all of it for p'
from the grid itself (host numpy, as in the reference; the result goes
back to the grid's device):

* **data** — when the padded sizes agree and p/p' divide evenly,
  ``sparse.format.regrid_direct`` re-blocks tile to tile; otherwise
  ``sparse.format.grid_to_csr`` rebuilds the global CSR and the tilers
  re-tile it at p'.  Both give the same grid, field for field;
* **state** — ``reshard_state`` gathers w/alpha and their AdaGrad sums to
  the real (d,)/(m,) coordinates, pads for p' and re-blocks; padding
  restarts at 0 as a fresh run at p' makes it, so it is the same iterate
  on the new grid;
* **config** — p/mb/db are rewritten so ``runtime.resume`` replays the
  right call.

At p' == p the reshard is the identity and the continued run equals the
uninterrupted one; at p' != p the schedule changes (p' inner iterations
of p'-sized blocks), a different serializable execution from the same
iterate.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from repro_torch.engine.backends import get_backend
from repro_torch.engine.data import DSOState, make_grid_data
from repro_torch.runtime.snapshot import DSOSnapshot
from repro_torch.sparse.format import (bucketed_grid_from_csr, grid_to_csr,
                                       pad_to_multiple, regrid_direct,
                                       sparse_grid_from_csr)


def _repartition(vec, n: int, p_new: int) -> torch.Tensor:
    """(p, xb) blocked vector -> its n real coordinates -> (p', xb'), on
    the vector's device."""
    flat = vec.detach().reshape(-1)[:n].cpu().numpy()
    n_pad = pad_to_multiple(n, p_new)
    out = np.zeros(n_pad, flat.dtype)
    out[:n] = flat
    return torch.as_tensor(out.reshape(p_new, n_pad // p_new),
                           device=vec.device)


def reshard_state(state: DSOState, m: int, d: int, p_new: int) -> DSOState:
    """Repartition a blocked ``DSOState`` onto the p' grid of the same
    (m, d) problem (fresh tensors; the identity at p' == p)."""
    return DSOState(
        w_grid=_repartition(state.w_grid, d, p_new),
        gw_grid=_repartition(state.gw_grid, d, p_new),
        alpha=_repartition(state.alpha, m, p_new),
        ga=_repartition(state.ga, m, p_new),
        epoch=state.epoch,
    )


def retile(data, m: int, d: int, p_new: int, *, row_batches: int = 1,
           layout: str | None = None):
    """Rebuild any grid at p' from its own tiles, on its device.

    ``layout`` defaults to the input's ("dense" builds a ``GridData``,
    "sparse"/"bucketed" go through the block-ELL tilers).  Packed layouts
    take ``regrid_direct`` when it applies, the CSR round trip otherwise
    (and for dense); the statistics come from the same addressing pass a
    fresh tiling at p' runs."""
    if layout is None:
        layout = ("dense" if hasattr(data, "Xg")
                  else "bucketed" if hasattr(data, "bucket_id") else "sparse")
    dev = data.yg.device
    if layout in ("sparse", "bucketed"):
        direct = regrid_direct(data, m, d, p_new, row_batches,
                               layout=layout)
        if direct is not None:
            return direct
    csr, y = grid_to_csr(data, m, d)
    if layout == "sparse":
        return sparse_grid_from_csr(csr, y, p_new, row_batches, device=dev)
    if layout == "bucketed":
        return bucketed_grid_from_csr(csr, y, p_new, row_batches,
                                      device=dev)
    if layout != "dense":
        raise ValueError(f"unknown layout {layout!r}: dense|sparse|bucketed")
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=dev)
    src = SimpleNamespace(   # the Problem fields make_grid_data reads
        X=t(csr.toarray()), y=t(y), m=m, d=d, device=dev,
        row_nnz=t(np.maximum(csr.row_nnz(), 1.0)),
        col_nnz=t(np.maximum(csr.col_nnz(), 1.0)))
    return make_grid_data(src, p_new, row_batches)


def reshard(snap: DSOSnapshot, p_new: int, *, data=None,
            row_batches: int | None = None):
    """Reshard a snapshot from its recorded p to ``p_new``: returns
    ``(snapshot', data')``, the state repartitioned and the config
    rewritten for p', and ``data`` re-tiled (``None`` when not given: a
    Problem source rebuilds its grid inside ``solve``).  Continue with
    ``runtime.resume.resume(source, store, snapshot=snap2)`` or
    ``engine.solve(..., p=p_new, init=snap2)``."""
    cfg = dict(snap.config)
    m, d = cfg["m"], cfg["d"]
    rb = cfg["row_batches"] if row_batches is None else row_batches
    state2 = reshard_state(snap.state, m, d, p_new)
    data2 = None
    if data is not None:
        data2 = retile(data, m, d, p_new, row_batches=rb,
                       layout=get_backend(cfg["backend"]).layout)
    cfg.update(p=p_new, db=int(state2.w_grid.shape[1]),
               mb=int(state2.alpha.shape[1]), row_batches=rb)
    return DSOSnapshot(state=state2, key=snap.key,
                       epochs_done=snap.epochs_done,
                       history=snap.history, config=cfg), data2
