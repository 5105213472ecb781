"""Driver layer: the epoch loop behind ``solve``.

``run_epochs`` runs a chunk of epochs, each ``epoch_body``: p inner
iterations, each ONE batched block step of all p processors on their
disjoint active blocks (the reference vmaps ``inner_iteration`` over the
processors inside a donated ``lax.scan``; the port batches the processors
inside each backend and updates the ``DSOState`` tensors in place).
``solve`` wraps it in the evaluation-chunk loop.

With a block-step kernel backend (``sparse_pallas``,
``sparse_bucketed_pallas``, ``dense_pallas_block``) one inner iteration is
``2 * row_batches`` kernel launches (a dual/scatter launch and a primal
launch per row tile, every processor in each), so one epoch is
``2 * p * row_batches`` launches; ``dense_pallas_fused`` launches per
processor, ``2 * p * p * row_batches``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.losses import w_bounds
from repro_torch.core.saddle import Problem
from repro_torch.device import resolve_device
from repro_torch.engine.backends import (TileBackend, get_backend,
                                         resolve_backend,
                                         resolve_backend_for_layout)
from repro_torch.engine.data import (DSOState, as_tile_data,
                                     check_tile_stats, eta_schedule,
                                     gather_alpha, gather_w, init_state_data,
                                     make_grid_data, prob_meta, tile_dims)
from repro_torch.engine.evaluate import problem_eval_hook
from repro_torch.engine.schedules import get_schedule
from repro_torch.sparse.format import (SPARSE_DENSITY_THRESHOLD, density,
                                       make_bucketed_grid_data,
                                       make_sparse_grid_data,
                                       problem_k_per_tile, tile_k_skew)


class SolveResult(NamedTuple):
    """Gathered (unpadded) iterates, the evaluation-hook history and the
    final grid state."""

    w: torch.Tensor
    alpha: torch.Tensor
    history: list
    state: Any = None


def resolve_backend_and_build(prob: Problem, impl, p: int, row_batches: int):
    """Resolve the backend — probing the per-tile-K skew only when
    ``auto`` is already in the sparse density regime — then build the grid
    in that backend's layout on the problem's device."""
    k_skew = (tile_k_skew(problem_k_per_tile(prob, p))
              if impl == "auto"
              and density(prob) < SPARSE_DENSITY_THRESHOLD else None)
    be = resolve_backend(impl, density(prob), k_skew=k_skew,
                         device_type=prob.device.type)
    if be.layout == "dense":
        return be, make_grid_data(prob, p, row_batches)
    builders = {"sparse": make_sparse_grid_data,
                "bucketed": make_bucketed_grid_data}
    return be, builders[be.layout](prob, p, row_batches, device=prob.device)


# ----------------------------------------------------- inner iteration --


def stage_block(data, blk_ids) -> torch.Tensor:
    """Stage the active blocks of one inner iteration: the (p,) int32
    block ids, contiguous on the grid's device.  The reference stages the
    per-block statistic slices here; in the port the kernels read every
    per-block slice in place by block id (the dense kernel reads columns
    [blk_ids[q] * db, (blk_ids[q] + 1) * db) of processor q's rows of
    ``Xg``, with no staged copy) and the plain twins gather their own, so
    the id vector is the whole stage."""
    return blk_ids.to(device=data.yg.device, dtype=torch.int32).contiguous()


def staged_step(backend: TileBackend, meta, data, state: DSOState, blk_ids,
                eta_t: float, row_batches: int):
    """Run all tile steps of the staged blocks, in place on ``state``."""
    backend.block_step(meta, data, state, blk_ids, eta_t, row_batches)


def inner_iteration(backend: TileBackend, meta, data, state: DSOState,
                    blk_ids, eta_t: float, row_batches: int):
    """One inner iteration of Algorithm 1: every processor q runs its
    active block ``blk_ids[q]`` (``meta`` = (lam, m, loss_name, reg_name,
    use_adagrad, w_lo, w_hi)); in place."""
    staged_step(backend, meta, data, state, stage_block(data, blk_ids),
                eta_t, row_batches)


def epoch_body(backend: TileBackend, data, state: DSOState, perm, eta_t,
               meta, *, row_batches: int, p: int) -> DSOState:
    """One epoch under a ``(p, p)`` permutation schedule, ``perm[r, q]`` =
    block of processor q at inner iteration r."""
    for r in range(p):
        inner_iteration(backend, meta, data, state, perm[r], eta_t,
                        row_batches)
    return state._replace(epoch=state.epoch + 1)


def run_epochs(data, state: DSOState, perms, etas, lam: float, m: float,
               w_lo: float, w_hi: float, *, backend, loss_name: str,
               reg_name: str, use_adagrad: bool = True,
               row_batches: int = 1) -> DSOState:
    """``len(etas)`` epochs; ``perms`` (n_epochs, p, p).  Updates the state
    tensors in place (the reference donates them) and returns the state
    with its epoch count advanced."""
    be = get_backend(backend)
    tile = as_tile_data(data)
    p = tile.yg.shape[0]
    perms = torch.as_tensor(perms).to(device=tile.yg.device,
                                      dtype=torch.int32)
    meta = (lam, m, loss_name, reg_name, use_adagrad, w_lo, w_hi)
    for k, eta_t in enumerate(etas):
        state = epoch_body(be, tile, state, perms[k], float(eta_t), meta,
                           row_batches=row_batches, p=p)
    return state


def _next_multiple(t: int, k: int) -> int:
    return (t // k + 1) * k


_LATER = {
    "store": "the elastic runtime (ROADMAP queue 1: runtime)",
    "init": "the elastic runtime (ROADMAP queue 1: runtime)",
    "health": "the elastic runtime (ROADMAP queue 1: runtime)",
    "obs": "observability (ROADMAP queue 1: obs)",
    "telemetry": "observability (ROADMAP queue 1: obs)",
}


def solve(source, *, backend="auto", schedule="cyclic", p: int = 4,
          epochs: int = 10, eta0: float = 0.1, use_adagrad: bool = True,
          row_batches: int = 1, alpha0: float = 0.0, eval_every: int = 1,
          seed: int = 0, eval_hook="auto", loss_name: str | None = None,
          reg_name: str | None = None, lam: float | None = None,
          m: int | None = None, d: int | None = None, store=None,
          init=None, health=None, obs=None, telemetry=None,
          device="cuda") -> SolveResult:
    """The epoch driver.

    ``source`` is a ``Problem`` (the grid is built here, laid out for the
    chosen backend) or a pre-built ``GridData`` / ``SparseGridData`` /
    ``BucketedGridData`` / ``TileData`` (which fixes the layout, so
    ``backend`` is a kernel choice, and needs ``loss_name``/``reg_name``/
    ``lam``/``m``/``d``).  ``device`` (default the card; ``RuntimeError``
    when there is none) must be where ``source`` lives.

    ``backend`` — canonical name, legacy impl selector, ``"auto"`` or a
    ``TileBackend``; ``schedule`` — "cyclic", "random" (drawn from a
    ``torch.Generator`` seeded with ``seed``), "lpt" or a ``Schedule``;
    ``eval_hook`` — ``hook(t, w, alpha) -> dict`` appended to the history
    every ``eval_every`` epochs ("auto": Problem objectives for a Problem
    source, none for grid sources).

    ``store``, ``init``, ``health``, ``obs`` and ``telemetry`` keep the
    reference's signature; any of them not ``None`` raises
    ``NotImplementedError`` naming the slice that brings it.
    """
    for name, val in (("store", store), ("init", init), ("health", health),
                      ("obs", obs), ("telemetry", telemetry)):
        if val is not None:
            raise NotImplementedError(
                f"solve({name}=...) is not ported yet; it comes with "
                f"{_LATER[name]}")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    dev = resolve_device(device)
    sched = get_schedule(schedule)
    if isinstance(source, Problem):
        given = [k for k, v in (("loss_name", loss_name),
                                ("reg_name", reg_name), ("lam", lam),
                                ("m", m), ("d", d)) if v is not None]
        if given:
            raise ValueError(
                f"{given} conflict with the Problem source (its own "
                f"loss/reg/lam/shape are used); either drop them or pass "
                f"pre-built grid data instead of the Problem")
        if source.device != dev:
            raise ValueError(f"the Problem lives on {source.device}, "
                             f"device={str(dev)!r} was asked for")
        prob = source
        be, data = resolve_backend_and_build(prob, backend, p, row_batches)
        loss_name, reg_name = prob.loss_name, prob.reg_name
        m, d = prob.m, prob.d
        lam_f, m_f, _, _, _, w_lo, w_hi = prob_meta(prob)
        if eval_hook == "auto":
            eval_hook = problem_eval_hook(prob)
    else:
        data = source
        missing = [k for k, v in (("loss_name", loss_name),
                                  ("reg_name", reg_name), ("lam", lam),
                                  ("m", m), ("d", d)) if v is None]
        if missing:
            raise ValueError(f"solving from pre-built grid data requires "
                             f"{missing} (no Problem to read them from)")
        if data.yg.device != dev:
            raise ValueError(f"the grid lives on {data.yg.device}, "
                             f"device={str(dev)!r} was asked for")
        be = resolve_backend_for_layout(backend, as_tile_data(data).layout,
                                        device_type=dev.type)
        lam_f, m_f = float(np.float32(lam)), float(np.float32(m))
        w_lo, w_hi = w_bounds(loss_name, lam)
        if eval_hook == "auto":
            eval_hook = None
    check_tile_stats(data, row_batches)
    tile = as_tile_data(data)
    p_, _, _ = tile_dims(tile)
    kw = dict(backend=be, loss_name=loss_name, reg_name=reg_name,
              use_adagrad=use_adagrad, row_batches=row_batches)
    chunk = eval_every if eval_hook is not None else epochs
    sched_ctx = ({"tile_nnz": tile.tile_row_nnz_g.sum(-1).cpu().numpy()}
                 if sched.balanced else {})
    state = init_state_data(loss_name, data, alpha0)
    key = torch.Generator().manual_seed(int(seed))
    t, history = 0, []
    while t < epochs:
        stops = [epochs]
        if eval_hook is not None:
            stops.append(_next_multiple(t, chunk))
        n = min(stops) - t
        key, perms = sched.draw(key, t, n, p_, **sched_ctx)
        etas = eta_schedule(eta0, t, n, use_adagrad)
        state = run_epochs(tile, state, perms, etas, lam_f, m_f, w_lo, w_hi,
                           **kw)
        t += n
        if eval_hook is not None and (t % chunk == 0 or t == epochs):
            history.append(eval_hook(t, gather_w(state, d),
                                     gather_alpha(state, m)))
    return SolveResult(gather_w(state, d), gather_alpha(state, m), history,
                       state)
