"""Driver layer: the epoch loop behind ``solve``.

``run_epochs`` runs a chunk of epochs, each ``epoch_body``: p inner
iterations, each ONE batched block step of all p processors on their
disjoint active blocks (the reference vmaps ``inner_iteration`` over the
processors inside a donated ``lax.scan``; the port batches the processors
inside each backend and updates the ``DSOState`` tensors in place).
``solve`` wraps it in the evaluation-chunk loop (``scan_epochs=False``
runs each epoch through ``run_epoch`` instead: the same math), and
``solve_serial`` drives the paper-exact pointwise epochs (Algorithm 1 at
p = 1) through the same loop, one ``ops.dso_serial_epoch`` per epoch.

With a block-step kernel backend (``sparse_pallas``,
``sparse_bucketed_pallas``, ``dense_pallas_block``) one inner iteration is
``2 * row_batches`` kernel launches (a dual/scatter launch and a primal
launch per row tile, every processor in each), so one epoch is
``2 * p * row_batches`` launches; ``dense_pallas_fused`` launches per
processor, ``2 * p * p * row_batches``.
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple

import numpy as np
import torch

from repro_torch.core.losses import w_bounds
from repro_torch.core.saddle import Problem, project_alpha
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
from repro_torch.kernels import ops
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


def run_epoch(data, state: DSOState, perm, eta_t: float, lam: float,
              m: float, w_lo: float, w_hi: float, *, backend,
              loss_name: str, reg_name: str, use_adagrad: bool = True,
              row_batches: int = 1) -> DSOState:
    """One epoch under the ``(p, p)`` permutation schedule ``perm``: the
    legacy one-epoch-per-call path (``run_epochs`` with one epoch)."""
    return run_epochs(data, state, torch.as_tensor(perm)[None], [eta_t],
                      lam, m, w_lo, w_hi, backend=backend,
                      loss_name=loss_name, reg_name=reg_name,
                      use_adagrad=use_adagrad, row_batches=row_batches)


_RAGGED_WARNED: set = set()


def warn_ragged_eval(epochs: int, eval_every: int, *, stacklevel: int = 3):
    """Warn (once per (epochs, eval_every) shape) when the evaluation
    chunking leaves a ragged final chunk, whose evaluation falls off the
    ``eval_every`` grid (the reference warns for the same shapes: there
    each distinct chunk length traces its epoch scan once more).  Suggests
    the largest chunk that divides ``epochs``."""
    if eval_every <= 0 or eval_every >= epochs or epochs % eval_every == 0:
        return
    key = (epochs, eval_every)
    if key in _RAGGED_WARNED:
        return
    _RAGGED_WARNED.add(key)
    div = next(k for k in range(min(eval_every, epochs), 0, -1)
               if epochs % k == 0)
    warnings.warn(
        f"epochs={epochs} is not a multiple of eval_every={eval_every}: the "
        f"ragged final chunk of {epochs % eval_every} epoch(s) is evaluated "
        f"off the eval_every grid; prefer a chunking that divides epochs "
        f"(e.g. eval_every={div})", RuntimeWarning, stacklevel=stacklevel)


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
          seed: int = 0, eval_hook="auto", scan_epochs: bool = True,
          loss_name: str | None = None, reg_name: str | None = None,
          lam: float | None = None, m: int | None = None,
          d: int | None = None, store=None, init=None, health=None,
          obs=None, telemetry=None, device="cuda") -> SolveResult:
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
    source, none for grid sources).  ``scan_epochs=False`` runs each
    epoch of a chunk as its own ``run_epoch`` call (the reference's
    one-dispatch-per-epoch baseline); the math is the same.

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
    if scan_epochs:
        warn_ragged_eval(epochs, chunk)
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
        if scan_epochs:
            state = run_epochs(tile, state, perms, etas, lam_f, m_f, w_lo,
                               w_hi, **kw)
        else:
            for k in range(n):
                state = run_epoch(tile, state, perms[k], etas[k], lam_f,
                                  m_f, w_lo, w_hi, **kw)
        t += n
        if eval_hook is not None and (t % chunk == 0 or t == epochs):
            history.append(eval_hook(t, gather_w(state, d),
                                     gather_alpha(state, m)))
    return SolveResult(gather_w(state, d), gather_alpha(state, m), history,
                       state)


# ------------------------------------------- paper-exact serial driver --


def _coords(prob: Problem):
    """(ii, jj, vv) of the Problem's nonzeros in row-major order, on its
    device: int32, int32, float32."""
    ii, jj = torch.nonzero(prob.X, as_tuple=True)
    return (ii.to(torch.int32), jj.to(torch.int32),
            prob.X[ii, jj].to(torch.float32))


def _serial_epochs(ii, jj, vv, perms, etas, w, alpha, gw, ga, y, row_nnz,
                   col_nnz, lam, w_lo, w_hi, *, loss_name, reg_name, m,
                   use_adagrad):
    """``len(etas)`` paper-exact pointwise epochs, one
    ``ops.dso_serial_epoch`` each (one kernel launch on the card), in
    place on (w, alpha, gw, ga), which it returns.  ``perms``: (n_epochs,
    nnz) visit order per epoch, a tensor or a numpy integer array (so a
    caller can replay another generator's orders)."""
    perms = torch.as_tensor(perms).to(device=w.device, dtype=torch.int32)
    for k, eta_t in enumerate(etas):
        ops.dso_serial_epoch(
            ii, jj, vv, perms[k].contiguous(), w, alpha, gw, ga, y, row_nnz,
            col_nnz, (float(eta_t), lam, m, w_lo, w_hi),
            loss_name=loss_name, reg_name=reg_name, use_adagrad=use_adagrad)
    return w, alpha, gw, ga


def _draw_orders(key: torch.Generator, n: int, nnz: int) -> torch.Tensor:
    """The visit orders of the next ``n`` serial epochs, (n, nnz) int64 on
    the host: one ``torch.randperm`` of the generator ``key`` per epoch,
    so chunking does not change the stream."""
    return torch.stack([torch.randperm(nnz, generator=key)
                        for _ in range(n)])


def solve_serial(prob: Problem, epochs: int = 10, eta0: float = 0.1,
                 seed: int = 0, use_adagrad: bool = True,
                 alpha0: float = 0.0, eval_every: int = 1,
                 eval_hook="auto", obs=None, *,
                 device="cuda") -> SolveResult:
    """Paper-exact Algorithm 1 with p=1 (sequential pointwise updates),
    driven through the engine's evaluation-chunk loop: ``eval_hook``
    (``"auto"``: the Problem objectives) after every chunk of at most
    ``eval_every`` epochs.

    Each epoch visits every nonzero once, in a fresh random order drawn
    by ``torch.randperm`` from a ``torch.Generator`` seeded with ``seed``
    (``_draw_orders``; the reference draws from ``jax.random``, so its
    orders differ, and the tests replay them through ``_serial_epochs``
    or in place of ``_draw_orders``).  ``device`` (default the card;
    ``RuntimeError`` when there is none) must be where ``prob`` lives;
    there an epoch is one launch of the serial kernel.
    ``obs`` keeps the reference's signature and raises
    ``NotImplementedError``."""
    if obs is not None:
        raise NotImplementedError(
            f"solve_serial(obs=...) is not ported yet; it comes with "
            f"{_LATER['obs']}")
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    dev = resolve_device(device)
    if prob.device != dev:
        raise ValueError(f"the Problem lives on {prob.device}, "
                         f"device={str(dev)!r} was asked for")
    ii, jj, vv = _coords(prob)
    nnz = ii.numel()
    w = torch.zeros(prob.d, dtype=torch.float32, device=dev)
    alpha = project_alpha(prob, torch.full((prob.m,), float(alpha0),
                                           dtype=torch.float32, device=dev))
    gw, ga = torch.zeros_like(w), torch.zeros_like(alpha)
    lam_f, _, _, _, _, w_lo, w_hi = prob_meta(prob)
    hook = problem_eval_hook(prob) if eval_hook == "auto" else eval_hook
    warn_ragged_eval(epochs, eval_every)
    key = torch.Generator().manual_seed(int(seed))
    history = []
    t = 0
    while t < epochs:
        n = min(eval_every, epochs - t)
        _serial_epochs(ii, jj, vv, _draw_orders(key, n, nnz),
                       eta_schedule(eta0, t, n, use_adagrad), w, alpha,
                       gw, ga, prob.y, prob.row_nnz, prob.col_nnz, lam_f, w_lo, w_hi, loss_name=prob.loss_name,
                       reg_name=prob.reg_name, m=float(prob.m),
                       use_adagrad=use_adagrad)
        t += n
        if hook is not None:
            history.append(hook(t, w, alpha))
    return SolveResult(w, alpha, history, None)
