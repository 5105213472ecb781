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

``solve``'s seams, all duck-typed (the engine imports neither
``repro_torch.runtime`` nor ``repro_torch.obs``): ``checkpoint_every`` /
``store`` / ``init`` (snapshots and resume), ``health`` (the finite probe,
rollback with eta backoff, degradation to ``solve_serial``), ``obs`` (spans
and gauges; ``None`` is a true no-op) and ``telemetry`` (the device-side
lane, ``run_epochs_telemetry``; ``None`` leaves ``run_epochs`` as it is).
"""

from __future__ import annotations

import time
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
                                     make_grid_data, prob_meta,
                                     state_from_arrays, tile_dims)
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


# ------------------------------------------------------ telemetry lane --
#
# Kept literally in sync with repro_torch.obs.telemetry.TELEMETRY_FIELDS:
# the engine never imports repro_torch.obs (the telemetry= seam is
# duck-typed like obs=/store=), so the buffer layout is defined on both
# sides and a test pins the tuples equal (and equal to the reference's).

TELEMETRY_FIELDS = ("dw_norm", "dalpha_norm", "rows", "nnz", "nonfinite")


def telemetry_row(w_old, w_new, a_old, a_new, gw_new, ga_new, trn_blk):
    """The ``TELEMETRY_FIELDS`` of one inner iteration, one row per
    processor (leading axis; the last axis is the block / shard):
    ``trn_blk`` is each active tile's per-row nnz (``tile_row_nnz_g[q,
    blk_q]``), so rows/nnz count the tile's real work, not its padded
    shape.  Reads before/after values only; never feeds the trajectory."""
    dw = torch.sqrt(torch.sum(torch.square(w_new - w_old), dim=-1))
    da = torch.sqrt(torch.sum(torch.square(a_new - a_old), dim=-1))
    rows = torch.sum((trn_blk > 0).to(torch.float32), dim=-1)
    nnz = torch.sum(trn_blk, dim=-1)
    finite = (torch.isfinite(w_new).all(-1) & torch.isfinite(a_new).all(-1)
              & torch.isfinite(gw_new).all(-1)
              & torch.isfinite(ga_new).all(-1))
    return torch.stack([dw, da, rows, nnz,
                        1.0 - finite.to(torch.float32)], dim=-1)


def epoch_body(backend: TileBackend, data, state: DSOState, perm, eta_t,
               meta, *, row_batches: int, p: int, telemetry: bool = False):
    """One epoch under a ``(p, p)`` permutation schedule, ``perm[r, q]`` =
    block of processor q at inner iteration r.

    ``telemetry=True`` also fills the per-(r, q) ``TELEMETRY_FIELDS``
    buffer (p, p, F) on the grid's device and returns ``(state, buf)``.
    The steps are in place, so it copies the active w blocks and alpha
    before each inner iteration; the update itself is the same."""
    if not telemetry:
        for r in range(p):
            inner_iteration(backend, meta, data, state, perm[r], eta_t,
                            row_batches)
        return state._replace(epoch=state.epoch + 1)
    buf = torch.empty((p, p, len(TELEMETRY_FIELDS)), dtype=torch.float32,
                      device=data.yg.device)
    qs = torch.arange(p, device=data.yg.device)
    for r in range(p):
        b = perm[r].long()
        w_old, a_old = state.w_grid[b], state.alpha.clone()
        inner_iteration(backend, meta, data, state, perm[r], eta_t,
                        row_batches)
        buf[r] = telemetry_row(w_old, state.w_grid[b], a_old, state.alpha,
                               state.gw_grid[b], state.ga,
                               data.tile_row_nnz_g[qs, b])
    return state._replace(epoch=state.epoch + 1), buf


def _chunk(data, perms, backend):
    """(backend, tile data in its payload, p, perms on the grid's device)
    of a chunk of epochs."""
    be = get_backend(backend)
    tile = as_tile_data(data, bucketed_payload=be.payload)
    perms = torch.as_tensor(perms).to(device=tile.yg.device,
                                      dtype=torch.int32)
    return be, tile, tile.yg.shape[0], perms


def run_epochs(data, state: DSOState, perms, etas, lam: float, m: float,
               w_lo: float, w_hi: float, *, backend, loss_name: str,
               reg_name: str, use_adagrad: bool = True,
               row_batches: int = 1) -> DSOState:
    """``len(etas)`` epochs; ``perms`` (n_epochs, p, p).  Updates the state
    tensors in place (the reference donates them) and returns the state
    with its epoch count advanced."""
    meta = (lam, m, loss_name, reg_name, use_adagrad, w_lo, w_hi)
    be, tile, p, perms = _chunk(data, perms, backend)
    for k, eta_t in enumerate(etas):
        state = epoch_body(be, tile, state, perms[k], float(eta_t), meta,
                           row_batches=row_batches, p=p)
    return state


def run_epochs_telemetry(data, state: DSOState, perms, etas, lam: float,
                         m: float, w_lo: float, w_hi: float, *, backend,
                         loss_name: str, reg_name: str,
                         use_adagrad: bool = True, row_batches: int = 1):
    """``run_epochs`` with the telemetry lane: the same steps, plus the
    per-(epoch, r, q) ``TELEMETRY_FIELDS`` buffer (n_epochs, p, p, F) on
    the grid's device, returned as ``(state, buf)`` for the caller to
    drain.  A sibling of ``run_epochs`` (not a flag on it), so a run
    without telemetry makes no copy and no extra launch."""
    meta = (lam, m, loss_name, reg_name, use_adagrad, w_lo, w_hi)
    be, tile, p, perms = _chunk(data, perms, backend)
    bufs = []
    for k, eta_t in enumerate(etas):
        state, buf = epoch_body(be, tile, state, perms[k], float(eta_t),
                                meta, row_batches=row_batches, p=p,
                                telemetry=True)
        bufs.append(buf)
    return state, torch.stack(bufs)


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


def _sync(dev: torch.device):
    """Wait for the device's queued work (a span then times completed
    epochs, not their launches)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------- observability (obs=) --
#
# The obs seam is duck-typed like store=/health=: the engine never imports
# repro_torch.obs.  Everything below runs ONLY under ``if obs is not
# None``: with obs None the chunk loop does no obs work and allocates
# nothing for it (the metrics-off contract).


def _obs_throughput(obs, *, rows: float, nnz: float, payload_bytes: float):
    """Bind the static per-epoch work totals once per run; returns the
    per-chunk callback recording the throughput gauges."""
    g_rows = obs.metrics.gauge("rows_per_s")
    g_nnz = obs.metrics.gauge("nnz_per_s")
    g_bytes = obs.metrics.gauge("packed_bytes_per_s")
    g_eta = obs.metrics.gauge("eta")
    h_epoch = obs.metrics.histogram("epoch_s")

    def record(n: int, dt: float, eta: float):
        dt = max(dt, 1e-12)
        g_rows.set(rows * n / dt)
        g_nnz.set(nnz * n / dt)
        g_bytes.set(payload_bytes * n / dt)
        g_eta.set(eta)
        h_epoch.observe(dt / n)

    return record


def _obs_eval(obs, entry):
    """Record every numeric field of an evaluation-history entry as an
    ``eval.<key>`` gauge; non-dict entries (custom hooks) are left alone."""
    if not isinstance(entry, dict):
        return
    for k, v in entry.items():
        if k != "epoch" and isinstance(v, (int, float)):
            obs.metrics.gauge(f"eval.{k}").set(v)


# ------------------------------------------------ snapshots (init=, ...) --


def _state_copy(state, dev: torch.device) -> DSOState:
    """A fresh copy of a snapshot's state on ``dev``, through
    ``state_from_arrays``: the run updates its state in place, and the
    caller's snapshot must come through it unchanged."""
    return state_from_arrays(
        {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v
         for k, v in state._asdict().items()}, device=dev)


def _outside_box(state, w_lo: float, w_hi: float) -> bool:
    """Whether any w of a state entering the run lies outside its box:
    one reduction on the device (``TileBackend.clamp_step``)."""
    w = state.w_grid
    return bool(((w < w_lo) | (w > w_hi)).any())


def _schedule_key(key, sched) -> torch.Generator:
    """The schedule's ``torch.Generator`` from a snapshot's key: a
    Generator, or the uint8 state ``get_state()`` gives (as the port's
    snapshots store it).  Another kind of key (the JAX package's uint32[2]
    ``jax.random`` key) serves only schedules that draw nothing from it;
    ``random`` refuses it."""
    gen = torch.Generator()
    if isinstance(key, torch.Generator):
        gen.set_state(key.get_state())
        return gen
    arr = (key.detach().cpu().numpy() if isinstance(key, torch.Tensor)
           else np.asarray(key))
    if arr.dtype == np.uint8 and arr.ndim == 1:
        gen.set_state(torch.from_numpy(arr.copy()))
        return gen
    if sched.name == "random":
        raise ValueError(
            f"the snapshot's schedule key is a {arr.dtype}{list(arr.shape)} "
            f"array, not a torch.Generator state (uint8): the 'random' "
            f"schedule cannot continue its stream from it (a uint32[2] key "
            f"is a jax.random key, from a snapshot of the JAX package)")
    return gen


def solve(source, *, backend="auto", schedule="cyclic", p: int = 4,
          epochs: int = 10, eta0: float = 0.1, use_adagrad: bool = True,
          row_batches: int = 1, alpha0: float = 0.0, eval_every: int = 1,
          seed: int = 0, eval_hook="auto", scan_epochs: bool = True,
          loss_name: str | None = None, reg_name: str | None = None,
          lam: float | None = None, m: int | None = None,
          d: int | None = None, checkpoint_every: int = 0, store=None,
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
    source, none for grid sources).  ``scan_epochs=False`` runs each
    epoch of a chunk as its own ``run_epoch`` call (the reference's
    one-dispatch-per-epoch baseline); the math is the same.

    Elastic-runtime seam (``repro_torch.runtime``, duck-typed):
    ``checkpoint_every=k`` adds chunk boundaries at every k-th epoch, and
    ``store`` (e.g. ``SnapshotStore``) receives ``store.save(state=, key=,
    epochs_done=, history=, config=)`` at each of them and ``flush()`` at
    the end; the state is live, so the store copies it before returning.
    ``init`` (a ``DSOSnapshot``) resumes from a snapshot: its state is
    copied onto ``device`` (the snapshot survives the run), its key
    seeds the schedule's generator and its cursor the step sizes.  A
    state entering so (or by a rollback) with any w outside its box runs
    its first epoch, as a chunk of its own, through the backend's
    ``clamp_step`` (every column stepped, so clamped, as the plain step
    does), found by one reduction on the device.

    Health seam (``repro_torch.runtime.health``): ``health`` (e.g.
    ``HealthGuard``) is called at every chunk boundary —
    ``health.inject(state, t)`` before the chunk, ``check_state`` (before
    the evaluation, so a poisoned state is never evaluated or saved) and
    ``check_history`` after it.  A failed check rolls back to the latest
    valid snapshot of ``store`` (else ``init``, else a fresh start), backs
    ``eta0`` off by ``health.eta_decay`` and retries; past
    ``health.max_retries`` rollbacks ``health.exhausted`` raises or asks
    for the paper-exact ``solve_serial`` (Problem sources only).

    Observability seam (``repro_torch.obs``): ``obs`` (e.g.
    ``RunRecorder``) receives a ``meta`` event, per chunk a
    ``span("epoch_chunk")`` (the device synchronised inside it) with the
    rows/s, nnz/s, packed bytes/s and eta gauges and the ``epoch_s``
    histogram; ``span("eval")``, ``span("snapshot_save")`` and
    ``span("restore")`` around those steps; every evaluation field as an
    ``eval.<key>`` gauge; and the health guard's ledger (when the guard
    has no recorder of its own).  ``obs=None`` is a true no-op.

    Telemetry seam (``repro_torch.obs.telemetry``): ``telemetry`` (e.g.
    ``TelemetrySpec``) runs each chunk through ``run_epochs_telemetry``
    and receives its buffer through ``telemetry.drain(buf, t0=, etas=,
    perms=, db=, transport=, wall_s=)`` at every chunk boundary
    ("ring" for the cyclic schedule, "p2p" otherwise).  The trajectory
    is the same as without it; needs ``scan_epochs=True``.
    """
    if eval_every < 1:
        raise ValueError(f"eval_every must be >= 1, got {eval_every}")
    if telemetry is not None and not scan_epochs:
        raise ValueError("telemetry requires scan_epochs=True (the lane "
                         "rides the chunk's run_epochs call)")
    if checkpoint_every < 0:
        raise ValueError(
            f"checkpoint_every must be >= 0, got {checkpoint_every}")
    if store is not None and checkpoint_every < 1:
        raise ValueError("a snapshot store needs checkpoint_every >= 1 to "
                         "know its boundaries")
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
    tile = as_tile_data(data, bucketed_payload=be.payload)
    p_, mb_, db = tile_dims(tile)
    kw = dict(backend=be, loss_name=loss_name, reg_name=reg_name,
              use_adagrad=use_adagrad, row_batches=row_batches)
    chunk = eval_every if eval_hook is not None else epochs
    if scan_epochs:
        warn_ragged_eval(epochs, chunk)
    sched_ctx = ({"tile_nnz": tile.tile_row_nnz_g.sum(-1).cpu().numpy()}
                 if sched.balanced else {})
    # the complete run record a snapshot carries (runtime.resume rebuilds
    # the call from it; runtime.reshard rewrites p/mb/db)
    cfg = dict(backend=be.name, schedule=sched.name, p=p_, mb=mb_, db=db,
               m=int(m), d=int(d), loss_name=loss_name, reg_name=reg_name,
               lam=float(lam_f), row_batches=row_batches, eta0=float(eta0),
               use_adagrad=bool(use_adagrad), alpha0=float(alpha0),
               seed=int(seed), eval_every=int(eval_every),
               checkpoint_every=int(checkpoint_every), layout=be.layout,
               inner_iteration=0)
    if health is not None:   # the backoff rides in every snapshot too
        cfg.update(eta_decay=float(health.eta_decay),
                   max_retries=int(health.max_retries))
    if init is not None:
        got = tuple(init.state.w_grid.shape)
        if got != (p_, db):
            raise ValueError(
                f"snapshot state has w grid {got}, this run's grid is "
                f"({p_}, {db}) — resuming across a different p needs "
                f"repro_torch.runtime.reshard first")
        state = _state_copy(init.state, dev)
        key = _schedule_key(init.key, sched)
        t = int(init.epochs_done)
        history = list(init.history)
        outside = _outside_box(state, w_lo, w_hi)
    else:
        outside = False
        state = init_state_data(loss_name, data, alpha0)
        key = torch.Generator().manual_seed(int(seed))
        t, history = 0, []
    eta_live = float(eta0)   # backed off per rollback under a health guard
    if obs is not None:
        # static per-epoch work totals: every epoch touches every nonzero
        # once and streams the layout payload once
        obs.record(type="meta", phase="solve", epochs=int(epochs), **cfg)
        record_chunk = _obs_throughput(
            obs, rows=float(m),
            nnz=float((tile.row_nnz_g * tile.row_valid).sum()),
            payload_bytes=float(sum(a.nbytes for a in tile.arrays)))
        if health is not None and getattr(health, "obs", None) is None:
            health.obs = obs   # ledger events join the same stream
    while t < epochs:
        if health is not None:
            state = health.inject(state, t)
        stops = [epochs]
        if eval_hook is not None:
            stops.append(_next_multiple(t, chunk))
        if checkpoint_every:
            stops.append(_next_multiple(t, checkpoint_every))
        run = kw
        if outside and be.clamp_step is not None:
            # the entering state's first epoch steps every column
            stops.append(t + 1)
            run = dict(kw, backend=be._replace(block_step=be.clamp_step))
        outside = False
        n = min(stops) - t
        key, perms = sched.draw(key, t, n, p_, **sched_ctx)
        etas = eta_schedule(eta_live, t, n, use_adagrad)
        # manual enter/exit (not contextlib) so the obs-off loop body
        # allocates nothing
        span = obs.span("epoch_chunk", t0=t, epochs=n) \
            if obs is not None else None
        if span is not None:
            span.__enter__()
            t_chunk = time.perf_counter()
        if telemetry is not None:
            t_tel = time.perf_counter()
            state, tbuf = run_epochs_telemetry(tile, state, perms, etas,
                                               lam_f, m_f, w_lo, w_hi, **run)
        elif scan_epochs:
            state = run_epochs(tile, state, perms, etas, lam_f, m_f, w_lo,
                               w_hi, **run)
        else:
            for k in range(n):
                state = run_epoch(tile, state, perms[k], etas[k], lam_f,
                                  m_f, w_lo, w_hi, **run)
        if span is not None:
            _sync(dev)
            record_chunk(n, time.perf_counter() - t_chunk, eta_live)
            span.__exit__(None, None, None)
        if telemetry is not None:
            # drained outside the span: the copy to the host is obs work
            _sync(dev)
            telemetry.drain(tbuf, t0=t, etas=etas, perms=perms, db=db,
                            transport="ring" if sched.ring else "p2p",
                            wall_s=time.perf_counter() - t_tel)
        t_new = t + n
        failure = None
        if health is not None:
            # the state first: a poisoned iterate must never reach the
            # evaluation hook or the store
            failure = health.check_state(state)
        if failure is None and eval_hook is not None and (
                t_new % chunk == 0 or t_new == epochs):
            span = obs.span("eval", epoch=t_new) if obs is not None else None
            if span is not None:
                span.__enter__()
            entry = eval_hook(t_new, gather_w(state, d),
                              gather_alpha(state, m))
            history.append(entry)
            if span is not None:
                _obs_eval(obs, entry)
                span.__exit__(None, None, None)
            if health is not None:
                failure = health.check_history(history)
        if failure is not None:
            health.retries += 1
            if health.retries > health.max_retries:
                if health.exhausted(failure=failure, epoch=t_new,
                                    eta0=eta_live,
                                    can_degrade=isinstance(source, Problem)
                                    ) == "serial":
                    return solve_serial(source, epochs=epochs,
                                        eta0=eta_live, seed=seed,
                                        use_adagrad=use_adagrad,
                                        alpha0=alpha0,
                                        eval_every=eval_every, obs=obs,
                                        device=dev)
            span = obs.span("restore", epoch=t_new, failure=failure) \
                if obs is not None else None
            if span is not None:
                span.__enter__()
            snap = None
            if store is not None:
                try:
                    snap = store.load()   # latest-VALID-wins
                except FileNotFoundError:
                    snap = None
            if snap is None:
                snap = init               # may still be None: fresh start
            eta_live *= health.eta_decay
            cfg["eta0"] = eta_live
            if snap is not None:
                state = _state_copy(snap.state, dev)
                key = _schedule_key(snap.key, sched)
                resumed = int(snap.epochs_done)
                history = list(snap.history)
                outside = _outside_box(state, w_lo, w_hi)
            else:
                state = init_state_data(loss_name, data, alpha0)
                key = torch.Generator().manual_seed(int(seed))
                resumed, history = 0, []
            health.note(kind="health", epoch=t_new, action="rollback",
                        epochs_lost=t_new - resumed, retry=health.retries,
                        failure=failure, resumed_from=resumed,
                        eta0=eta_live)
            if span is not None:
                span.__exit__(None, None, None)
            t = resumed
            continue
        t = t_new
        if store is not None and (t % checkpoint_every == 0 or t == epochs):
            span = obs.span("snapshot_save", epoch=t) \
                if obs is not None else None
            if span is not None:
                span.__enter__()
            store.save(state=state, key=key, epochs_done=t,
                       history=list(history), config=cfg)
            if span is not None:
                span.__exit__(None, None, None)
    if store is not None and hasattr(store, "flush"):
        # an async store's writes overlap the chunks; drain them (and
        # surface any failure) before the run counts as durable
        store.flush()
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
    there an epoch is one launch of the serial kernel.  ``obs`` is
    ``solve``'s seam: a meta event, chunk spans, the throughput gauges and
    the evaluation gauges; ``None`` is a true no-op."""
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
    if obs is not None:
        obs.record(type="meta", phase="solve_serial", epochs=int(epochs),
                   m=prob.m, d=prob.d, nnz=int(nnz), eta0=float(eta0),
                   loss_name=prob.loss_name, reg_name=prob.reg_name,
                   seed=int(seed))
        record_chunk = _obs_throughput(obs, rows=float(prob.m),
                                       nnz=float(nnz),
                                       payload_bytes=float(12 * nnz))
    while t < epochs:
        n = min(eval_every, epochs - t)
        orders = _draw_orders(key, n, nnz)
        span = obs.span("epoch_chunk", t0=t, epochs=n) \
            if obs is not None else None
        if span is not None:
            span.__enter__()
            t_chunk = time.perf_counter()
        _serial_epochs(ii, jj, vv, orders,
                       eta_schedule(eta0, t, n, use_adagrad), w, alpha,
                       gw, ga, prob.y, prob.row_nnz, prob.col_nnz, lam_f,
                       w_lo, w_hi, loss_name=prob.loss_name,
                       reg_name=prob.reg_name, m=float(prob.m),
                       use_adagrad=use_adagrad)
        if span is not None:
            _sync(dev)
            record_chunk(n, time.perf_counter() - t_chunk, eta0)
            span.__exit__(None, None, None)
        t += n
        if hook is not None:
            entry = hook(t, w, alpha)
            history.append(entry)
            if obs is not None:
                _obs_eval(obs, entry)
    return SolveResult(w, alpha, history, None)
