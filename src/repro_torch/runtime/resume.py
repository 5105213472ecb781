"""Deterministic resume: continue an interrupted ``solve`` from a snapshot.

A ``DSOSnapshot`` records everything the epoch driver threads between
chunks (the state, the schedule key, the epoch cursor, the evaluation
history and the solver config), so ``resume`` is ``engine.solve`` called
with ``init=snapshot`` and the original configuration replayed from
``snapshot.config``.  The resumed trajectory equals the uninterrupted one
because ``schedules.draw`` is chunk-invariant and a chunk boundary only
splits the same per-epoch steps; on the CPU (the plain twins) that is bit
for bit (max |delta| = 0.0), on the card to the atomics' reordering of
float sums (the port's 1e-5 gate).  The resume point is the store's
latest *valid* snapshot.  Resuming at another p is a reshard
(``runtime.reshard``), which ``solve`` asks for by name.

``device`` is ``solve``'s: the card unless the caller passes
``device="cpu"`` among the overrides.
"""

from __future__ import annotations

from repro_torch.core.saddle import Problem
from repro_torch.engine.driver import solve
from repro_torch.runtime.snapshot import DSOSnapshot, SnapshotStore

#: config keys replayed into solve() on resume (the rest of the config is
#: informational: the layout follows the backend, mb/db the grid)
_REPLAY = ("backend", "schedule", "p", "eta0", "use_adagrad",
           "row_batches", "alpha0", "eval_every", "seed",
           "checkpoint_every")
_DATA_REPLAY = ("loss_name", "reg_name", "lam", "m", "d")


def solve_kwargs(snap: DSOSnapshot, *, for_problem: bool) -> dict:
    """The ``solve`` call recorded in a snapshot's config;
    ``for_problem=True`` drops the loss/reg/lam/shape keys (a ``Problem``
    carries its own and ``solve`` refuses duplicates)."""
    cfg = snap.config
    kw = {k: cfg[k] for k in _REPLAY}
    if not for_problem:
        kw.update({k: cfg[k] for k in _DATA_REPLAY})
    return kw


def check_resumable(snap: DSOSnapshot, source) -> None:
    """Refuse a ``source`` of another shape than the snapshot's problem,
    and a snapshot whose grid disagrees with its own config."""
    cfg = snap.config
    if isinstance(source, Problem):
        if (source.m, source.d) != (cfg["m"], cfg["d"]):
            raise ValueError(
                f"snapshot was taken on an ({cfg['m']}, {cfg['d']}) problem "
                f"but the source is ({source.m}, {source.d}) — resume "
                f"continues ONE run on ONE dataset")
    got = tuple(snap.state.w_grid.shape)
    want = (cfg["p"], cfg["db"])
    if got != want:
        raise ValueError(
            f"snapshot state grid {got} does not match its own config "
            f"{want} — corrupt snapshot, or state resharded without "
            f"updating config (use repro_torch.runtime.reshard.reshard)")


def resume(source, store, *, epochs: int, snapshot: DSOSnapshot | None = None,
           keep_checkpointing: bool = True, **overrides):
    """Continue an interrupted run from ``store`` up to ``epochs`` in all.

    ``source`` is the ``Problem`` or grid data of the original run;
    ``store`` a ``SnapshotStore`` (or its directory) whose latest valid
    snapshot is the resume point unless ``snapshot`` is given.
    ``overrides`` tweak the replayed call (``device=``, ``eval_hook=``,
    ...).  With ``keep_checkpointing`` the resumed run keeps writing into
    the same store on the original cadence.  Returns ``solve``'s
    ``SolveResult``, its history the snapshot's followed by the resumed
    run's."""
    if isinstance(store, str):
        store = SnapshotStore(store)
    snap = store.load() if snapshot is None else snapshot
    check_resumable(snap, source)
    kw = solve_kwargs(snap, for_problem=isinstance(source, Problem))
    if not keep_checkpointing:
        kw["checkpoint_every"] = 0
    kw.update(overrides)
    ckpt = kw.get("checkpoint_every", 0)
    return solve(source, epochs=epochs, init=snap,
                 store=store if (keep_checkpointing and ckpt) else None,
                 **kw)
