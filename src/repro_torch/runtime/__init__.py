"""Elastic runtime of the port: checkpointed DSO state, deterministic
resume, p -> p' resharding and self-healing around ``engine.solve``.

      engine.solve(..., checkpoint_every=k, store=S, init=snap, health=guard)
        |  every k epochs the complete solver state (w, alpha, gw/ga, the
        |  schedule key, cursor, history, config) crosses the seam as one
        v  DSOSnapshot, copied to the host before save() returns
   snapshot.py   flat-npz pytree codec, byte-compatible with the
        |        reference's (per-leaf CRC32 + whole-file digest), and
        |        SnapshotStore: latest-VALID-wins, quarantine, keep_last /
        |        keep_every gc, async_writes with flush() as the barrier
        ├──> health.py   all_finite, objective_regression, HealthGuard
        |                (rollback with eta backoff, then raise or degrade
        |                to solve_serial), NaNInjector, WallClockMonitor,
        |                the typed LedgerEvent ledger
        ├──> resume.py   solve(..., init=snap) with the config replayed
        └──> reshard.py  regrid_direct / grid_to_csr re-tiling at p' and
                         reshard_state

   supervisor.py Supervisor: drives core.dso_dist.ShardedDSO (worker
                 processes on torch.distributed) through planned and
                 unplanned faults (crash, reshard, straggler, slow, nan,
                 corrupt) with the typed LedgerEvent ledger;
                 FaultEvent, make_fault_plan, periodic_crashes

The engine never imports this package: ``store=``, ``health=`` and
``init=`` are duck-typed.
"""

from repro_torch.runtime.health import (HealthError, HealthGuard,
                                        LedgerEvent, NaNInjector,
                                        WallClockMonitor, all_finite,
                                        ledger_counts, objective_regression,
                                        render_ledger, render_ledger_event)
from repro_torch.runtime.reshard import reshard, reshard_state, retile
from repro_torch.runtime.resume import check_resumable, resume, solve_kwargs
from repro_torch.runtime.supervisor import (FaultEvent, Supervisor,
                                            make_fault_plan,
                                            periodic_crashes)
from repro_torch.runtime.snapshot import (DSOSnapshot,
                                          SnapshotIntegrityError,
                                          SnapshotStore, flatten_pytree,
                                          load_pytree, load_snapshot,
                                          read_meta, save_pytree,
                                          save_snapshot, verify_pytree)

__all__ = [
    "DSOSnapshot", "SnapshotIntegrityError", "SnapshotStore",
    "flatten_pytree", "load_pytree", "load_snapshot", "read_meta",
    "save_pytree", "save_snapshot", "verify_pytree",
    "HealthError", "HealthGuard", "LedgerEvent", "NaNInjector",
    "WallClockMonitor", "all_finite", "ledger_counts",
    "objective_regression", "render_ledger", "render_ledger_event",
    "check_resumable", "resume", "solve_kwargs",
    "reshard", "reshard_state", "retile",
    "FaultEvent", "Supervisor", "make_fault_plan", "periodic_crashes",
]
