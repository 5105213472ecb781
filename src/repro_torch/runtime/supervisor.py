"""Supervision: drive ``ShardedDSO`` under faults — planned and not.

The port of the reference's ``runtime/supervisor.py`` over the port's
``ShardedDSO`` (worker processes on ``torch.distributed``).  A rebuild on
p' workers draws its mesh from the current mesh's pool
(``DSOMesh.resized``), so a live reshard starts no process the pool does
not already have; the schedule key is the port's ``torch.Generator``.

The supervisor is the process that owns the run, not the math: it chunks
``run_epochs`` between checkpoint boundaries and planned fault epochs,
snapshots the complete solver state every ``checkpoint_every`` epochs into
a ``SnapshotStore``, and reacts to faults:

  crash      — the device state is considered lost: the solver is restored
               from the latest *valid* on-disk snapshot (key + cursor +
               blocked state) and re-runs the lost epochs.  Because the
               schedule stream is a function of (stored key, cursor), the
               re-run is bit-identical and the final trajectory equals the
               uninterrupted one.
  reshard    — live p -> p' elasticity: snapshot at the boundary,
               ``reshard_state`` onto the p' grid, rebuild the solver on a
               p'-worker mesh, continue the SAME iterate (no epochs lost).
  straggler  — a slow worker, recorded (and optionally simulated with a
               one-shot wall-clock delay); the math is bulk-synchronous so
               only the epoch wall time changes.
  slow       — a PERSISTENT straggler: every subsequent chunk pays
               ``straggler_delay_s`` per epoch (simulation knob) until the
               wall-clock lane replans it away.
  nan        — chaos injection: one w block of the live state is poisoned
               with NaN; the numerical-health lane must catch it at the
               next chunk boundary.
  corrupt    — chaos injection: one byte of the latest on-disk snapshot is
               bit-flipped; the next restore must quarantine it and fall
               back to an older valid snapshot (latest-valid-wins).

Unplanned-fault lanes (always on, ``repro_torch.runtime.health``):

* numerical health — the all-finite probe runs on the solver state
  at every chunk boundary BEFORE the snapshot is written, so a poisoned
  iterate never reaches disk; optionally (``regression_ratio=``) the
  objective-regression monitor watches the recorded metrics, quarantining
  the suspect snapshot when it fires.  Recovery is restore-latest-valid
  with step-size backoff: a snapshot restored twice in a row without
  progress shrinks ``eta0`` by ``eta_decay`` (Adaptive SGD, arXiv
  1802.05811), and ``max_restores`` consecutive restores from the same
  snapshot raise a ``RuntimeError`` naming it — no more ping-ponging.

* wall clock (opt-in, ``replan=True``) — a ``WallClockMonitor`` EWMA over
  warm per-epoch chunk times (the first chunk of each length after a
  rebuild is excluded)
  detects persistent stragglers and escalates: first replan switches the
  schedule to "lpt" (rebuild on the same mesh, restore the same iterate —
  no epochs lost), and if imbalance persists the second replan live
  reshards to ``reshard_to`` (default p//2) workers, dropping the slow
  one.  The simulated-delay relief factors (``lpt_relief``, 0 after
  reshard) are simulation knobs standing in for a real cluster's response.

Every supervision decision is a typed ``LedgerEvent`` in ``self.log`` —
the structured recovery ledger ``run_sharded`` returns, so tests and the
chaos example assert on recovery *behavior* (detections, actions, epochs
lost, retries), not just the final iterate.

Fault plans are explicit ``FaultEvent`` tuples or drawn deterministically
from a seed (``make_fault_plan``), so every kill-restore-reshard scenario
replays exactly.  Auto-resume extends across process restarts AND cluster
resizes: a supervisor started over a non-empty store adopts the latest
valid snapshot, resharding it if the new mesh has a different p.
"""

from __future__ import annotations

import time
from collections import deque
from typing import NamedTuple

import numpy as np

from repro_torch.core.dso_dist import ShardedDSO
from repro_torch.engine.driver import _next_multiple, _obs_throughput
from repro_torch.runtime.health import (LedgerEvent, WallClockMonitor,
                                        all_finite, objective_regression)
from repro_torch.runtime.reshard import reshard_state
from repro_torch.runtime.snapshot import SnapshotStore


class FaultEvent(NamedTuple):
    """One planned fault, fired when the run reaches ``epoch``."""

    epoch: int
    kind: str            # see _KINDS
    arg: int | None = None   # reshard: p'; straggler/slow: worker; nan: blk

    def describe(self) -> str:
        extra = {"reshard": f" -> p'={self.arg}",
                 "straggler": f" worker {self.arg}",
                 "slow": f" worker {self.arg}",
                 "nan": f" block {self.arg}"}.get(self.kind, "")
        return f"{self.kind}@{self.epoch}{extra}"


_KINDS = ("crash", "reshard", "straggler", "slow", "nan", "corrupt")


def make_fault_plan(seed: int, epochs: int, *, crash_rate: float = 0.0,
                    straggler_rate: float = 0.0, p: int = 1,
                    reshard_at: dict | None = None) -> tuple:
    """Deterministic, seeded fault plan over ``epochs`` epochs.

    Each epoch boundary 1..epochs-1 independently draws a crash
    (``crash_rate``) and a straggler (``straggler_rate``, uniform worker in
    0..p-1); ``reshard_at`` maps epoch -> p' for planned resizes.  Same
    seed, same plan — the supervisor's whole point is replayable chaos.
    """
    rng = np.random.default_rng(seed)
    plan = []
    for e in range(1, epochs):
        if rng.random() < crash_rate:
            plan.append(FaultEvent(e, "crash"))
        if rng.random() < straggler_rate:
            plan.append(FaultEvent(e, "straggler", int(rng.integers(p))))
    for e, p_new in sorted((reshard_at or {}).items()):
        plan.append(FaultEvent(int(e), "reshard", int(p_new)))
    return tuple(sorted(plan))


def periodic_crashes(every: int, epochs: int) -> tuple:
    """The simplest plan: a crash every ``every`` epochs (the CI smoke's
    "2-epoch fault plan")."""
    return tuple(FaultEvent(e, "crash") for e in range(every, epochs, every))


class Supervisor:
    """Checkpointing, self-healing fault-tolerant driver around
    ``ShardedDSO``.

    ``store`` — a ``SnapshotStore`` (or directory path); every snapshot
    carries the full solver state + config (including the supervisor's
    eta0/cadence AND its eta_decay/max_restores recovery parameters), so a
    fresh Supervisor over the same store resumes where the last one
    stopped (even at a different p).  ``log`` is the recovery ledger
    (typed ``LedgerEvent``s); ``history`` the per-checkpoint metrics.
    """

    def __init__(self, store, *, checkpoint_every: int = 1, fault_plan=(),
                 eta0: float = 0.1, straggler_delay_s: float = 0.0,
                 record_metrics: bool = True, eta_decay: float = 0.5,
                 max_restores: int = 5, regression_ratio: float | None = None,
                 replan: bool = False, straggler_factor: float = 1.8,
                 straggler_patience: int = 1, lpt_relief: float = 0.5,
                 reshard_to: int | None = None, obs=None, telemetry=None):
        if checkpoint_every < 1:
            raise ValueError(
                f"checkpoint_every must be >= 1, got {checkpoint_every}")
        for ev in fault_plan:
            if ev.kind not in _KINDS:
                raise ValueError(f"unknown fault kind {ev.kind!r}: {_KINDS}")
        if not 0.0 < eta_decay <= 1.0:
            raise ValueError(f"eta_decay must be in (0, 1], got {eta_decay}")
        if max_restores < 1:
            raise ValueError(f"max_restores must be >= 1, got {max_restores}")
        self.store = SnapshotStore(store) if isinstance(store, str) else store
        self.checkpoint_every = checkpoint_every
        self.fault_plan = tuple(sorted(fault_plan))
        self.eta0 = eta0
        self.straggler_delay_s = straggler_delay_s
        self.record_metrics = record_metrics
        self.eta_decay = eta_decay
        self.max_restores = max_restores
        self.regression_ratio = regression_ratio
        self.replan = replan
        self.lpt_relief = lpt_relief
        self.reshard_to = reshard_to
        # observability seam (duck-typed obs.RunRecorder, or None): every
        # ledger event, snapshot/restore/reshard span, and per-chunk
        # throughput gauge lands in ONE ordered run-event stream
        self.obs = obs
        # device-telemetry seam (duck-typed obs.TelemetrySpec, or None):
        # threaded into every ShardedDSO built along the way — rebuilds
        # and reshards included — so the drained per-(epoch, r, q) stream
        # stays continuous across replans; simulated straggler sleeps are
        # attributed to the slow worker so wall-balance shows the fault
        self.telemetry = telemetry
        self.log: list = []
        self.history: list = []
        # recovery bookkeeping: which snapshot we last restored from and
        # how many times in a row without making progress past it
        self._last_restore: int | None = None
        self._restore_streak = 0
        # wall-clock lane state
        self._monitor = (WallClockMonitor(factor=straggler_factor,
                                          patience=straggler_patience)
                         if replan else None)
        self._warm: set = set()   # chunk lengths already run (warm)
        self._replan_stage = 0
        self._slow: int | None = None   # persistent-straggler worker id
        self._relief = 1.0              # simulated-delay relief factor

    # ------------------------------------------------------------ pieces --

    def _note(self, ev: LedgerEvent) -> LedgerEvent:
        """The ONE ledger append: every supervision decision lands in
        ``self.log`` and (when a recorder is attached) in the obs event
        stream, interleaved with the throughput samples around it."""
        self.log.append(ev)
        if self.obs is not None:
            self.obs.record_ledger(ev)
        return ev

    def _span(self, name: str, **attrs):
        """Manually driven obs span (None when obs is off) — the caller
        pairs ``__enter__``/``__exit__`` around the timed region."""
        if self.obs is None:
            return None
        span = self.obs.span(name, **attrs)
        span.__enter__()
        return span

    @staticmethod
    def _end(span) -> None:
        if span is not None:
            span.__exit__(None, None, None)

    def _save(self, opt: ShardedDSO) -> None:
        span = self._span("snapshot_save", epoch=int(opt.epochs_done))
        if self.record_metrics:
            self.history.append(opt.metrics())
        # the supervisor owns the step size, cadence, and recovery policy,
        # and the solver only learns eta0 at its first run_epochs — stamp
        # the real values so runtime.resume replays them even from the
        # epoch-0 anchor snapshot
        cfg = dict(opt.snapshot_config(), eta0=float(self.eta0),
                   checkpoint_every=int(self.checkpoint_every),
                   eta_decay=float(self.eta_decay),
                   max_restores=int(self.max_restores))
        self.store.save(state=opt.solver_state(), key=opt.key,
                        epochs_done=opt.epochs_done,
                        history=list(self.history), config=cfg)
        self._end(span)
        if (self._last_restore is not None
                and opt.epochs_done > self._last_restore):
            self._restore_streak = 0   # progress past the restore point

    def _flush_store(self) -> None:
        """Barrier for async-write stores before any read of the store:
        restore and reshard must never race a half-written latest.  The
        store's own read paths barrier too (``SnapshotStore._barrier``);
        this keeps the contract explicit at every supervisor read site and
        covers duck-typed stores that expose ``flush`` without auto-
        barriered reads."""
        flush = getattr(self.store, "flush", None)
        if flush is not None:
            flush()

    def _adopt(self, opt: ShardedDSO, snap) -> None:
        """Restore a snapshot into ``opt``, resharding if the grids differ
        (resume on a resized cluster)."""
        st = snap.state
        if tuple(st.w_grid.shape) != (opt.p, opt.db):
            self._note(LedgerEvent(
                kind="reshard_on_resume", epoch=int(snap.epochs_done),
                action="reshard_state",
                detail=dict(snapshot_p=int(st.w_grid.shape[0]),
                            mesh_p=opt.p)))
            span = self._span("reshard", epoch=int(snap.epochs_done),
                              p_from=int(st.w_grid.shape[0]), p_to=opt.p)
            st = reshard_state(st, opt.m, opt.d, opt.p)
            self._end(span)
        opt.restore(st, key=snap.key, epochs_done=snap.epochs_done)
        self.history = list(snap.history)

    def _recover(self, opt: ShardedDSO, *, kind: str,
                 failure: str | None = None) -> ShardedDSO:
        """Restore-latest-valid with streak-capped eta backoff — the one
        recovery path behind crashes AND failed health checks."""
        at = int(opt.epochs_done)
        span = self._span("restore", epoch=at, failure=failure or kind)
        self._flush_store()            # pending async writes land first
        try:
            snap = self.store.load()   # latest-VALID-wins, quarantines
        except FileNotFoundError as e:
            self._end(span)
            raise RuntimeError(
                f"cannot recover from {failure or kind} at epoch {at}: "
                f"no valid snapshot left in {self.store.directory}") from e
        ep = int(snap.epochs_done)
        self._restore_streak = (self._restore_streak + 1
                                if ep == self._last_restore else 1)
        self._last_restore = ep
        if self._restore_streak > self.max_restores:
            self._end(span)
            raise RuntimeError(
                f"restored from snapshot {self.store.path(ep)} "
                f"{self._restore_streak} consecutive times without "
                f"progress (max_restores={self.max_restores}); latest "
                f"failure: {failure or kind}")
        detail = dict(resumed_from=ep, lost_epochs=at - ep)
        if failure is not None:
            detail["failure"] = failure
        if self.store.quarantined:
            detail["quarantined"] = list(self.store.quarantined)
        if failure is not None and self._restore_streak >= 2:
            # same snapshot again with a live health failure: it
            # reproduces — back the step size off before retrying
            # (Adaptive SGD-style).  Planned crashes get no backoff (their
            # re-runs must stay bit-identical); the streak cap above still
            # ends a crash ping-pong.
            self.eta0 *= self.eta_decay
            detail["eta0"] = self.eta0
        self._note(LedgerEvent(kind=kind, epoch=at, action="restore",
                               epochs_lost=at - ep,
                               retry=self._restore_streak,
                               detail=detail))
        self._adopt(opt, snap)
        self._end(span)
        return opt

    def _rebuild(self, opt: ShardedDSO, mesh, dso_kw: dict) -> ShardedDSO:
        """New ShardedDSO on ``mesh`` continuing ``opt``'s exact iterate
        (used by replans; the caller reshards the state first if p
        changed).  Every chunk length is cold again after this."""
        state, key, done = opt.solver_state(), opt.key, opt.epochs_done
        new = ShardedDSO(opt.prob, mesh, **dso_kw)
        if tuple(state.w_grid.shape) != (new.p, new.db):
            state = reshard_state(state, opt.m, opt.d, new.p)
        new.restore(state, key=key, epochs_done=done)
        self._warm.clear()
        return new

    def _replan(self, opt: ShardedDSO, dso_kw: dict) -> ShardedDSO:
        """Straggler-replan escalation: stage 0 switches the schedule to
        "lpt" (same mesh, no epochs lost); stage 1 live-reshards to
        ``reshard_to`` (default p//2) workers, shedding the slow one."""
        t = int(opt.epochs_done)
        if self._replan_stage == 0:
            dso_kw["schedule"] = "lpt"
            opt = self._rebuild(opt, opt.mesh, dso_kw)
            self._relief = self.lpt_relief
            self._monitor.calm()      # baseline kept: escalate if no help
            self._note(LedgerEvent(
                kind="straggler_replan", epoch=t, action="schedule_lpt",
                detail=dict(relief=self._relief)))
        elif self._replan_stage == 1:
            p_new = self.reshard_to or max(1, opt.p // 2)
            self._flush_store()
            if self.store.latest() != t:
                self._save(opt)       # live reshard: nothing is lost
            p_old = opt.p
            span = self._span("reshard", epoch=t, p_from=p_old, p_to=p_new)
            opt = self._rebuild(opt, opt.mesh.resized(p_new), dso_kw)
            self._end(span)
            self._slow, self._relief = None, 0.0   # slow worker shed
            self._monitor.reset()     # epoch cost structure changed
            self._note(LedgerEvent(
                kind="straggler_replan", epoch=t, action="reshard",
                detail=dict(p_from=p_old, p_to=p_new)))
        else:
            return opt                # escalation exhausted: keep running
        self._replan_stage += 1
        return opt

    def _apply(self, ev: FaultEvent, opt: ShardedDSO,
               dso_kw: dict) -> ShardedDSO:
        t = int(opt.epochs_done)
        if ev.kind == "crash":
            return self._recover(opt, kind="crash")
        if ev.kind == "reshard":
            self._flush_store()
            if self.store.latest() != t:
                self._save(opt)       # live reshard: nothing is lost
            p_old = opt.p
            span = self._span("reshard", epoch=t, p_from=p_old, p_to=ev.arg)
            opt = self._rebuild(opt, opt.mesh.resized(ev.arg), dso_kw)
            self._end(span)
            if self._monitor is not None:
                self._monitor.reset()
            self._note(LedgerEvent(
                kind="reshard", epoch=t, action="reshard",
                detail=dict(p_from=p_old, p_to=ev.arg)))
            return opt
        if ev.kind == "nan":
            # chaos: poison one w block of the LIVE state (after the last
            # save, so the next chunk carries it into real updates)
            st = opt.solver_state()
            idx = int(ev.arg or 0)
            st.w_grid[idx] = float("nan")     # a fresh copy off the workers
            opt.restore(st, key=opt.key, epochs_done=t)
            self._note(LedgerEvent(kind="nan", epoch=t,
                                   action="injected",
                                   detail=dict(block=idx)))
            return opt
        if ev.kind == "corrupt":
            # chaos: bit-flip one byte INSIDE the first leaf's npy payload
            # (zip metadata has semantically dead bytes a flip would not
            # corrupt) — latest-valid-wins must route around the file
            self._flush_store()        # the byte to flip must be on disk
            ep = self.store.latest()
            path = self.store.path(ep)
            with open(path, "r+b") as f:
                blob = f.read()
                at = blob.find(b"\x93NUMPY")
                at = at + 80 if at >= 0 else len(blob) // 2
                f.seek(at)
                byte = f.read(1)
                f.seek(-1, 1)
                f.write(bytes([byte[0] ^ 0xFF]))
            self._note(LedgerEvent(kind="corrupt", epoch=t,
                                   action="bit_flipped",
                                   detail=dict(snapshot=ep)))
            return opt
        if ev.kind == "slow":
            self._slow = ev.arg
            self._relief = 1.0
            self._note(LedgerEvent(
                kind="slow", epoch=t, action="persistent_straggler",
                detail=dict(worker=ev.arg,
                            delay_s_per_epoch=self.straggler_delay_s)))
            return opt
        # straggler: bulk-synchronous math is unchanged; record (and
        # optionally simulate) the one-shot wall-clock skew
        self._note(LedgerEvent(
            kind="straggler", epoch=t, action="simulated_delay",
            detail=dict(worker=ev.arg,
                        simulated_delay_s=self.straggler_delay_s)))
        if self.straggler_delay_s:
            time.sleep(self.straggler_delay_s)
        return opt

    # -------------------------------------------------------------- drive --

    def run_sharded(self, prob, epochs: int, mesh=None, **dso_kw):
        """Run ``prob`` for ``epochs`` total epochs under the fault plan.

        ``dso_kw`` goes to every ``ShardedDSO`` built along the way
        (``impl=``, ``schedule=``, ``row_batches=``, ...).  Returns the
        final ``(ShardedDSO, ledger)`` — the ledger is ``self.log``, a
        list of typed ``LedgerEvent``s covering every detection and
        recovery action; per-checkpoint metrics are in ``self.history``
        (also persisted inside each snapshot).
        """
        dso_kw = dict(dso_kw)
        if self.obs is not None:
            # every solver built along the way (rebuilds included, via
            # dso_kw) mirrors its eval metrics into the same recorder
            dso_kw.setdefault("obs", self.obs)
        if self.telemetry is not None:
            dso_kw.setdefault("telemetry", self.telemetry)
        opt = ShardedDSO(prob, mesh, **dso_kw)
        record_chunk = None
        if self.obs is not None:
            self.obs.record(
                type="meta", phase="run_sharded", epochs=int(epochs), p=opt.p,
                m=int(opt.m), d=int(opt.d), eta0=float(self.eta0),
                checkpoint_every=int(self.checkpoint_every),
                fault_plan=[ev.describe() for ev in self.fault_plan])
            record_chunk = _obs_throughput(
                self.obs, rows=float(opt.m), nnz=opt.nnz,
                payload_bytes=opt.payload_bytes)
        self._flush_store()            # a prior run may still be writing
        if self.store.latest() is not None:
            snap = self.store.load()
            self._adopt(opt, snap)
            self._note(LedgerEvent(kind="resume",
                                   epoch=int(opt.epochs_done),
                                   action="adopt_snapshot"))
        else:
            self._save(opt)           # epoch-0 anchor for early crashes
        # events in the already-completed past are gone; an event AT the
        # current epoch has not fired in THIS supervisor — fire it now
        # (e.g. a planned resize scheduled exactly at the resume point)
        pending = deque(ev for ev in self.fault_plan
                        if ev.epoch >= opt.epochs_done)
        while pending and pending[0].epoch <= opt.epochs_done:
            opt = self._apply(pending.popleft(), opt, dso_kw)
        while opt.epochs_done < epochs:
            t = opt.epochs_done
            stops = [epochs, _next_multiple(t, self.checkpoint_every)]
            if pending:
                stops.append(max(pending[0].epoch, t + 1))
            n = min(stops) - t
            span = self._span("epoch_chunk", t0=t, epochs=n)
            t0 = time.perf_counter()
            opt.run_epochs(n, self.eta0)
            opt.wait()
            if self._slow is not None and self.straggler_delay_s:
                delay = self.straggler_delay_s * n * self._relief
                if delay and self.telemetry is not None:
                    # the simulated sleep is a host-side stand-in for the
                    # slow worker's wall time: attribute it so the
                    # wall-balance heatmap pins the fault on that row
                    self.telemetry.attribute_delay(self._slow, delay,
                                                   t0=t, epochs=n)
                time.sleep(delay)
            dt = time.perf_counter() - t0
            if record_chunk is not None:
                record_chunk(n, dt, self.eta0)
            self._end(span)
            t = opt.epochs_done
            # numerical-health lane: the finite probe gates the snapshot —
            # a poisoned iterate must never reach disk
            if not all_finite(opt.solver_state()):
                opt = self._recover(opt, kind="health",
                                    failure="nonfinite state")
                continue
            if t % self.checkpoint_every == 0 or t == epochs:
                self._save(opt)
                if self.regression_ratio is not None:
                    diag = objective_regression(self.history, key="primal",
                                                ratio=self.regression_ratio)
                    if diag is not None:
                        # the snapshot just written recorded the regressed
                        # trajectory: quarantine it so latest-valid-wins
                        # restores an earlier, healthy one
                        self.store.quarantine(t, reason=diag)
                        opt = self._recover(opt, kind="health",
                                            failure=diag)
                        continue
            # wall-clock lane: EWMA over WARM REGULAR chunks only — a
            # chunk length not seen since the last rebuild pays the new
            # solver's first-run costs, and fault-shortened chunks
            # amortize their dispatch overhead over fewer epochs; neither
            # is a straggler
            if self._monitor is not None:
                cold = (n != self.checkpoint_every) or (n not in self._warm)
                self._warm.add(n)
                if self._monitor.observe(dt / n, cold=cold):
                    opt = self._replan(opt, dso_kw)
            while pending and pending[0].epoch <= t:
                opt = self._apply(pending.popleft(), opt, dso_kw)
        self._flush_store()            # run is durable when we return
        return opt, self.log
