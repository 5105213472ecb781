"""Numerical health: probes, the recovery ledger and the rollback policy.

* **Probes** — ``all_finite``: one ``torch.isfinite(...).all()`` per leaf
  of a state pytree, combined on the device, and one host sync for the
  answer (the reference jits the same probe).  ``objective_regression``
  watches the evaluation history: an objective that climbs past
  ``best * ratio + slack`` (or turns non-finite) marks the run diverged
  while every number is still finite.

* **Ledger** — every detection and action is a typed ``LedgerEvent``
  (kind / epoch / action / epochs_lost / retry / detail); a
  ``HealthGuard`` accumulates one for ``engine.solve``.

* **Policy** — ``HealthGuard`` is the duck-typed ``solve(health=...)``
  object (the engine never imports this package): rollback to the latest
  valid snapshot with the step size backed off by ``eta_decay`` per
  rollback, at most ``max_retries`` rollbacks, then raise ``HealthError``
  or degrade to the paper-exact ``solve_serial``.

* **Wall clock** — ``WallClockMonitor``: an EWMA of warm per-epoch chunk
  times against the best seen, firing after ``patience`` hot chunks.

* **Chaos** — ``NaNInjector`` poisons chosen state rows at chosen epochs,
  once each, writing the NaNs into the state's tensors in place (the
  port's state is updated in place throughout).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.runtime.snapshot import tree_leaves


class HealthError(RuntimeError):
    """Numerical-health failure the rollback policy could not recover."""


# --------------------------------------------------------------- probes --


def all_finite(tree) -> bool:
    """True when every leaf of a state pytree is finite: one isfinite
    reduction per tensor leaf, combined on its device, and one host sync
    per device (one for a ``DSOState``)."""
    flags = {}
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            flags.setdefault(leaf.device, []).append(
                torch.isfinite(leaf).all())
        elif not np.isfinite(np.asarray(leaf, np.float64)).all():
            return False
    return all(bool(torch.stack(f).all()) for f in flags.values())


def objective_regression(history, *, key: str = "primal",
                         ratio: float = 2.0, slack: float = 1e-3):
    """A diagnostic string when the newest recorded objective exceeds
    ``best_so_far * ratio + slack`` (or is not finite), else ``None``.
    Histories without the key (custom hooks) are skipped."""
    vals = [h[key] for h in history if isinstance(h, dict) and key in h]
    if len(vals) < 2:
        return None
    latest, best = float(vals[-1]), float(min(vals[:-1]))
    if not np.isfinite(latest):
        return f"objective {key}={latest} is not finite"
    if latest > best * ratio + slack:
        return (f"objective regression: {key}={latest:.6g} vs best-so-far "
                f"{best:.6g} (ratio {ratio}, slack {slack})")
    return None


# --------------------------------------------------------------- ledger --


@dataclass
class LedgerEvent:
    """One typed recovery-ledger entry: what was detected, what was done.
    ``ev[k]`` reads the attribute, then ``detail``."""

    kind: str                 # crash|reshard|straggler|nan*|health|...
    epoch: int = 0            # epoch the event was detected/fired at
    action: str = ""          # what the runtime did about it
    epochs_lost: int = 0      # re-run epochs this event cost
    retry: int = 0            # consecutive-recovery counter when relevant
    detail: dict = field(default_factory=dict)

    def __getitem__(self, k):
        if hasattr(self, k):
            return getattr(self, k)
        return self.detail[k]

    def get(self, k, default=None):
        try:
            return self[k]
        except KeyError:
            return default

    def to_dict(self) -> dict:
        return dict(kind=self.kind, epoch=self.epoch, action=self.action,
                    epochs_lost=self.epochs_lost, retry=self.retry,
                    **self.detail)


def ledger_counts(ledger) -> dict:
    """{kind: occurrences} of a recovery ledger."""
    out: dict = {}
    for ev in ledger:
        out[ev["kind"]] = out.get(ev["kind"], 0) + 1
    return out


def render_ledger_event(ev) -> str:
    """One ledger entry (a ``LedgerEvent`` or a dict with its keys, such
    as a recorder's ``type="ledger"`` event) as one line."""
    kind = ev["kind"]
    epoch = ev.get("epoch", 0)
    action = ev.get("action", "")
    bits = [f"{kind}@{epoch}"]
    if action:
        bits.append(action)
    lost = ev.get("epochs_lost", 0)
    if lost:
        bits.append(f"(lost {lost} epoch{'s' if lost != 1 else ''})")
    retry = ev.get("retry", 0)
    if retry:
        bits.append(f"retry={retry}")
    detail = (ev.detail if hasattr(ev, "detail")
              else {k: v for k, v in ev.items()
                    if k not in ("seq", "ts", "type", "kind", "epoch",
                                 "action", "epochs_lost", "retry")})
    if detail:
        bits.append(" ".join(f"{k}={v}" for k, v in detail.items()))
    return " ".join(bits)


def render_ledger(ledger, *, prefix: str = "  [ledger] ") -> str:
    """A whole ledger as one block, the kind counts on the last line."""
    if not ledger:
        return f"{prefix}no events"
    lines = [prefix + render_ledger_event(ev) for ev in ledger]
    lines.append(f"{prefix}counts: {ledger_counts(ledger)}")
    return "\n".join(lines)


# ---------------------------------------------------------------- chaos --


class NaNInjector:
    """Poison chosen ``DSOState`` rows at chosen epochs, once each.

    ``plan`` maps epoch -> (leaf, index): ``"w"`` poisons w block
    ``index``, ``"alpha"`` dual shard ``index``.  The injection happens at
    the chunk boundary entering that epoch, in place, so the NaN goes
    through a real epoch of updates before any probe sees it."""

    def __init__(self, plan: dict):
        self.plan = {int(e): (leaf, int(idx))
                     for e, (leaf, idx) in plan.items()}
        self.fired: set = set()

    def inject(self, state, t: int):
        if t not in self.plan or t in self.fired:
            return state
        leaf, idx = self.plan[t]
        if leaf not in ("w", "alpha"):
            raise ValueError(f"NaNInjector leaf {leaf!r}: 'w' | 'alpha'")
        self.fired.add(t)
        target = state.w_grid if leaf == "w" else state.alpha
        target[idx] = float("nan")
        return state


# ---------------------------------------------------------------- guard --


class HealthGuard:
    """Rollback-with-eta-backoff policy for ``engine.solve(health=...)``.

    The driver calls, per chunk, ``inject`` (the chaos seam),
    ``check_state`` (``all_finite``) and ``check_history`` (the
    objective-regression monitor); on a failed check it reads
    ``eta_decay`` and calls ``note`` / ``exhausted``.  The guard owns the
    retry budget, the driver the restore.  ``on_exhausted``: ``"raise"``
    raises ``HealthError`` once ``max_retries`` rollbacks are spent;
    ``"serial"`` asks the driver to degrade to ``solve_serial`` (Problem
    sources only)."""

    def __init__(self, *, eta_decay: float = 0.5, max_retries: int = 3,
                 regression_ratio: float = 2.0,
                 regression_slack: float = 1e-3,
                 objective_key: str = "primal",
                 on_exhausted: str = "raise", injector=None):
        if not 0.0 < eta_decay <= 1.0:
            raise ValueError(f"eta_decay must be in (0, 1], got {eta_decay}")
        if on_exhausted not in ("raise", "serial"):
            raise ValueError(f"on_exhausted {on_exhausted!r}: raise|serial")
        self.eta_decay = eta_decay
        self.max_retries = max_retries
        self.regression_ratio = regression_ratio
        self.regression_slack = regression_slack
        self.objective_key = objective_key
        self.on_exhausted = on_exhausted
        self.injector = injector
        self.retries = 0
        self.ledger: list = []
        # ``solve(obs=...)`` binds its recorder here when unset, so the
        # guard's decisions land in the run-event log
        self.obs = None

    def inject(self, state, t: int):
        return state if self.injector is None else \
            self.injector.inject(state, t)

    def check_state(self, state):
        return None if all_finite(state) else "nonfinite state"

    def check_history(self, history):
        return objective_regression(history, key=self.objective_key,
                                    ratio=self.regression_ratio,
                                    slack=self.regression_slack)

    def record(self, event: LedgerEvent):
        self.ledger.append(event)
        if self.obs is not None:
            self.obs.record_ledger(event)

    def note(self, *, kind: str, epoch: int = 0, action: str = "",
             epochs_lost: int = 0, retry: int = 0, **detail):
        """Construct and record an event (the driver never touches
        ``LedgerEvent`` itself)."""
        self.record(LedgerEvent(kind=kind, epoch=epoch, action=action,
                                epochs_lost=epochs_lost, retry=retry,
                                detail=detail))

    def exhausted(self, *, failure: str, epoch: int, eta0: float,
                  can_degrade: bool) -> str:
        """Called when ``retries > max_retries``: returns ``"serial"`` to
        request the degradation, else raises ``HealthError``."""
        diag = (f"numerical health failed at epoch {epoch} ({failure}) "
                f"after {self.retries - 1} rollback(s); eta0 backed off to "
                f"{eta0:.3g} (decay {self.eta_decay}/rollback)")
        if self.on_exhausted == "serial":
            if can_degrade:
                self.record(LedgerEvent(kind="health", epoch=epoch,
                                        action="degrade_serial",
                                        retry=self.retries,
                                        detail=dict(failure=failure)))
                return "serial"
            diag += ("; on_exhausted='serial' needs a Problem source to "
                     "rebuild the pointwise reference from")
        raise HealthError(diag)


# ----------------------------------------------------------- wall clock --


class WallClockMonitor:
    """EWMA straggler detector over warm per-epoch chunk wall times.

    ``observe(s_per_epoch, cold=...)`` returns True once the EWMA has sat
    above ``factor`` x the best warm time for ``patience`` consecutive
    warm chunks; cold chunks (the first after a rebuild) are never fed."""

    def __init__(self, *, factor: float = 1.8, patience: int = 1,
                 beta: float = 0.5):
        if factor <= 1.0:
            raise ValueError(f"factor must be > 1, got {factor}")
        self.factor = factor
        self.patience = patience
        self.beta = beta
        self.reset()

    def reset(self):
        """Full reset (after a reshard the epoch's cost changed)."""
        self.baseline = None
        self.ewma = None
        self.streak = 0

    def calm(self):
        """Reset the hot streak only; the baseline stays."""
        self.streak = 0
        self.ewma = None

    def observe(self, s_per_epoch: float, *, cold: bool = False) -> bool:
        if cold:
            return False
        self.baseline = (s_per_epoch if self.baseline is None
                         else min(self.baseline, s_per_epoch))
        self.ewma = (s_per_epoch if self.ewma is None else
                     self.beta * s_per_epoch + (1 - self.beta) * self.ewma)
        if self.ewma > self.factor * self.baseline:
            self.streak += 1
        else:
            self.streak = 0
        return self.streak >= self.patience
