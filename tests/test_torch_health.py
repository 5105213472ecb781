"""The port's numerical-health layer against the JAX reference (CPU).

  1. probes — ``all_finite`` on finite / NaN / inf states;
     ``objective_regression`` gives the reference's verdicts.
  2. ledger — ``LedgerEvent`` dict access, ``ledger_counts`` and the
     rendered ledger equal the reference's.
  3. policy — ``HealthGuard`` validation, ``NaNInjector`` writing in place
     once per epoch, ``WallClockMonitor`` firing where the reference's
     does.
  4. rollback through ``solve(health=...)`` for {sparse_jnp,
     sparse_bucketed_jnp, dense_jnp} x {w, alpha}: the ledger events
     (kind, epoch, action, epochs_lost, eta0) equal the reference's and
     the final w is within 1e-5; exhausted retries raise, or degrade to
     ``solve_serial``, which needs a Problem source.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data.synthetic as jsyn
import repro.engine as je
import repro.runtime as jrt
import repro_torch.data.synthetic as tsyn
import repro_torch.engine as te
import repro_torch.runtime as trt
from repro_torch.engine.data import DSOState

TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = dict(m=120, d=60, density=0.15, loss="hinge", lam=1e-3)


def _pair(seed=0, skewed=False, **over):
    kw = dict(SHAPE, seed=seed, **over)
    if skewed:
        kw["alpha"] = 1.3
        return (jsyn.make_skewed_classification(**kw),
                tsyn.make_skewed_classification(**kw, device="cpu"))
    return (jsyn.make_classification(**kw),
            tsyn.make_classification(**kw, device="cpu"))


def _state(p=2, db=3, mb=4):
    z = torch.zeros
    return DSOState(w_grid=z((p, db)), gw_grid=z((p, db)),
                    alpha=z((p, mb)), ga=z((p, mb)), epoch=0)


# ------------------------------------------------------------------ probes --


@pytest.mark.parametrize("bad", [None, "nan", "inf", "-inf"])
@pytest.mark.parametrize("leaf", ["w_grid", "ga"])
def test_all_finite_probe(bad, leaf):
    st = _state()
    if bad is not None:
        getattr(st, leaf)[1, 2] = float(bad)
    assert trt.all_finite(st) is (bad is None)
    assert trt.all_finite({}) is True
    assert trt.all_finite([np.ones(2), 3]) is True
    assert trt.all_finite([np.array([1.0, np.nan])]) is False


HISTORIES = {
    "short": [{"primal": 1.0}],
    "falling": [{"primal": 1.0}, {"primal": 0.5}, {"primal": 0.4}],
    "regressed": [{"primal": 1.0}, {"primal": 0.5}, {"primal": 1.2}],
    "slack": [{"primal": 0.0}, {"primal": 0.0009}],
    "nan": [{"primal": 1.0}, {"primal": math.nan}],
    "no_key": [{"gap": 1.0}, {"gap": 9.0}],
    "custom": ["x", "y"],
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_objective_regression_matches_reference(name):
    h = HISTORIES[name]
    assert trt.objective_regression(h) == jrt.objective_regression(h)
    assert trt.objective_regression(h, ratio=1.1, slack=0.0) == \
        jrt.objective_regression(h, ratio=1.1, slack=0.0)


# ------------------------------------------------------------------ ledger --


def _events(mod):
    return [mod.LedgerEvent(kind="health", epoch=4, action="rollback",
                            epochs_lost=2, retry=1,
                            detail=dict(resumed_from=2, eta0=0.35)),
            mod.LedgerEvent(kind="crash", epoch=7),
            mod.LedgerEvent(kind="health", epoch=9, action="degrade_serial",
                            retry=2, detail=dict(failure="nonfinite"))]


def test_ledger_helpers_match_reference():
    t_ev, j_ev = _events(trt), _events(jrt)
    assert [e.to_dict() for e in t_ev] == [e.to_dict() for e in j_ev]
    assert trt.ledger_counts(t_ev) == jrt.ledger_counts(j_ev) == \
        {"health": 2, "crash": 1}
    assert trt.render_ledger(t_ev) == jrt.render_ledger(j_ev)
    assert trt.render_ledger([]) == jrt.render_ledger([])
    d = dict(t_ev[0].to_dict(), seq=3, ts=0.1, type="ledger")
    assert trt.render_ledger_event(d) == jrt.render_ledger_event(d)
    ev = t_ev[0]
    assert ev["kind"] == "health" and ev["resumed_from"] == 2
    assert ev.get("missing", 5) == 5


# ------------------------------------------------------------------ policy --


def test_health_guard_validation_and_hooks():
    with pytest.raises(ValueError, match="eta_decay"):
        trt.HealthGuard(eta_decay=0.0)
    with pytest.raises(ValueError, match="on_exhausted"):
        trt.HealthGuard(on_exhausted="ignore")
    g = trt.HealthGuard()
    st = _state()
    assert g.inject(st, 0) is st
    assert g.check_state(st) is None
    st.alpha[0, 0] = float("nan")
    assert g.check_state(st) == "nonfinite state"
    assert g.check_history([{"primal": 1.0}, {"primal": 5.0}]) is not None


def test_nan_injector_fires_once_per_epoch_in_place():
    inj = trt.NaNInjector({2: ("w", 1), 3: ("alpha", 0)})
    st = _state()
    assert inj.inject(st, 0) is st and trt.all_finite(st)
    out = inj.inject(st, 2)
    assert out is st and torch.isnan(st.w_grid[1]).all()
    assert not torch.isnan(st.w_grid[0]).any()
    st.w_grid.zero_()
    assert inj.inject(st, 2) is st and trt.all_finite(st)   # fired once
    inj.inject(st, 3)
    assert torch.isnan(st.alpha[0]).all()
    with pytest.raises(ValueError, match="leaf"):
        trt.NaNInjector({0: ("gw", 0)}).inject(_state(), 0)


@pytest.mark.parametrize("patience", [1, 2])
def test_wall_clock_monitor_matches_reference(patience):
    times = [1.0, 1.1, 0.9, 3.0, 3.2, 1.0, 4.0, 4.0, 4.0, 0.95]
    cold = [True, False, False, False, False, False, False, False, True,
            False]
    t = trt.WallClockMonitor(factor=1.8, patience=patience, beta=0.5)
    j = jrt.WallClockMonitor(factor=1.8, patience=patience, beta=0.5)
    for k, (s, c) in enumerate(zip(times, cold)):
        assert t.observe(s, cold=c) == j.observe(s, cold=c), k
        if k == 5:
            t.calm()
            j.calm()
    assert (t.baseline, t.ewma, t.streak) == (j.baseline, j.ewma, j.streak)
    t.reset()
    assert t.baseline is None and t.ewma is None and t.streak == 0
    with pytest.raises(ValueError, match="factor"):
        trt.WallClockMonitor(factor=1.0)


# ------------------------------------------------------------------- chaos --

NAN_MATRIX = [(b, leaf) for b in ("sparse_jnp", "sparse_bucketed_jnp",
                                  "dense_jnp") for leaf in ("w", "alpha")]
_LEDGER_KEYS = ("kind", "epoch", "action", "epochs_lost", "eta0",
                "resumed_from", "failure", "retry")


@pytest.mark.parametrize("backend,leaf", NAN_MATRIX)
def test_solve_nan_rollback_matches_reference(backend, leaf, tmp_path):
    jp, tp = _pair(skewed=backend == "sparse_bucketed_jnp")
    kw = dict(backend=backend, p=4, epochs=10, eta0=0.5, eval_every=2,
              seed=7, checkpoint_every=2)
    jg = jrt.HealthGuard(eta_decay=0.7,
                         injector=jrt.NaNInjector({4: (leaf, 1)}))
    tg = trt.HealthGuard(eta_decay=0.7,
                         injector=trt.NaNInjector({4: (leaf, 1)}))
    j_res = je.solve(jp, store=jrt.SnapshotStore(str(tmp_path / "j")),
                     health=jg, **kw)
    ts = trt.SnapshotStore(str(tmp_path / "t"))
    t_res = te.solve(tp, store=ts, health=tg, device="cpu", **kw)
    got = [{k: ev.get(k) for k in _LEDGER_KEYS} for ev in tg.ledger]
    want = [{k: ev.get(k) for k in _LEDGER_KEYS} for ev in jg.ledger]
    assert len(got) == 1 and got[0]["action"] == "rollback"
    assert got[0]["eta0"] == pytest.approx(want[0].pop("eta0"))
    got[0].pop("eta0")
    assert got == want
    np.testing.assert_allclose(t_res.w.numpy(), np.asarray(j_res.w), **TOL)
    assert torch.isfinite(t_res.w).all()
    for ep in ts.epochs():     # the poisoned state never reached the disk
        assert ts.verify(ep) == "verified"
    cfg = ts.load().config
    assert cfg["eta_decay"] == 0.7 and cfg["max_retries"] == 3


def test_solve_health_exhausted_raises(tmp_path):
    _, tp = _pair()
    guard = trt.HealthGuard(max_retries=0,
                            injector=trt.NaNInjector({0: ("w", 0)}))
    with pytest.raises(trt.HealthError, match="nonfinite state"):
        te.solve(tp, backend="dense_jnp", p=4, epochs=4, eta0=0.5, seed=7,
                 checkpoint_every=2, store=trt.SnapshotStore(str(tmp_path)),
                 health=guard, device="cpu")


def test_solve_health_degrades_to_serial(tmp_path):
    _, tp = _pair(m=32, d=24)
    guard = trt.HealthGuard(max_retries=0, on_exhausted="serial",
                            injector=trt.NaNInjector({0: ("w", 0)}))
    res = te.solve(tp, backend="dense_jnp", p=4, epochs=4, eta0=0.5,
                   seed=7, eval_every=2, checkpoint_every=2,
                   store=trt.SnapshotStore(str(tmp_path)), health=guard,
                   device="cpu")
    assert torch.isfinite(res.w).all() and res.state is None
    assert [ev["action"] for ev in guard.ledger] == ["degrade_serial"]
    ref = te.solve_serial(tp, epochs=4, eta0=0.5, seed=7, eval_every=2,
                          device="cpu")
    assert torch.equal(res.w, ref.w) and res.history == ref.history


def test_solve_health_serial_needs_problem_source(tmp_path):
    _, tp = _pair(m=32, d=24)
    data = te.make_grid_data(tp, 4)
    guard = trt.HealthGuard(max_retries=0, on_exhausted="serial",
                            injector=trt.NaNInjector({0: ("w", 0)}))
    with pytest.raises(trt.HealthError, match="Problem source"):
        te.solve(data, backend="dense_jnp", epochs=4, eta0=0.5, seed=7,
                 loss_name="hinge", reg_name="l2", lam=tp.lam, m=tp.m,
                 d=tp.d, checkpoint_every=2,
                 store=trt.SnapshotStore(str(tmp_path)), health=guard,
                 device="cpu")


def test_rollback_without_a_store_restarts_fresh():
    """No store and no init: the rollback restarts from epoch 0 with the
    backed-off step size, as the reference's does."""
    jp, tp = _pair()
    kw = dict(backend="sparse_jnp", p=4, epochs=6, eta0=0.5, eval_every=2,
              seed=7)
    jg = jrt.HealthGuard(injector=jrt.NaNInjector({2: ("w", 0)}))
    tg = trt.HealthGuard(injector=trt.NaNInjector({2: ("w", 0)}))
    j_res = je.solve(jp, health=jg, **kw)
    t_res = te.solve(tp, health=tg, device="cpu", **kw)
    assert tg.ledger[0]["resumed_from"] == jg.ledger[0]["resumed_from"] == 0
    assert tg.ledger[0]["epochs_lost"] == jg.ledger[0]["epochs_lost"]
    np.testing.assert_allclose(t_res.w.numpy(), np.asarray(j_res.w), **TOL)
    assert jnp.isfinite(j_res.w).all()
