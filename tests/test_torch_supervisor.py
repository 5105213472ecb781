"""The port's ``runtime.Supervisor`` over the sharded ring, on the CPU.

The reference's supervisor tests (``tests/test_runtime.py``: crash
recovery, a store that resumes with its real config, validation, the
seeded fault plan, crash and reshard 4 -> 2, the ``max_restores`` cap,
NaN plus corrupt chaos, straggler escalation), run on meshes of 1, 2 and
4 gloo worker processes drawn from one pool per module; and the elastic
scenario ``python -m repro_torch.examples.elastic_dso``, once, small.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.runtime as jrt
import repro_torch.data.synthetic as tsyn
import repro_torch.engine as te
from repro_torch.core.dso_dist import ShardedDSO, WorkerPool, make_dso_mesh
from repro_torch.runtime import (FaultEvent, SnapshotStore, Supervisor,
                                 make_fault_plan, periodic_crashes, resume)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def pool():
    with WorkerPool(4, timeout=120) as pool:
        yield pool
    assert all(p.poll() is not None for p in pool._procs)


def _mesh(pool, p):
    return make_dso_mesh(p, device="cpu", pool=pool)


def _prob(m=32, d=24, density=0.15, seed=0):
    return tsyn.make_classification(m=m, d=d, density=density, loss="hinge",
                                    lam=1e-3, seed=seed, device="cpu")


def _max_diff(a, b) -> float:
    return float((a.w_full() - b.w_full()).abs().max())


@pytest.mark.parametrize("p", [1, 4])
def test_supervisor_crash_recovery_exact(pool, tmp_path, p):
    """Crashes off the checkpoint boundary lose epochs; the re-run
    recovers them bit for bit."""
    prob = _prob()
    ref = ShardedDSO(prob, _mesh(pool, p), impl="jnp", seed=5)
    ref.run_epochs(6, 0.5)
    sup = Supervisor(SnapshotStore(str(tmp_path)), checkpoint_every=2,
                     eta0=0.5, fault_plan=(FaultEvent(3, "crash"),
                                           FaultEvent(5, "straggler", 0)))
    opt, log = sup.run_sharded(prob, 6, mesh=_mesh(pool, p), impl="jnp",
                               seed=5)
    assert [ev["kind"] for ev in log] == ["crash", "straggler"]
    assert log[0]["lost_epochs"] == 1   # crashed at 3, snapshot was at 2
    assert _max_diff(opt, ref) == 0.0


def test_supervisor_store_resumes_with_real_config(pool, tmp_path):
    """The supervisor stamps its eta0 and cadence into every snapshot, so
    ``runtime.resume`` over its store replays the right step size and keeps
    checkpointing, even from the epoch-0 anchor."""
    prob = _prob()
    store = SnapshotStore(str(tmp_path))
    sup = Supervisor(store, checkpoint_every=2, eta0=0.5)
    sup.run_sharded(prob, 4, mesh=_mesh(pool, 1), impl="jnp", seed=5)
    for epoch in store.epochs():       # anchor (0) included
        cfg = store.load(epoch).config
        assert cfg["eta0"] == 0.5 and cfg["checkpoint_every"] == 2, epoch
    res = resume(prob, store, epochs=6, device="cpu")
    assert store.latest() == 6         # the resumed run kept checkpointing
    ref = te.solve(prob, backend="dense_jnp", p=1, epochs=6, eta0=0.5,
                   seed=5, device="cpu")
    torch.testing.assert_close(res.w, ref.w, rtol=1e-5, atol=1e-5)


def test_supervisor_validation(tmp_path):
    with pytest.raises(ValueError, match="checkpoint_every"):
        Supervisor(SnapshotStore(str(tmp_path)), checkpoint_every=0)
    with pytest.raises(ValueError, match="unknown fault kind"):
        Supervisor(SnapshotStore(str(tmp_path)),
                   fault_plan=(FaultEvent(1, "meteor"),))
    with pytest.raises(ValueError, match="eta_decay"):
        Supervisor(SnapshotStore(str(tmp_path)), eta_decay=0.0)
    with pytest.raises(ValueError, match="max_restores"):
        Supervisor(SnapshotStore(str(tmp_path)), max_restores=0)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_make_fault_plan_matches_reference(seed):
    kw = dict(crash_rate=0.3, straggler_rate=0.2, p=4, reshard_at={10: 2})
    ours = make_fault_plan(seed, 20, **kw)
    theirs = jrt.make_fault_plan(seed, 20, **kw)
    assert [tuple(ev) for ev in ours] == [tuple(ev) for ev in theirs]
    assert ours == make_fault_plan(seed, 20, **kw)
    assert any(ev.kind == "reshard" for ev in ours)
    assert [ev.describe() for ev in ours] == [ev.describe() for ev in theirs]
    assert [tuple(ev) for ev in periodic_crashes(3, 10)] == \
        [tuple(ev) for ev in jrt.periodic_crashes(3, 10)]


def test_supervisor_sharded_crash_and_reshard(pool, tmp_path):
    """Crash recovery is exact on a 4-worker mesh, and a live 4 -> 2
    reshard, started by a fresh supervisor over the same store, continues
    through a rebuilt ShardedDSO with the gap falling."""
    prob = tsyn.make_classification(m=64, d=48, density=0.15, loss="hinge",
                                    lam=1e-3, seed=0, device="cpu")
    ref = ShardedDSO(prob, _mesh(pool, 4), impl="sparse_jnp", seed=5)
    ref.run_epochs(6, 0.5)
    d = str(tmp_path)
    sup = Supervisor(SnapshotStore(d), checkpoint_every=2, eta0=0.5,
                     fault_plan=periodic_crashes(3, 6))
    opt, log = sup.run_sharded(prob, 6, mesh=_mesh(pool, 4),
                               impl="sparse_jnp", seed=5)
    assert _max_diff(opt, ref) == 0.0
    sup2 = Supervisor(SnapshotStore(d), checkpoint_every=2, eta0=0.5,
                      fault_plan=(FaultEvent(6, "reshard", 2),))
    opt, log = sup2.run_sharded(prob, 10, mesh=_mesh(pool, 4),
                                impl="sparse_jnp", seed=5)
    assert opt.p == 2 and opt.epochs_done == 10
    assert [ev["kind"] for ev in log] == ["resume", "reshard"]
    assert (log[1]["p_from"], log[1]["p_to"]) == (4, 2)
    gaps = [h["gap"] for h in sup2.history]
    assert gaps[-1] < gaps[0]


def test_supervisor_max_restores_caps_ping_pong(pool, tmp_path):
    prob = _prob()
    plan = tuple(FaultEvent(3, "crash") for _ in range(4))
    sup = Supervisor(SnapshotStore(str(tmp_path)), checkpoint_every=2,
                     eta0=0.5, max_restores=2, fault_plan=plan)
    with pytest.raises(RuntimeError,
                       match=r"dso_00000002\.npz 3 consecutive times.*"
                             r"max_restores=2"):
        sup.run_sharded(prob, 6, mesh=_mesh(pool, 1), impl="jnp", seed=5)


def test_supervisor_nan_and_corrupt_chaos_recovers_exactly(pool, tmp_path):
    """A NaN injection is caught by the health lane before it reaches
    disk, a bit-flipped latest snapshot is quarantined on the next restore
    (latest-valid-wins), and with no eta backoff the final trajectory is
    still bit for bit the clean one."""
    prob = _prob()
    ref = ShardedDSO(prob, _mesh(pool, 2), impl="jnp", seed=5)
    ref.run_epochs(8, 0.5)
    store = SnapshotStore(str(tmp_path))
    plan = (FaultEvent(2, "nan", 0), FaultEvent(4, "corrupt"),
            FaultEvent(5, "crash"))
    sup = Supervisor(store, checkpoint_every=2, eta0=0.5, fault_plan=plan)
    opt, log = sup.run_sharded(prob, 8, mesh=_mesh(pool, 2), impl="jnp",
                               seed=5)
    assert [ev["kind"] for ev in log] == ["nan", "health", "corrupt",
                                          "crash"]
    health = log[1]
    assert health["action"] == "restore"
    assert health["failure"] == "nonfinite state"
    assert health["resumed_from"] == 2 and health["epochs_lost"] == 2
    crash = log[3]
    assert crash["resumed_from"] == 2 and crash["epochs_lost"] == 3
    assert [e for e, _ in crash["quarantined"]] == [4]
    assert [e for e, _ in store.quarantined] == [4]
    assert sup.eta0 == 0.5   # single restores never back the step off
    assert _max_diff(opt, ref) == 0.0


def test_supervisor_straggler_replan_escalation(pool, tmp_path):
    """A persistent straggler first triggers the lpt replan, then (still
    slow at half relief) a live reshard that sheds it."""
    prob = _prob()
    sup = Supervisor(SnapshotStore(str(tmp_path)), checkpoint_every=1,
                     eta0=0.5, fault_plan=(FaultEvent(3, "slow", 0),),
                     straggler_delay_s=0.25, replan=True,
                     straggler_factor=1.5, straggler_patience=1,
                     reshard_to=1)
    opt, log = sup.run_sharded(prob, 10, mesh=_mesh(pool, 2), impl="jnp",
                               seed=5)
    actions = [ev["action"] for ev in log
               if ev["kind"] == "straggler_replan"]
    assert actions == ["schedule_lpt", "reshard"]
    reshard_ev = [ev for ev in log if ev["action"] == "reshard"][-1]
    assert (reshard_ev["p_from"], reshard_ev["p_to"]) == (2, 1)
    assert opt.p == 1 and opt.epochs_done == 10
    assert np.isfinite(opt.w_full().numpy()).all()


def test_elastic_example_runs(tmp_path):
    """The kill-resume-reshard scenario end to end, in its own process
    (its worker pool ends with it)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.elastic_dso",
         "--device", "cpu", "--epochs", "4"],
        env=env, capture_output=True, text=True, timeout=300,
        cwd=str(tmp_path))
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    assert "ELASTIC_OK" in out.stdout
