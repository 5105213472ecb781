"""The port's sharded ring (``core.dso_dist``) on the CPU, at small sizes.

One pool of 4 gloo worker processes serves the whole module.

  1. the ring against the port's grid ``solve`` within 1e-5, for
     {dense_jnp, sparse_jnp, sparse_bucketed_jnp} x {cyclic, lpt, random},
     and the legacy switch's "buckets" payload (the ring's controller
     draws ``random`` from solve's generator);
  2. the ring against the reference's ``ShardedDSO`` (a subprocess with 4
     host devices, as the reference's own tests run it), one cyclic case
     per layout, within 1e-5;
  3. the transports: overlapped vs serial ring, and p2p vs all-gather,
     max|d| = 0.0 on w, gw, alpha and ga over two chunks (the matrix of
     ``tests/test_overlap.py``); ``_p2p_routes`` equal to the reference's;
  4. the telemetry lane, slot for slot against the grid's
     ``run_epochs_telemetry`` buffers;
  5. the seams (state, restore, config, metrics into obs gauges), a
     restored state outside its box (its first epoch through the
     backend's ``clamp_step``) and the pool's failure path (a worker's
     error kills the pool, no process outlives it).
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import repro_torch.data.synthetic as tsyn
import repro_torch.engine as te
from repro.core import dso_dist as jdist
from repro_torch.core import dso_dist as tdist
from repro_torch.obs import RunRecorder, TelemetrySpec
from repro_torch.sparse.format import make_sparse_grid_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = dict(m=120, d=60, density=0.15, loss="hinge", lam=1e-3)
BACKENDS = ["dense_jnp", "sparse_jnp", "sparse_bucketed_jnp"]
SCHEDULES = ["cyclic", "lpt", "random"]


@pytest.fixture(scope="module")
def pool():
    with tdist.WorkerPool(4, timeout=120) as pool:
        yield pool
    assert all(p.poll() is not None for p in pool._procs)


@pytest.fixture(scope="module")
def mesh(pool):
    return tdist.make_dso_mesh(4, device="cpu", pool=pool)


def _prob(backend="sparse_jnp", seed=0):
    if backend.startswith("sparse_bucketed"):
        return tsyn.make_skewed_classification(**SHAPE, alpha=1.3, seed=seed,
                                               device="cpu")
    return tsyn.make_classification(**SHAPE, seed=seed, device="cpu")


def _state(opt):
    st = opt.solver_state()
    return [t.numpy() for t in (st.w_grid, st.gw_grid, st.alpha, st.ga)]


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("backend", BACKENDS + ["sparse_bucketed_jnp_switch"])
def test_ring_matches_grid_solve(mesh, backend, schedule):
    prob = _prob(backend)
    opt = tdist.ShardedDSO(prob, mesh, impl=backend, schedule=schedule,
                           seed=7, alpha0=0.0005)
    opt.run_epochs(3, 0.5)
    opt.run_epochs(2, 0.5)
    ref = te.solve(prob, backend=backend, schedule=schedule, p=4, epochs=5,
                   eta0=0.5, seed=7, alpha0=0.0005, eval_every=5,
                   device="cpu")
    torch.testing.assert_close(opt.w_full(), ref.w, **TOL)
    torch.testing.assert_close(opt.alpha_full(), ref.alpha, **TOL)
    assert opt.epochs_done == 5 and opt.mode == (
        "ring_overlap" if schedule == "cyclic" else "p2p")


REFERENCE_SCRIPT = textwrap.dedent("""
    import json, sys
    import numpy as np
    from repro.core.dso_dist import ShardedDSO
    from repro.data.synthetic import (make_classification,
                                      make_skewed_classification)
    shape = dict(m=120, d=60, density=0.15, loss='hinge', lam=1e-3, seed=0)
    out = {}
    for impl in ('dense_jnp', 'sparse_jnp', 'sparse_bucketed_jnp'):
        prob = (make_skewed_classification(alpha=1.3, **shape)
                if impl.startswith('sparse_bucketed')
                else make_classification(**shape))
        opt = ShardedDSO(prob, impl=impl, schedule='cyclic', seed=7,
                         alpha0=0.0005)
        opt.run_epochs(3, 0.5)
        opt.run_epochs(2, 0.5)
        out[impl] = [np.asarray(opt.w_full()).tolist(),
                     np.asarray(opt.alpha_full()).tolist()]
    with open(sys.argv[1], 'w') as f:
        json.dump(out, f)
""")


@pytest.fixture(scope="module")
def reference_runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref") / "ref.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", REFERENCE_SCRIPT, path],
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("backend", BACKENDS)
def test_ring_matches_reference_sharded(mesh, reference_runs, backend):
    opt = tdist.ShardedDSO(_prob(backend), mesh, impl=backend,
                           schedule="cyclic", seed=7, alpha0=0.0005)
    opt.run_epochs(3, 0.5)
    opt.run_epochs(2, 0.5)
    w_ref, a_ref = reference_runs[backend]
    np.testing.assert_allclose(opt.w_full().numpy(), w_ref, **TOL)
    np.testing.assert_allclose(opt.alpha_full().numpy(), a_ref, **TOL)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("backend", ["dense_jnp", "sparse_bucketed_jnp"])
def test_transports_bit_identical(mesh, backend, schedule):
    """Overlapped ring vs serial shift (cyclic) and p2p vs all-gather (lpt,
    random): the same values to the bit, over two chunks."""
    prob = _prob(backend, seed=5)

    def run(overlap, comm):
        opt = tdist.ShardedDSO(prob, mesh, impl=backend, schedule=schedule,
                               seed=7, alpha0=0.0005, overlap=overlap,
                               comm=comm)
        opt.run_epochs(3, 0.5)
        opt.run_epochs(2, 0.5)
        return opt, _state(opt)

    base, a = run(False, "allgather")
    pipe, b = run(True, "auto")
    want = {"cyclic": ("ring_serial", "ring_overlap")}.get(
        schedule, ("allgather", "p2p"))
    assert (base.mode, pipe.mode) == want
    for name, x, y in zip(("w", "gw", "alpha", "ga"), a, b):
        assert np.abs(x - y).max() == 0.0, (name, backend, schedule)


def test_p2p_routes_match_reference():
    rng = np.random.default_rng(0)
    for p in (1, 2, 3, 4, 5, 8):
        for _ in range(6):
            perm = np.stack([rng.permutation(p) for _ in range(p)])
            assert tdist._p2p_routes(perm) == jdist._p2p_routes(perm), perm
    # identity epochs elide every move but the ones they need
    eye = np.tile(np.arange(4), (4, 1))
    assert tdist._p2p_routes(eye) == [None] * 5


@pytest.mark.parametrize("schedule,comm", [("cyclic", "auto"),
                                           ("lpt", "p2p"),
                                           ("random", "allgather")])
def test_telemetry_matches_grid(mesh, schedule, comm):
    prob = _prob("sparse_jnp", seed=2)
    spec, grid_spec = TelemetrySpec(), TelemetrySpec()
    opt = tdist.ShardedDSO(prob, mesh, impl="sparse_jnp", schedule=schedule,
                           seed=3, comm=comm, telemetry=spec)
    opt.run_epochs(2, 0.5)
    opt.run_epochs(1, 0.5)
    te.solve(prob, backend="sparse_jnp", schedule=schedule, p=4, epochs=3,
             eta0=0.5, seed=3, eval_every=2, telemetry=grid_spec,
             device="cpu")
    assert [(c.t0, c.epochs) for c in spec.chunks] == [(0, 2), (2, 1)]
    assert [(c.t0, c.epochs) for c in grid_spec.chunks] == [(0, 2), (2, 1)]
    transport = {"cyclic": "ring", "lpt": "p2p", "random": "allgather"}
    for got, want in zip(spec.chunks, grid_spec.chunks):
        assert got.transport == transport[schedule]
        assert got.buf.shape == want.buf.shape == (got.epochs, 4, 4, 5)
        np.testing.assert_array_equal(got.buf, want.buf)
        np.testing.assert_array_equal(got.etas, want.etas)
        if schedule != "random":
            np.testing.assert_array_equal(got.comm, want.comm)


def test_seams(mesh, tmp_path):
    prob = _prob("dense_jnp", seed=1)
    rec = RunRecorder()
    opt = tdist.ShardedDSO(prob, mesh, impl="dense_jnp", seed=4, obs=rec)
    opt.run_epochs(2, 0.5)
    opt.wait()
    st = opt.solver_state()
    assert st.w_grid.shape == (4, 15) and st.alpha.shape == (4, 30)
    assert st.epoch == 2
    cfg = opt.snapshot_config()
    assert (cfg["p"], cfg["db"], cfg["mb"], cfg["eta0"]) == (4, 15, 30, 0.5)
    assert cfg["backend"] == "dense_jnp" and cfg["schedule"] == "cyclic"
    m = opt.metrics()
    assert set(m) == {"epoch", "primal", "gap"}
    assert rec.metrics.gauge("eval.primal").value == m["primal"]
    # a restored state continues the stored trajectory exactly
    again = tdist.ShardedDSO(prob, mesh, impl="dense_jnp", seed=4)
    again.restore(st, key=opt.key)
    opt.run_epochs(2, 0.5)
    again.run_epochs(2, 0.5)
    assert torch.equal(opt.w_full(), again.w_full())
    assert torch.equal(opt.alpha_full(), again.alpha_full())
    with pytest.raises(ValueError, match="reshard_state"):
        opt.restore(st._replace(w_grid=st.w_grid[:2]))
    w, a, hist = tdist.run_dso_sharded(prob, epochs=4, eta0=0.5, mesh=mesh,
                                       eval_every=2, seed=4)
    ref = te.solve(prob, backend="dense_jnp", p=4, epochs=4, eta0=0.5,
                   seed=4, eval_every=2, device="cpu")
    torch.testing.assert_close(w, ref.w, **TOL)
    assert [h["epoch"] for h in hist] == [2, 4]
    for h, r in zip(hist, ref.history):
        assert h["primal"] == pytest.approx(r["primal"], rel=1e-5)


class _OneWorker:
    """The group of a ring of one worker (no moves)."""
    device, rank, size = torch.device("cpu"), 0, 1

    def sync(self):
        pass


@pytest.mark.parametrize("w_scale", [2.0, 0.5], ids=["outside", "inside"])
def test_restore_outside_the_box_clamps_the_first_epoch(mesh, monkeypatch,
                                                        w_scale):
    """``ShardedDSO.restore`` of a state whose w lies at twice its box's
    upper edge posts its next run with the first epoch through the
    backend's ``clamp_step`` (one reduction, in the controller), and no
    run after it; a state inside its box never does.  A worker's run
    (``_Shard.run``, here with recording steps) takes ``clamp_step`` for
    that epoch's inner iterations and ``block_step`` after, as
    ``solve(init=)`` does; and the ring from the restored state equals
    ``solve(init=)`` from it within 1e-5."""
    from repro_torch.engine.backends import TileBackend
    from repro_torch.runtime.snapshot import DSOSnapshot
    prob = _prob("sparse_jnp", seed=2)
    opt = tdist.ShardedDSO(prob, mesh, impl="sparse_jnp", seed=0)
    st = opt.solver_state()
    st = st._replace(w_grid=torch.full_like(st.w_grid, w_scale * opt.w_hi))
    posted = []
    post = mesh.pool.post

    def record(op, args, done=None):
        if op == "run":
            posted.append(args[0][-1])
        return post(op, args, done)
    monkeypatch.setattr(mesh.pool, "post", record)
    opt.restore(st)
    opt.run_epochs(2, 0.5)
    opt.run_epochs(1, 0.5)
    assert posted == [w_scale > 1, False]
    ref = te.solve(prob, backend="sparse_jnp", p=4, epochs=3, eta0=0.5,
                   init=DSOSnapshot(st, torch.Generator().manual_seed(0),
                                    0, (), {}), device="cpu")
    torch.testing.assert_close(opt.w_full(), ref.w, **TOL)

    calls = []
    shard = tdist._Shard(_OneWorker(), "sparse_jnp", (), 1, [None],
                         *(torch.zeros(n) for n in (3, 3, 2, 2)))
    shard.be = TileBackend("recording", "sparse",
                           lambda *a: calls.append("block_step"),
                           clamp_step=lambda *a: calls.append("clamp_step"))
    shard.run([0.5, 0.4, 0.3], None, "ring_overlap", False,
              clamp=w_scale > 1)
    first = "clamp_step" if w_scale > 1 else "block_step"
    assert calls == [first, "block_step", "block_step"]


def test_grid_source_retiles_to_the_mesh(mesh):
    """Pre-built grid data at p = 2 runs on the p = 4 mesh, re-tiled, as
    ``solve`` runs the same data at p = 4."""
    prob = _prob("sparse_jnp", seed=3)
    grid2 = make_sparse_grid_data(prob, 2, device="cpu")
    kw = dict(loss_name="hinge", reg_name="l2", lam=1e-3, m=120, d=60)
    opt = tdist.ShardedDSO(grid2, mesh, impl="sparse_jnp", seed=1, **kw)
    opt.run_epochs(3, 0.5)
    assert opt.p == 4 and opt.metrics() == {"epoch": 3}
    ref = te.solve(prob, backend="sparse_jnp", p=4, epochs=3, eta0=0.5,
                   seed=1, device="cpu")
    torch.testing.assert_close(opt.w_full(), ref.w, **TOL)
    with pytest.raises(ValueError, match="needs"):
        tdist.ShardedDSO(grid2, mesh, impl="sparse_jnp")


def test_mesh_validation(pool):
    with pytest.raises(ValueError, match="transport"):
        tdist.make_dso_mesh(2, device="cpu", transport="mpi", pool=pool)
    with pytest.raises(ValueError, match="nccl"):
        tdist.make_dso_mesh(2, device="cpu", transport="nccl", pool=pool)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            tdist.make_dso_mesh(2, pool=pool)
    with pytest.raises(ValueError, match="comm"):
        tdist.ShardedDSO(_prob(), tdist.make_dso_mesh(2, device="cpu",
                                                      pool=pool),
                         comm="ring")


def test_worker_error_kills_the_pool():
    pool = tdist.WorkerPool(1, timeout=60)
    procs = list(pool._procs)
    with pytest.raises(RuntimeError, match="raised during 'no_such_op'"):
        pool.call("no_such_op", [()])
    assert pool.closed
    assert all(p.poll() is not None for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        pool.call("counts", [()])
