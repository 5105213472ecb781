"""The port's elastic runtime against the JAX reference (CPU, small sizes).

  1. codec — the port's files pass the reference's ``verify_pytree`` /
     ``load_pytree`` and the reference's files the port's, leaf for leaf;
     bit flips and truncation are caught; legacy files verify; the
     corruption matrix and the retention gc of ``SnapshotStore``.
  2. saves — ``solve(checkpoint_every=2, store=...)`` saves at the
     reference's epochs, with the reference's config, and states within
     1e-5 of the reference's for {sparse_jnp, sparse_bucketed_jnp,
     dense_jnp} x {cyclic, random, lpt} (the reference's random
     permutations replayed through ``fixed_schedule``).
  3. resume — inside the port, resume against the uninterrupted run is
     max |delta| = 0.0 for the same matrix; a reference snapshot resumes
     in the port (and a port snapshot in the reference) for cyclic within
     1e-5 of the other package's resumed run; a jax key under the random
     schedule is refused by name.
  4. layouts — ``grid_to_csr``, ``regrid_direct``, ``retile`` and
     ``reshard_state`` equal the reference's arrays exactly; p' = p
     reshard continues with max |delta| = 0.0.
  5. the in-place hazard — a saved snapshot, sync and async, is unchanged
     after the next chunk runs; ``init`` is not mutated by the resumed
     run.
"""

import os

import jax
import numpy as np
import pytest
import torch

import repro.data.synthetic as jsyn
import repro.engine as je
import repro.runtime as jrt
import repro_torch.data.synthetic as tsyn
import repro_torch.engine as te
import repro_torch.runtime as trt
from repro.engine import schedules as jsched
from repro.engine.data import DSOState as JState
from repro.sparse import format as jformat
from repro_torch.engine import schedules as tsched
from repro_torch.engine.data import DSOState as TState
from repro_torch.runtime.reshard import retile as t_retile
from repro_torch.sparse import format as tformat

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


def _np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
        else np.asarray(a)


def _state_close(t_state, j_state, **tol):
    for f in ("w_grid", "gw_grid", "alpha", "ga"):
        np.testing.assert_allclose(_np(getattr(t_state, f)),
                                   np.asarray(getattr(j_state, f)),
                                   err_msg=f, **(tol or TOL))
    assert int(t_state.epoch) == int(j_state.epoch)


def _state_equal(a, b):
    for f in ("w_grid", "gw_grid", "alpha", "ga"):
        np.testing.assert_array_equal(_np(getattr(a, f)),
                                      _np(getattr(b, f)), err_msg=f)
    assert int(a.epoch) == int(b.epoch)


# -------------------------------------------------------------------- codec --


def _trees():
    """The same tree for each package: a DSO state (NamedTuple, int32
    epoch), nested dicts/lists/tuples, several dtypes, a None."""
    rng = np.random.default_rng(0)
    w = rng.normal(size=(4, 15)).astype(np.float32)
    a = rng.normal(size=(4, 30)).astype(np.float32)
    extra = {"z": [np.int64(7), (np.arange(5, dtype=np.int32),
                                  np.ones((2, 2)))],
             "b": np.bool_(True), "n": None}
    t_tree = {"state": TState(torch.tensor(w), torch.tensor(w * 2),
                              torch.tensor(a), torch.tensor(a * 3),
                              np.int32(5)), **extra}
    j_tree = {"state": JState(jax.numpy.asarray(w), jax.numpy.asarray(w * 2),
                              jax.numpy.asarray(a), jax.numpy.asarray(a * 3),
                              jax.numpy.int32(5)), **extra}
    return t_tree, j_tree


def _leaves_equal(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_codec_files_cross_accepted(writer, tmp_path):
    t_tree, j_tree = _trees()
    path = str(tmp_path / "t.npz")
    meta = {"step": 3, "note": "hi", "vals": [1.5, 2.0]}
    if writer == "port":
        trt.save_pytree(path, t_tree, meta=meta)
    else:
        jrt.save_pytree(path, j_tree, meta=meta)
    assert trt.verify_pytree(path) == jrt.verify_pytree(path) == "verified"
    assert trt.read_meta(path) == jrt.read_meta(path) == meta
    # the same leaf names, dtypes and values on both sides
    _leaves_equal(trt.flatten_pytree(t_tree), jrt.flatten_pytree(j_tree))
    with np.load(path) as data:
        on_disk = {k: data[k] for k in data.files if not k.startswith("__")}
    _leaves_equal(on_disk, jrt.flatten_pytree(j_tree))
    t_got, t_meta = trt.load_pytree(path, t_tree)
    j_got, j_meta = jrt.load_pytree(path, j_tree)
    assert t_meta == j_meta == meta
    assert isinstance(t_got["state"].w_grid, torch.Tensor)
    assert t_got["n"] is None
    _leaves_equal(trt.flatten_pytree(t_got), jrt.flatten_pytree(j_got))


def test_codec_crc_record_equals_the_reference(tmp_path):
    t_tree, j_tree = _trees()
    pt, pj = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    trt.save_pytree(pt, t_tree, meta={"k": 1})
    jrt.save_pytree(pj, j_tree, meta={"k": 1})
    with np.load(pt) as a, np.load(pj) as b:
        assert str(a["__crc__"][()]) == str(b["__crc__"][()])
        assert str(a["__meta__"][()]) == str(b["__meta__"][()])


def test_codec_loud_errors(tmp_path):
    path = str(tmp_path / "t.npz")
    trt.save_pytree(path, {"a": np.ones(3)})
    with pytest.raises(ValueError, match="shape"):
        trt.load_pytree(path, {"a": np.ones(4)})
    with pytest.raises(ValueError, match="lacks leaf"):
        trt.load_pytree(path, {"b": np.ones(3)})
    with pytest.raises(ValueError, match="separator"):
        trt.save_pytree(path, {"a|b": np.ones(3)})
    assert trt.read_meta(path) is None
    with pytest.raises(ValueError, match="not a DSO snapshot"):
        trt.load_snapshot(path)


@pytest.mark.parametrize("verifier", ["port", "reference"])
def test_verify_pytree_detects_bit_flip(verifier, tmp_path):
    path = str(tmp_path / "t.npz")
    trt.save_pytree(path, {"w": np.arange(256, dtype=np.float32)},
                    meta={"k": 1})
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 3] ^= 0x10
    open(path, "wb").write(bytes(raw))
    verify = trt.verify_pytree if verifier == "port" else jrt.verify_pytree
    err = trt.SnapshotIntegrityError if verifier == "port" \
        else jrt.SnapshotIntegrityError
    with pytest.raises(err):
        verify(path)


@pytest.mark.parametrize("verifier", ["port", "reference"])
def test_verify_pytree_detects_truncation(verifier, tmp_path):
    path = str(tmp_path / "t.npz")
    trt.save_pytree(path, {"w": np.arange(1024, dtype=np.float32)})
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) // 2])
    verify = trt.verify_pytree if verifier == "port" else jrt.verify_pytree
    err = trt.SnapshotIntegrityError if verifier == "port" \
        else jrt.SnapshotIntegrityError
    with pytest.raises(err, match="unreadable"):
        verify(path)


def test_verify_pytree_legacy_files_still_pass(tmp_path):
    path = str(tmp_path / "legacy.npz")
    np.savez(path, **{"d:w": np.ones(3, np.float32)})
    assert trt.verify_pytree(path) == "legacy"


def _store_run(tp, store, epochs=6, **kw):
    return te.solve(tp, backend="sparse_jnp", p=4, epochs=epochs, eta0=0.5,
                    eval_every=2, seed=1, checkpoint_every=2, store=store,
                    device="cpu", **kw)


def test_store_retention_gc(tmp_path):
    _, tp = _pair()
    store = trt.SnapshotStore(str(tmp_path), keep_last=2, keep_every=4)
    te.solve(tp, backend="sparse_jnp", p=4, epochs=12, eta0=0.5, seed=1,
             checkpoint_every=2, store=store, device="cpu")
    assert store.epochs() == [4, 8, 10, 12]
    with pytest.raises(ValueError, match="keep_last"):
        trt.SnapshotStore(str(tmp_path), keep_last=0)


@pytest.mark.parametrize("corruption", ["bitflip", "truncate", "delete"])
def test_corruption_matrix_latest_valid_wins(corruption, tmp_path):
    """A corrupt latest snapshot is quarantined and the next older valid
    one restores; resuming from it still equals the uninterrupted run."""
    _, tp = _pair()
    ref = te.solve(tp, backend="sparse_jnp", p=4, epochs=8, eta0=0.5,
                   eval_every=2, seed=1, device="cpu")
    store = trt.SnapshotStore(str(tmp_path))
    _store_run(tp, store)
    path = store.path(6)
    if corruption == "bitflip":
        raw = bytearray(open(path, "rb").read())
        raw[len(raw) // 2] ^= 0x01
        open(path, "wb").write(bytes(raw))
    elif corruption == "truncate":
        raw = open(path, "rb").read()
        open(path, "wb").write(raw[: len(raw) - 64])
    else:
        os.remove(path)
    snap = store.load()
    assert snap.epochs_done == 4
    if corruption != "delete":
        assert [e for e, _ in store.quarantined] == [6]
        assert os.path.exists(os.path.join(str(tmp_path), "quarantine",
                                           os.path.basename(path)))
    res = trt.resume(tp, store, epochs=8, device="cpu")
    assert torch.equal(res.w, ref.w) and torch.equal(res.alpha, ref.alpha)
    assert res.history == ref.history


# ---------------------------------------------------- saves and resume ----

MATRIX = [(b, s) for b in ("sparse_jnp", "sparse_bucketed_jnp", "dense_jnp")
          for s in ("cyclic", "random", "lpt")]


def _port_schedule(schedule, epochs, p=4, seed=7):
    """The port's schedule for a reference run: random replays the
    reference's jax.random permutations through fixed_schedule."""
    if schedule != "random":
        return schedule
    _, perms = jsched.get_schedule("random").draw(
        jax.random.PRNGKey(seed), 0, epochs, p)
    return tsched.fixed_schedule(np.asarray(perms))


@pytest.mark.parametrize("backend,schedule", MATRIX)
def test_store_saves_match_reference(backend, schedule, tmp_path):
    jp, tp = _pair(skewed=backend == "sparse_bucketed_jnp")
    kw = dict(backend=backend, p=4, epochs=6, eta0=0.5, eval_every=3,
              seed=7, checkpoint_every=2)
    js = jrt.SnapshotStore(str(tmp_path / "j"))
    ts = trt.SnapshotStore(str(tmp_path / "t"))
    je.solve(jp, schedule=schedule, store=js, **kw)
    te.solve(tp, schedule=_port_schedule(schedule, 6), store=ts,
             device="cpu", **kw)
    assert ts.epochs() == js.epochs() == [2, 4, 6]
    for ep in js.epochs():
        a, b = ts.load(ep), js.load(ep)
        assert a.epochs_done == b.epochs_done == ep
        cfg_t, cfg_j = dict(a.config), dict(b.config)
        if schedule == "random":
            assert cfg_t.pop("schedule") == "fixed"
            cfg_j.pop("schedule")
        assert cfg_t == cfg_j
        _state_close(a.state, b.state)
        assert [h["epoch"] for h in a.history] == \
            [h["epoch"] for h in b.history]
        # the port's key is its generator's state, as uint8
        assert a.key.dtype == np.uint8 and b.key.dtype == np.uint32


@pytest.mark.parametrize("backend,schedule", MATRIX)
def test_resume_bit_identical_in_the_port(backend, schedule, tmp_path):
    _, tp = _pair(skewed=backend == "sparse_bucketed_jnp")
    kw = dict(backend=backend, schedule=schedule, p=4, eta0=0.5,
              eval_every=2, seed=7, device="cpu")
    ref = te.solve(tp, epochs=8, **kw)
    store = trt.SnapshotStore(str(tmp_path))
    te.solve(tp, epochs=4, checkpoint_every=4, store=store, **kw)
    res = trt.resume(tp, store, epochs=8, device="cpu")
    assert (res.w - ref.w).abs().max().item() == 0.0
    assert (res.alpha - ref.alpha).abs().max().item() == 0.0
    assert res.history == ref.history
    _state_equal(res.state, ref.state)


@pytest.mark.parametrize("backend", ["sparse_jnp", "dense_jnp"])
def test_reference_snapshot_resumes_in_the_port(backend, tmp_path):
    jp, tp = _pair()
    kw = dict(backend=backend, p=4, eta0=0.5, eval_every=2, seed=7)
    store = str(tmp_path)
    je.solve(jp, epochs=4, checkpoint_every=4,
             store=jrt.SnapshotStore(store), **kw)
    j_res = jrt.resume(jp, jrt.SnapshotStore(store), epochs=8,
                       keep_checkpointing=False)
    t_res = trt.resume(tp, trt.SnapshotStore(store), epochs=8,
                       keep_checkpointing=False, device="cpu")
    np.testing.assert_allclose(t_res.w.numpy(), np.asarray(j_res.w), **TOL)
    np.testing.assert_allclose(t_res.alpha.numpy(), np.asarray(j_res.alpha),
                               **TOL)
    assert [h["epoch"] for h in t_res.history] == [2, 4, 6, 8]


def test_port_snapshot_resumes_in_the_reference(tmp_path):
    jp, tp = _pair()
    kw = dict(backend="sparse_jnp", p=4, eta0=0.5, eval_every=2, seed=7)
    store = str(tmp_path)
    te.solve(tp, epochs=4, checkpoint_every=4,
             store=trt.SnapshotStore(store), device="cpu", **kw)
    snap = jrt.SnapshotStore(store).load()
    assert snap.epochs_done == 4 and np.asarray(snap.key).dtype == np.uint8
    j_res = jrt.resume(jp, jrt.SnapshotStore(store), epochs=8,
                       keep_checkpointing=False)
    t_res = trt.resume(tp, trt.SnapshotStore(store), epochs=8,
                       keep_checkpointing=False, device="cpu")
    np.testing.assert_allclose(t_res.w.numpy(), np.asarray(j_res.w), **TOL)


def test_random_resume_refuses_a_jax_key(tmp_path):
    jp, tp = _pair()
    store = str(tmp_path)
    je.solve(jp, backend="sparse_jnp", schedule="random", p=4, epochs=2,
             eta0=0.5, seed=7, checkpoint_every=2,
             store=jrt.SnapshotStore(store))
    with pytest.raises(ValueError, match=r"uint32\[2\].*jax.random"):
        trt.resume(tp, trt.SnapshotStore(store), epochs=4, device="cpu")


def test_solve_checkpoint_wiring_and_validation(tmp_path):
    _, tp = _pair()
    store = trt.SnapshotStore(str(tmp_path))
    with pytest.raises(ValueError, match="checkpoint_every"):
        te.solve(tp, p=2, epochs=2, store=store, device="cpu")
    with pytest.raises(ValueError, match="checkpoint_every"):
        te.solve(tp, p=2, epochs=2, checkpoint_every=-1, device="cpu")
    res = te.solve(tp, backend="dense_jnp", p=4, epochs=6, eta0=0.5,
                   eval_every=3, checkpoint_every=2, store=store, seed=1,
                   device="cpu")
    assert store.epochs() == [2, 4, 6]
    final = store.load()
    assert torch.equal(final.state.w_grid.reshape(-1)[:60], res.w)
    assert [h["epoch"] for h in final.history] == [3, 6]
    with pytest.raises(ValueError, match="reshard"):
        te.solve(tp, backend="dense_jnp", p=2, epochs=8,
                 init=store.load(4), device="cpu")
    with pytest.raises(ValueError, match="ONE dataset"):
        trt.resume(_pair(m=32, d=24)[1], store, epochs=8, device="cpu")


def test_runtime_ring_names_raise():
    """The four supervisor names, which raised NotImplementedError until
    the ring was ported, now resolve to ``runtime.supervisor``'s objects,
    and the package exports the reference's names."""
    from repro_torch.runtime import supervisor
    for name in ("Supervisor", "FaultEvent", "make_fault_plan",
                 "periodic_crashes"):
        assert getattr(trt, name) is getattr(supervisor, name)
    assert set(trt.__all__) == set(jrt.__all__)


# ------------------------------------------------------------ layouts --

LAYOUTS = ["sparse", "bucketed", "dense"]


def _grids(layout, p, skewed=True):
    jp, tp = _pair(skewed=skewed)
    if layout == "dense":
        return je.make_grid_data(jp, p), te.make_grid_data(tp, p)
    jb = {"sparse": jformat.make_sparse_grid_data,
          "bucketed": jformat.make_bucketed_grid_data}[layout]
    tb = {"sparse": tformat.make_sparse_grid_data,
          "bucketed": tformat.make_bucketed_grid_data}[layout]
    return jb(jp, p), tb(tp, p, device="cpu")


def _fields_equal(t, j):
    """Every field of two grids of one layout equal, dtypes included."""
    assert type(t).__name__ == type(j).__name__
    for name in j._fields:
        a, b = getattr(t, name), getattr(j, name)
        if isinstance(b, tuple):
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                assert _np(x).dtype == np.asarray(y).dtype, name
                np.testing.assert_array_equal(_np(x), np.asarray(y),
                                              err_msg=name)
        elif b is None or isinstance(b, int):
            assert a == b, name
        else:
            assert _np(a).dtype == np.asarray(b).dtype, name
            np.testing.assert_array_equal(_np(a), np.asarray(b),
                                          err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_grid_to_csr_matches_reference(layout):
    j, t = _grids(layout, 4)
    (cj, yj), (ct, yt) = jformat.grid_to_csr(j, 120, 60), \
        tformat.grid_to_csr(t, 120, 60)
    for f in ("indptr", "indices", "values"):
        assert getattr(ct, f).dtype == getattr(cj, f).dtype
        np.testing.assert_array_equal(getattr(ct, f), getattr(cj, f))
    assert ct.shape == cj.shape
    np.testing.assert_array_equal(yt, np.asarray(yj))


@pytest.mark.parametrize("layout", ["sparse", "bucketed"])
@pytest.mark.parametrize("p,p_new", [(4, 2), (2, 4), (4, 4), (4, 1)])
def test_regrid_direct_matches_reference(layout, p, p_new):
    j, t = _grids(layout, p)
    gj = jformat.regrid_direct(j, 120, 60, p_new, 2)
    gt = tformat.regrid_direct(t, 120, 60, p_new, 2)
    assert gj is not None and gt is not None
    _fields_equal(gt, gj)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("p_new", [2, 3])
def test_retile_matches_reference(layout, p_new):
    """p 4 -> 2 (direct for packed layouts) and 4 -> 3 (the padded sizes
    disagree: the CSR round trip), dense through the round trip."""
    j, t = _grids(layout, 4)
    _fields_equal(t_retile(t, 120, 60, p_new),
                  jrt.retile(j, 120, 60, p_new))


@pytest.mark.parametrize("p_new", [2, 3, 4, 8])
def test_reshard_state_matches_reference(p_new):
    rng = np.random.default_rng(3)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in ((4, 15), (4, 15), (4, 30), (4, 30))]
    ts = trt.reshard_state(TState(*map(torch.tensor, arrs), epoch=3),
                           120, 60, p_new)
    js = jrt.reshard_state(JState(*map(jax.numpy.asarray, arrs),
                                  epoch=jax.numpy.int32(3)), 120, 60, p_new)
    for f in ("w_grid", "gw_grid", "alpha", "ga"):
        np.testing.assert_array_equal(_np(getattr(ts, f)),
                                      np.asarray(getattr(js, f)))
    assert ts.epoch == 3


@pytest.mark.parametrize("backend", ["sparse_jnp", "sparse_bucketed_jnp"])
def test_reshard_identity_is_bit_identical(backend, tmp_path):
    _, tp = _pair(skewed=backend == "sparse_bucketed_jnp")
    kw = dict(backend=backend, p=4, eta0=0.5, eval_every=2, seed=7,
              device="cpu")
    ref = te.solve(tp, epochs=8, **kw)
    store = trt.SnapshotStore(str(tmp_path))
    te.solve(tp, epochs=4, checkpoint_every=4, store=store, **kw)
    snap, _ = trt.reshard(store.load(), 4)
    res = te.solve(tp, epochs=8, init=snap, **kw)
    assert (res.w - ref.w).abs().max().item() == 0.0
    assert (res.alpha - ref.alpha).abs().max().item() == 0.0


def test_reshard_p4_to_p2_continues_on_retiled_data(tmp_path):
    jp, tp = _pair()
    grid = tformat.make_sparse_grid_data(tp, 4, device="cpu")
    dkw = dict(loss_name="hinge", reg_name="l2", lam=1e-3, m=120, d=60,
               eta0=0.5, seed=7, device="cpu", backend="sparse_jnp")
    store = trt.SnapshotStore(str(tmp_path))
    te.solve(grid, epochs=4, checkpoint_every=4, store=store, **dkw)
    snap2, grid2 = trt.reshard(store.load(), 2, data=grid)
    _fields_equal(grid2, jformat.make_sparse_grid_data(jp, 2))
    assert snap2.config["p"] == 2 and tuple(snap2.state.w_grid.shape) == (
        2, 30)
    res = te.solve(grid2, p=2, epochs=8, init=snap2, **dkw)
    assert torch.isfinite(res.w).all() and res.state.epoch == 8


# ------------------------------------------------------- in-place hazard --


@pytest.mark.parametrize("async_writes", [False, True],
                         ids=["sync", "async"])
def test_saved_snapshot_survives_the_next_chunk(async_writes, tmp_path):
    """The port's steps overwrite the state tensors in place: a snapshot
    saved at epoch 2 must hold epoch 2's state after epochs 3-6 ran."""
    _, tp = _pair()
    at2 = te.solve(tp, backend="sparse_jnp", p=4, epochs=2, eta0=0.5,
                   seed=1, device="cpu")
    store = trt.SnapshotStore(str(tmp_path), async_writes=async_writes)
    saved = []

    class Spy:
        def save(self, **kw):
            saved.append(kw["state"])
            return store.save(**kw)

        def flush(self):
            store.flush()

        def load(self, *a):
            return store.load(*a)

    res = te.solve(tp, backend="sparse_jnp", p=4, epochs=6, eta0=0.5,
                   seed=1, checkpoint_every=2, store=Spy(), device="cpu")
    assert saved[0].w_grid is res.state.w_grid     # the live tensors
    _state_equal(store.load(2).state, at2.state)
    assert not torch.equal(store.load(2).state.w_grid, res.state.w_grid)


def test_init_is_not_mutated_by_the_resumed_run(tmp_path):
    _, tp = _pair()
    kw = dict(backend="sparse_jnp", p=4, eta0=0.5, seed=1, device="cpu")
    store = trt.SnapshotStore(str(tmp_path))
    te.solve(tp, epochs=2, checkpoint_every=2, store=store, **kw)
    snap = store.load()
    before = {f: getattr(snap.state, f).clone()
              for f in ("w_grid", "gw_grid", "alpha", "ga")}
    res = te.solve(tp, epochs=6, init=snap, **kw)
    for f, v in before.items():
        assert torch.equal(getattr(snap.state, f), v), f
    # an in-memory snapshot of a live run's state survives as well
    live = trt.DSOSnapshot(res.state, snap.key, 6, (), dict(snap.config))
    w6 = res.state.w_grid.clone()
    te.solve(tp, epochs=8, init=live, **kw)
    assert torch.equal(res.state.w_grid, w6)
