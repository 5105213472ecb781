"""The port's engine against the JAX reference (CPU, small sizes).

``solve`` trajectories (history, w, alpha) within 1e-5 of the reference's
for {sparse_jnp, sparse_bucketed_jnp} x {cyclic, lpt} x six (loss, reg)
pairs; the reference's ``random`` permutations replayed through
``fixed_schedule``; ``auto`` resolving to the reference's layout, and to
the kernel backend only for data on a CUDA device (decided from the
device type, without a card), for the dense layout too; a JAX run's
state carried across by ``state_from_arrays`` continuing one more epoch
in the port; and the corners: ``use_adagrad=False`` on ``sparse_jnp`` and
``dense_jnp`` for the six pairs, ``eval_every=2`` over 5 epochs, and the
evaluation hooks ``make_csr_primal_eval`` and ``pd_gap_eval_hook`` against
the reference's; and the corners of p, shape, alpha0 and row_batches
(``CORNERS``) on ``sparse_jnp`` and ``sparse_bucketed_jnp`` (the dense
corners are in ``tests/test_torch_dense.py``).
"""

import numpy as np
import pytest
import torch

import repro.data.synthetic as jsyn
import repro.engine as je
import repro_torch.data.synthetic as tsyn
import repro_torch.engine as te
from repro.engine import schedules as jsched
from repro.sparse import format as jformat
from repro_torch.engine import schedules as tsched
from repro_torch.sparse import format as tformat

LOSS_REG_PAIRS = [("hinge", "l2"), ("hinge", "l1"), ("logistic", "l2"),
                  ("logistic", "l1"), ("square", "l2"), ("square", "l1")]
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(loss, reg, seed=1, skewed=False):
    if loss == "square":
        kw = dict(m=120, d=60, density=0.15, seed=seed, reg=reg)
        return (jsyn.make_regression(**kw),
                tsyn.make_regression(**kw, device="cpu"))
    kw = dict(m=120, d=60, density=0.15, loss=loss, lam=1e-3, seed=seed,
              reg=reg)
    if skewed:
        kw["alpha"] = 1.3
        return (jsyn.make_skewed_classification(**kw),
                tsyn.make_skewed_classification(**kw, device="cpu"))
    return (jsyn.make_classification(**kw),
            tsyn.make_classification(**kw, device="cpu"))


def _assert_same_run(r_j, r_t):
    np.testing.assert_allclose(r_t.w.numpy(), np.asarray(r_j.w), **TOL)
    np.testing.assert_allclose(r_t.alpha.numpy(), np.asarray(r_j.alpha),
                               **TOL)
    assert len(r_t.history) == len(r_j.history)
    for h_t, h_j in zip(r_t.history, r_j.history):
        assert h_t.keys() == h_j.keys() and h_t["epoch"] == h_j["epoch"]
        for k in h_j:
            if np.isfinite(h_j[k]):
                np.testing.assert_allclose(h_t[k], h_j[k], err_msg=k, **TOL)
            else:
                assert h_t[k] == h_j[k], k


@pytest.mark.parametrize("schedule", ["cyclic", "lpt"])
@pytest.mark.parametrize("backend", ["sparse_jnp", "sparse_bucketed_jnp"])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_solve_matches_reference(loss, reg, backend, schedule):
    jp, tp = _pair(loss, reg, skewed=backend == "sparse_bucketed_jnp")
    kw = dict(backend=backend, schedule=schedule, p=4, epochs=3, eta0=0.5,
              row_batches=3)
    _assert_same_run(je.solve(jp, **kw), te.solve(tp, device="cpu", **kw))


@pytest.mark.parametrize("backend", ["sparse_jnp", "sparse_bucketed_jnp"])
def test_random_schedule_replayed_through_fixed(backend):
    jp, tp = _pair("hinge", "l2", seed=2)
    import jax
    _, perms = jsched.get_schedule("random").draw(jax.random.PRNGKey(7), 0,
                                                 3, 4)
    r_j = je.solve(jp, backend=backend, schedule="random", seed=7, p=4,
                   epochs=3, eta0=0.5)
    r_t = te.solve(tp, backend=backend, p=4, epochs=3, eta0=0.5,
                   schedule=tsched.fixed_schedule(np.asarray(perms)),
                   device="cpu")
    _assert_same_run(r_j, r_t)


def test_port_random_schedule_is_valid_and_chunk_invariant():
    sched = tsched.get_schedule("random")
    _, whole = sched.draw(torch.Generator().manual_seed(3), 0, 5, 4)
    g = torch.Generator().manual_seed(3)
    g, a = sched.draw(g, 0, 2, 4)
    _, b = sched.draw(g, 2, 3, 4)
    assert torch.equal(torch.cat([a, b]), whole)
    assert whole.dtype == torch.int32
    assert all(sorted(row.tolist()) == [0, 1, 2, 3]
               for row in whole.reshape(-1, 4))


def test_deterministic_schedules_equal_reference():
    assert np.array_equal(tsched.cyclic_perms(3, 5).numpy(),
                          np.asarray(jsched.cyclic_perms(3, 5)))
    cost = np.random.default_rng(0).integers(1, 100, (6, 6))
    assert np.array_equal(tsched.lpt_latin_square(cost),
                          jsched.lpt_latin_square(cost))
    for name in ("cyclic", "lpt"):
        ctx = {"tile_nnz": cost} if name == "lpt" else {}
        _, t = tsched.get_schedule(name).draw(None, 2, 3, 6, **ctx)
        _, j = jsched.get_schedule(name).draw(None, 2, 3, 6, **ctx)
        assert np.array_equal(t.numpy(), np.asarray(j))
    with pytest.raises(ValueError, match="permutation"):
        tsched.fixed_schedule([[0, 0], [1, 0]])    # two workers on block 0


@pytest.mark.parametrize("kind,layout", [("uniform", "sparse"),
                                         ("skewed", "bucketed"),
                                         ("dense", "dense")])
def test_auto_resolves_like_reference_and_by_device_type(kind, layout):
    kw = dict(m=128, d=96, seed=0)
    if kind == "dense":
        jp = jsyn.make_dense_classification(**kw)
        tp = tsyn.make_dense_classification(**kw, device="cpu")
    elif kind == "skewed":
        kw.update(density=0.06, alpha=2.0)
        jp = jsyn.make_skewed_classification(**kw)
        tp = tsyn.make_skewed_classification(**kw, device="cpu")
    else:
        kw.update(density=0.06)
        jp = jsyn.make_classification(**kw)
        tp = tsyn.make_classification(**kw, device="cpu")
    j_be, _ = je.driver.resolve_backend_and_build(jp, "auto", 4, 1)
    assert j_be.layout == layout
    t_be, t_grid = te.resolve_backend_and_build(tp, "auto", 4, 1)
    assert t_be.name == j_be.name          # plain twin for CPU data
    assert t_be.layout == j_be.layout
    skew = (te.driver.tile_k_skew(te.driver.problem_k_per_tile(tp, 4)))
    dens = te.driver.density(tp)
    on_card = te.resolve_backend("auto", dens, k_skew=skew,
                                 device_type="cuda")
    assert on_card.layout == j_be.layout
    assert on_card.name == {"dense": "dense_pallas_block",
                            "sparse": "sparse_pallas",
                            "bucketed": "sparse_bucketed_pallas"}[j_be.layout]
    for kernel in ("jnp", "pallas"):
        assert te.resolve_backend_for_layout(
            "auto", j_be.layout, device_type={"jnp": "cpu",
                                              "pallas": "cuda"}[kernel]) \
            == te.resolve_backend_for_layout(kernel, j_be.layout)


def test_state_carried_across_continues_like_the_reference():
    jp, tp = _pair("logistic", "l2", seed=3, skewed=True)
    kw = dict(backend="sparse_bucketed_jnp", p=4, eta0=0.5, row_batches=3,
              alpha0=0.0005, eval_hook=None)
    j2 = je.solve(jp, epochs=2, **kw)
    j3 = je.solve(jp, epochs=3, **kw)
    arrays = {k: np.asarray(v) for k, v in j2.state._asdict().items()}
    state = te.state_from_arrays(arrays, device="cpu")
    assert state.epoch == 2
    grid = te.driver.make_bucketed_grid_data(tp, 4, 3, device="cpu")
    lam, m, loss, reg, _, w_lo, w_hi = te.prob_meta(tp)
    state = te.run_epochs(grid, state, tsched.cyclic_perms(1, 4),
                          te.eta_schedule(0.5, 2, 1, True), lam, m, w_lo,
                          w_hi, backend="sparse_bucketed_jnp",
                          loss_name=loss, reg_name=reg, row_batches=3)
    assert state.epoch == 3
    for k in ("w_grid", "gw_grid", "alpha", "ga"):
        np.testing.assert_allclose(getattr(state, k).numpy(),
                                   np.asarray(getattr(j3.state, k)),
                                   err_msg=k, **TOL)


def test_tile_data_carried_across_equals_the_port_grid():
    jp, tp = _pair("hinge", "l1", seed=4, skewed=True)
    j_tile = je.as_tile_data(je.driver.make_bucketed_grid_data(jp, 4, 1))
    arrays = {k: (tuple(np.asarray(a) for a in v) if k == "arrays"
                  else np.asarray(v)) for k, v in j_tile._asdict().items()}
    t_tile = te.tile_data_from_arrays(arrays, device="cpu")
    mine = te.as_tile_data(te.driver.make_bucketed_grid_data(tp, 4, 1,
                                                             device="cpu"))
    assert t_tile.layout == mine.layout == "bucketed"
    for a, b in zip(t_tile.arrays, mine.arrays):
        assert torch.equal(a, b)
    for f in te.TileData._fields[1:]:
        assert torch.equal(getattr(t_tile, f), getattr(mine, f)), f
    r1 = te.solve(t_tile, backend="jnp", loss_name="hinge", reg_name="l1",
                  lam=1e-3, m=tp.m, d=tp.d, p=4, epochs=2, eta0=0.5,
                  device="cpu")
    r2 = te.solve(tp, backend="sparse_bucketed_jnp", p=4, epochs=2,
                  eta0=0.5, device="cpu")
    assert torch.equal(r1.w, r2.w) and torch.equal(r1.alpha, r2.alpha)


def test_sparse_pallas_backends_run_plain_on_cpu_data():
    _, tp = _pair("square", "l1", seed=5, skewed=False)
    kw = dict(p=4, epochs=2, eta0=0.5, row_batches=3, device="cpu")
    a = te.solve(tp, backend="sparse_pallas", **kw)
    b = te.solve(tp, backend="sparse_jnp", **kw)
    np.testing.assert_allclose(a.w.numpy(), b.w.numpy(), **TOL)
    np.testing.assert_allclose(a.alpha.numpy(), b.alpha.numpy(), **TOL)


def test_unported_options_and_backends_raise():
    """Every seam and backend of the reference's ``solve`` is ported: what
    still raises is a misuse of them (a store without checkpoint
    boundaries, telemetry without the chunked epochs, an unknown
    backend)."""
    _, tp = _pair("hinge", "l2")
    with pytest.raises(ValueError, match="checkpoint_every"):
        te.solve(tp, store=object(), device="cpu")
    with pytest.raises(ValueError, match="telemetry"):
        te.solve(tp, telemetry=object(), scan_epochs=False, device="cpu")
    for name in ("sparse_bucketed_jnp_switch",
                 "sparse_bucketed_pallas_switch"):
        assert te.get_backend(name).payload == "buckets"
    with pytest.raises(ValueError, match="unknown backend"):
        te.get_backend("no_such_backend")


# ---------------------------------------------------------- the corners --


@pytest.mark.parametrize("backend", ["sparse_jnp", "dense_jnp"])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_solve_without_adagrad_matches_reference(loss, reg, backend):
    jp, tp = _pair(loss, reg)
    kw = dict(backend=backend, p=4, epochs=3, eta0=0.5, row_batches=2,
              use_adagrad=False)
    _assert_same_run(je.solve(jp, **kw), te.solve(tp, device="cpu", **kw))


def test_eval_every_two_matches_reference():
    jp, tp = _pair("logistic", "l2", seed=4)
    kw = dict(backend="sparse_jnp", p=4, epochs=5, eta0=0.5, eval_every=2)
    r_j, r_t = je.solve(jp, **kw), te.solve(tp, device="cpu", **kw)
    assert [h["epoch"] for h in r_t.history] == [2, 4, 5]
    _assert_same_run(r_j, r_t)


@pytest.mark.parametrize("loss,reg", [("hinge", "l2"), ("logistic", "l1"),
                                      ("square", "l2")])
def test_eval_hooks_match_reference(loss, reg):
    """``make_csr_primal_eval`` (small chunks, so the nnz stream is cut
    into several with padding) and ``pd_gap_eval_hook`` at the same
    iterates in both packages."""
    jp, tp = _pair(loss, reg, seed=6)
    rng = np.random.default_rng(6)
    w = rng.normal(0, 0.1, tp.d).astype(np.float32)
    alpha = np.asarray(tp.y) * rng.uniform(0.05, 0.95, tp.m) \
        .astype(np.float32)
    X = tp.X.numpy()
    kw = dict(loss_name=loss, reg_name=reg, chunk_nnz=97)
    j_hook = je.make_csr_primal_eval(jformat.CSRMatrix.from_dense(X),
                                     np.asarray(jp.y), 1e-3, **kw)
    t_hook = te.make_csr_primal_eval(tformat.CSRMatrix.from_dense(X),
                                     tp.y.numpy(), 1e-3, **kw, device="cpu")
    got, want = t_hook(3, torch.from_numpy(w), None), j_hook(3, w, None)
    assert got.keys() == want.keys() and got["epoch"] == 3
    np.testing.assert_allclose(got["primal"], want["primal"], **TOL)
    got = te.pd_gap_eval_hook(tp)(2, torch.from_numpy(w),
                                  torch.from_numpy(alpha))
    want = je.pd_gap_eval_hook(jp)(2, w, alpha)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **TOL)


# Corners of the engine against the reference: p 1 (one processor), 3 and
# 5, which the shapes' m and d do not divide (padded rows and columns),
# m < d and m > d, a nonzero alpha0, and a second row batch with a
# trailing row.  (p, m, d, alpha0, row_batches)
CORNERS = [(p, m, d, a0, rb) for p in (1, 3, 5)
           for m, d in ((121, 61), (37, 200))
           for a0 in (0.0, 0.3) for rb in (1, 2)]


@pytest.mark.parametrize("backend", ["sparse_jnp", "sparse_bucketed_jnp"])
@pytest.mark.parametrize("p,m,d,alpha0,row_batches", CORNERS)
def test_solve_corners_match_reference(p, m, d, alpha0, row_batches,
                                       backend):
    """logistic/l2, cyclic, 2 epochs, eta0 0.5; skewed columns for the
    bucketed layout; w, alpha and the history within 1e-5."""
    kw = dict(m=m, d=d, density=0.15, loss="logistic", lam=1e-3, seed=3,
              reg="l2")
    if backend == "sparse_bucketed_jnp":
        jp = jsyn.make_skewed_classification(**kw, alpha=1.3)
        tp = tsyn.make_skewed_classification(**kw, alpha=1.3, device="cpu")
    else:
        jp = jsyn.make_classification(**kw)
        tp = tsyn.make_classification(**kw, device="cpu")
    run = dict(backend=backend, schedule="cyclic", p=p, epochs=2, eta0=0.5,
               alpha0=alpha0, row_batches=row_batches)
    _assert_same_run(je.solve(jp, **run), te.solve(tp, device="cpu", **run))
