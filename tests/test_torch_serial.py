"""The port's paper-exact serial solver, its legacy ``core`` runners and
the rest of the ``core`` math against the JAX reference (CPU, small
sizes).

``solve_serial`` and ``_serial_epochs`` replay the reference's
``jax.random.permutation`` visit orders and stay within 1e-5 of
``repro.engine.solve_serial`` for the six (loss, reg) pairs x
``use_adagrad`` x ``alpha0`` {0, 0.3} at the reference's sizes (m 120,
d 60); the plain serial epoch (one vectorised step per wave) equals the
literal loop bit for bit, and so does the plain step walked in the serial
kernel's round schedule (``serial_rounds``: its ordering properties, by
hypothesis and at the edges) at windows 1, 7 and 64; the kernel's plan
(``ops.serial_epoch_route``) stages phase 3s's shape and not real-sim's,
fits the card and refuses what no kernel takes; ``run_epoch`` equals one
epoch of ``run_epochs`` and ``solve(scan_epochs=False)`` equals
``scan_epochs=True``; ``run_dso_serial``, ``run_dso_grid`` (jnp / sparse / auto),
``run_dso_random`` (the reference's permutations replayed) and the
legacy epoch shims are within 1e-5 of the reference's;
``resolve_impl``, ``argmin_w``, ``stochastic_grads``, ``grads_tile``,
``core.adagrad``, ``core.schedule`` and ``warn_ragged_eval`` behave as
the reference's; the ``obs=`` seam raises; every entry module imports
first in a fresh interpreter.
"""

import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.adagrad as jada
import repro.core.dso as jdso
import repro.core.saddle as jsad
import repro.core.schedule as jsch
import repro.data.synthetic as jsyn
import repro.engine as je
import repro.engine.driver as jdrv
import repro_torch.core.adagrad as tada
import repro_torch.core.dso as tdso
import repro_torch.core.saddle as tsad
import repro_torch.core.schedule as tsch
import repro_torch.data.synthetic as tsyn
import repro_torch.engine as te
import repro_torch.engine.driver as tdrv
import repro_torch.sparse.format as tf
from repro.core.dso_async import run_dso_random as j_random
from repro.engine import schedules as jsched
from repro_torch.core.dso_async import run_dso_random as t_random
from repro_torch.core.losses import get_loss
from repro_torch.core.regularizers import get_regularizer
from repro_torch.engine import schedules as tsched
from repro_torch.kernels import dso_serial, ops
from _hypothesis_compat import given, settings, st

LOSS_REG_PAIRS = [("hinge", "l2"), ("hinge", "l1"), ("logistic", "l2"),
                  ("logistic", "l1"), ("square", "l2"), ("square", "l1")]
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(loss, reg, seed=1, m=120, d=60):
    if loss == "square":
        kw = dict(m=m, d=d, density=0.15, seed=seed, reg=reg)
        return (jsyn.make_regression(**kw),
                tsyn.make_regression(**kw, device="cpu"))
    kw = dict(m=m, d=d, density=0.15, loss=loss, lam=1e-3, seed=seed,
              reg=reg)
    return (jsyn.make_classification(**kw),
            tsyn.make_classification(**kw, device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _assert_same_run(t, j):
    """(w, alpha, history) of the port within 1e-5 of the reference's."""
    _close(t[0].numpy(), j[0])
    _close(t[1].numpy(), j[1])
    assert len(t[2]) == len(j[2])
    for h_t, h_j in zip(t[2], j[2]):
        assert h_t.keys() == h_j.keys() and h_t["epoch"] == h_j["epoch"]
        for k in h_j:
            if np.isfinite(h_j[k]):
                np.testing.assert_allclose(h_t[k], h_j[k], err_msg=k, **TOL)
            else:
                assert h_t[k] == h_j[k], k


def _jax_orders(seed, epochs, nnz):
    """The reference's visit orders: one split and permutation per epoch
    (``solve_serial``, driver.py:739-742)."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(epochs):
        key, sk = jax.random.split(key)
        out.append(np.asarray(jax.random.permutation(sk, nnz)))
    return np.stack(out)


def _replay(monkeypatch, orders):
    """Make the port's ``solve_serial`` visit ``orders`` in turn."""
    stream = iter(orders)
    monkeypatch.setattr(
        tdrv, "_draw_orders",
        lambda key, n, nnz: torch.as_tensor(
            np.stack([next(stream) for _ in range(n)])))


@pytest.mark.parametrize("alpha0", [0.0, 0.3])
@pytest.mark.parametrize("use_adagrad", [True, False])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_solve_serial_matches_reference(monkeypatch, loss, reg, use_adagrad,
                                        alpha0):
    jp, tp = _pair(loss, reg)
    kw = dict(epochs=3, eta0=0.5, seed=0, use_adagrad=use_adagrad,
              alpha0=alpha0, eval_every=2)
    nnz = int(np.count_nonzero(np.asarray(jp.X)))
    _replay(monkeypatch, _jax_orders(0, 3, nnz))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)   # ragged 3 / 2
        j = je.solve_serial(jp, **kw)
        t = te.solve_serial(tp, **kw, device="cpu")
    assert j.state is None and t.state is None
    assert [h["epoch"] for h in t.history] == [2, 3]
    _assert_same_run((t.w, t.alpha, t.history), (j.w, j.alpha, j.history))


def _serial_inputs(jp, tp, seed):
    """A mid-run state (w, alpha, gw, ga) and one epoch's order, the same
    numbers for both sides."""
    rng = np.random.default_rng(seed)
    ii, jj, vv = (np.asarray(a) for a in jdrv._coords(jp))
    t_ii, t_jj, t_vv = tdrv._coords(tp)
    assert np.array_equal(t_ii.numpy(), ii) and np.array_equal(
        t_jj.numpy(), jj) and np.array_equal(t_vv.numpy(), vv)
    box = jp.loss.w_box(jp.lam) if jp.loss.w_box is not None else 1.0
    w = rng.uniform(-0.5, 0.5, jp.d).astype(np.float32) * np.float32(
        min(box, 1.0))
    alpha = np.asarray(jsad.project_alpha(
        jp, jnp.asarray(rng.uniform(-1, 1, jp.m).astype(np.float32))))
    gw = rng.uniform(0, 1, jp.d).astype(np.float32)
    ga = rng.uniform(0, 1, jp.m).astype(np.float32)
    order = rng.permutation(ii.size)
    return (t_ii, t_jj, t_vv), (ii, jj, vv), (w, alpha, gw, ga), order


@pytest.mark.parametrize("use_adagrad", [True, False])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_serial_epochs_replay_reference(loss, reg, use_adagrad):
    jp, tp = _pair(loss, reg, seed=2)
    t_c, j_c, st, order = _serial_inputs(jp, tp, seed=5)
    lo, hi = (-np.inf, np.inf) if jp.loss.w_box is None else \
        (-jp.loss.w_box(jp.lam), jp.loss.w_box(jp.lam))
    perms, etas = np.stack([order, order[::-1]]), [0.5, 0.25]
    j_out = jdrv._serial_epochs(
        *(jnp.asarray(a) for a in j_c), jnp.asarray(perms),
        jnp.asarray(etas, jnp.float32), *(jnp.asarray(a) for a in st),
        jp.y, jp.row_nnz, jp.col_nnz, jnp.float32(jp.lam),
        jnp.float32(lo), jnp.float32(hi), loss_name=loss, reg_name=reg,
        m=jp.m, use_adagrad=use_adagrad)
    t_st = [torch.tensor(a) for a in st]
    lam_f, _, _, _, _, w_lo, w_hi = te.prob_meta(tp)
    t_out = tdrv._serial_epochs(
        *t_c, perms, etas, *t_st, tp.y, tp.row_nnz, tp.col_nnz, lam_f,
        w_lo, w_hi, loss_name=loss, reg_name=reg, m=float(tp.m),
        use_adagrad=use_adagrad)
    for got, want, same in zip(t_out, j_out, t_st):
        assert got is same                       # updated in place
        _close(got.numpy(), want)


def _literal_epoch(ii, jj, vv, order, w, alpha, gw, ga, y, rn, cn, scal,
                   loss_name, reg_name, use_adagrad):
    """The serial epoch as the loop it is, one nonzero at a time, with
    the plain version's arithmetic."""
    eta, lam, m, w_lo, w_hi = scal
    inv_m, fma = dso_serial.serial_inv_m(m), dso_serial.fma
    loss, reg = get_loss(loss_name), get_regularizer(reg_name)
    for e in order.tolist():
        i, j = int(ii[e]), int(jj[e])
        x = vv[e:e + 1]
        wj, ai, yi = w[j:j + 1].clone(), alpha[i:i + 1].clone(), y[i:i + 1]
        g_w = fma(-(ai * x), inv_m, lam * reg.grad(wj) / cn[j:j + 1])
        g_a = fma(-(wj * x), inv_m,
                  -dso_serial.dual_grad(loss_name, ai, yi)
                  / (m * rn[i:i + 1]))
        if use_adagrad:
            gw[j:j + 1] = fma(g_w, g_w, gw[j:j + 1])
            ga[i:i + 1] = fma(g_a, g_a, ga[i:i + 1])
            w_new = fma(-(eta * g_w), torch.rsqrt(gw[j:j + 1] + 1e-8), wj)
            a_new = fma(eta * g_a, torch.rsqrt(ga[i:i + 1] + 1e-8), ai)
        else:
            w_new, a_new = fma(g_w, -eta, wj), fma(g_a, eta, ai)
        w[j:j + 1] = torch.clamp(w_new, w_lo, w_hi)
        alpha[i:i + 1] = loss.project_alpha(a_new, yi)


@pytest.mark.parametrize("use_adagrad", [True, False])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_plain_serial_epoch_equals_the_loop_bit_for_bit(loss, reg,
                                                        use_adagrad):
    jp, tp = _pair(loss, reg, seed=4, m=40, d=20)
    t_c, _, st, order = _serial_inputs(jp, tp, seed=6)
    order = torch.as_tensor(order, dtype=torch.int32)
    lam_f, _, _, _, _, w_lo, w_hi = te.prob_meta(tp)
    scal = (0.5, lam_f, float(tp.m), w_lo, w_hi)
    a = [torch.tensor(x) for x in st]
    b = [torch.tensor(x) for x in st]
    before = ops.launch_counts()
    ops.dso_serial_epoch(*t_c, order, *a, tp.y, tp.row_nnz, tp.col_nnz,
                         scal, loss_name=loss, reg_name=reg,
                         use_adagrad=use_adagrad)
    assert ops.launch_counts() == before        # the plain path launches none
    _literal_epoch(*t_c, order, *b, tp.y, tp.row_nnz, tp.col_nnz, scal,
                   loss, reg, use_adagrad)
    for x, z in zip(a, b):
        assert torch.equal(x, z)


def test_serial_waves_are_the_dependency_depth():
    rows, cols = [0, 1, 0, 2, 1, 3], [0, 1, 1, 2, 0, 2]
    assert dso_serial.serial_waves(rows, cols, 4, 3) == [0, 0, 1, 0, 1, 1]
    assert dso_serial.serial_waves([], [], 1, 1) == []


def _check_rounds(rows, cols, m, d, window):
    """``serial_rounds``' schedule: distinct rows and columns within a
    round, rounds rising along each row and column in visit order, each
    window's rounds after the window before's, and ``serial_waves`` when
    one window holds the whole sequence."""
    rounds = dso_serial.serial_rounds(rows, cols, window)
    assert len(rounds) == len(rows)
    by_round = {}
    for i, j, r in zip(rows, cols, rounds):
        seen = by_round.setdefault(r, (set(), set()))
        assert i not in seen[0] and j not in seen[1]
        seen[0].add(i)
        seen[1].add(j)
    last_row, last_col = {}, {}
    for i, j, r in zip(rows, cols, rounds):
        assert r > last_row.get(i, -1) and r > last_col.get(j, -1)
        last_row[i] = last_col[j] = r
    for start in range(window, len(rows), window):
        assert min(rounds[start:start + window]) > max(rounds[:start])
    assert sorted(set(rounds)) == list(range(len(set(rounds))))
    if window >= len(rows):
        assert rounds == dso_serial.serial_waves(rows, cols, m, d)
    return rounds


@settings(max_examples=40, deadline=None, database=None)
@given(st.data())
def test_serial_rounds_schedule_property(data):
    m, d = data.draw(st.integers(1, 6)), data.draw(st.integers(1, 6))
    nnz = data.draw(st.integers(0, 60))
    rows = data.draw(st.lists(st.integers(0, m - 1), min_size=nnz,
                              max_size=nnz))
    cols = data.draw(st.lists(st.integers(0, d - 1), min_size=nnz,
                              max_size=nnz))
    _check_rounds(rows, cols, m, d, data.draw(st.integers(1, 70)))


@pytest.mark.parametrize("m,d,nnz,window", [
    (3, 4, 0, 5),            # no step
    (1, 5, 23, 4),           # one row: every step its own round
    (5, 1, 23, 4),           # one column
    (4, 4, 23, 5),           # a ragged last window (3 steps)
    (4, 4, 23, 23),          # one window: the waves
    (6, 5, 40, 1)])          # a window per step: the loop
def test_serial_rounds_schedule_edges(m, d, nnz, window):
    rng = np.random.default_rng(m * 100 + d * 10 + window)
    rows = rng.integers(0, m, nnz).tolist()
    cols = rng.integers(0, d, nnz).tolist()
    rounds = _check_rounds(rows, cols, m, d, window)
    if min(m, d) == 1 or window == 1:
        assert rounds == list(range(nnz))


@pytest.mark.parametrize("window", [1, 7, 64])
@pytest.mark.parametrize("use_adagrad", [True, False])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_plain_epoch_in_kernel_rounds_is_the_loop(monkeypatch, loss, reg,
                                                  use_adagrad, window):
    """The plain step walked in the rounds kernel's schedule
    (``serial_rounds`` in place of the waves) is the literal loop bit for
    bit, and the reference's ``_serial_epochs`` within 1e-5."""
    jp, tp = _pair(loss, reg, seed=4, m=40, d=20)
    t_c, j_c, st0, order = _serial_inputs(jp, tp, seed=6)
    calls = []

    def rounds(rows, cols, m, d):
        calls.append(len(rows))
        return dso_serial.serial_rounds(rows, cols, window)

    monkeypatch.setattr(dso_serial, "serial_waves", rounds)
    lam_f, _, _, _, _, w_lo, w_hi = te.prob_meta(tp)
    scal = (0.5, lam_f, float(tp.m), w_lo, w_hi)
    a = [torch.tensor(x) for x in st0]
    b = [torch.tensor(x) for x in st0]
    t_order = torch.as_tensor(order, dtype=torch.int32)
    ops.dso_serial_epoch(*t_c, t_order, *a, tp.y, tp.row_nnz, tp.col_nnz,
                         scal, loss_name=loss, reg_name=reg,
                         use_adagrad=use_adagrad)
    assert calls == [order.size]
    _literal_epoch(*t_c, t_order, *b, tp.y, tp.row_nnz, tp.col_nnz, scal,
                   loss, reg, use_adagrad)
    for x, z in zip(a, b):
        assert torch.equal(x, z)
    lo, hi = (-np.inf, np.inf) if jp.loss.w_box is None else \
        (-jp.loss.w_box(jp.lam), jp.loss.w_box(jp.lam))
    j_out = jdrv._serial_epochs(
        *(jnp.asarray(v) for v in j_c), jnp.asarray(order[None]),
        jnp.asarray([0.5], jnp.float32), *(jnp.asarray(v) for v in st0),
        jp.y, jp.row_nnz, jp.col_nnz, jnp.float32(jp.lam),
        jnp.float32(lo), jnp.float32(hi), loss_name=loss, reg_name=reg,
        m=jp.m, use_adagrad=use_adagrad)
    for got, want in zip(a, j_out):
        _close(got.numpy(), want)


H100_SMEM = 232_448          # an H100's opt-in shared memory per block
LIMITS = dict(smem_limit=H100_SMEM, max_cluster=16)


def test_serial_epoch_route_stages_phase_3s_not_real_sim():
    small = ops.serial_epoch_route(2000, 500, 50_000, **LIMITS)
    assert small.staged and small.cluster == 1
    assert small.smem == dso_serial.serial_smem(2000, 500, small.slots,
                                                small.threads, True)
    big = ops.serial_epoch_route(72_309, 20_958, 3_683_302, **LIMITS)
    assert not big.staged and big.cluster == 16
    assert big.smem == dso_serial.serial_smem(72_309, 20_958, big.slots,
                                              big.threads, False)


@pytest.mark.parametrize("max_cluster", [1, 8, 16])
@pytest.mark.parametrize("smem_limit", [49_152, 101_376, H100_SMEM])
@pytest.mark.parametrize("m,d,nnz", [(2000, 500, 50_000), (0, 0, 0),
                                     (1, 1, 1), (9000, 500, 200_000),
                                     (72_309, 20_958, 3_683_302)])
def test_serial_epoch_route_fits_the_card(m, d, nnz, smem_limit,
                                          max_cluster):
    plan = ops.serial_epoch_route(m, d, nnz, smem_limit=smem_limit,
                                  max_cluster=max_cluster)
    assert plan.window == plan.slots * plan.threads * plan.cluster
    assert plan.window % plan.threads == 0
    assert plan.slots in dso_serial.SLOTS and plan.threads % 32 == 0
    assert plan.threads <= dso_serial.max_threads(plan.slots)
    assert 1 <= plan.cluster <= max_cluster
    assert plan.smem == dso_serial.serial_smem(m, d, plan.slots,
                                               plan.threads, plan.staged)
    assert plan.smem <= smem_limit
    assert plan.staged == (dso_serial.serial_smem(
        m, d, *dso_serial.STAGED_PLAN[::-1], True) <= smem_limit)
    assert plan.cluster == 1 if plan.staged else \
        plan.cluster == min(16, max_cluster)


@pytest.mark.parametrize("threads,slots,cluster", [
    (1024, 3, None), (1024, 32, None), (1024, 8, None), (16, 4, None),
    (48, 2, None), (512, 16, None), (1024, 1, 17), (1024, 1, 0)])
def test_serial_plan_refuses_what_no_kernel_takes(threads, slots, cluster):
    with pytest.raises(ValueError, match="no serial kernel"):
        dso_serial.serial_plan(72_309, 20_958, 3_683_302, **LIMITS,
                               threads=threads, slots=slots,
                               cluster=cluster)


def test_serial_plan_refuses_a_staged_cluster_and_too_much_smem():
    with pytest.raises(ValueError, match="no serial kernel"):
        dso_serial.serial_plan(2000, 500, 50_000, **LIMITS, cluster=4,
                               staged=True)
    with pytest.raises(ValueError, match="shared memory"):
        dso_serial.serial_plan(72_309, 20_958, 3_683_302, **LIMITS,
                               staged=True)


class _FailingLibrary:
    """A kernel library whose every entry point records its arguments and
    returns cudaErrorInvalidValue (1)."""

    def __init__(self):
        self.calls = []
        self.lib = self

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 1
        return entry


@pytest.mark.parametrize("launcher", ["staged", "global", "one thread",
                                      "step latency", "smem", "max cluster"])
def test_serial_launchers_match_their_c_entries(monkeypatch, launcher):
    """Each serial launcher calls its C entry with as many arguments as
    ``build.SIGNATURES`` declares, and raises on the entry's error."""
    from repro_torch.kernels import build
    failing = _FailingLibrary()
    monkeypatch.setattr(dso_serial, "library", lambda: failing)
    monkeypatch.setattr(dso_serial, "_stream", lambda t: 0)
    m, d, nnz = 6, 4, 9
    coords = (torch.zeros(nnz, dtype=torch.int32),
              torch.zeros(nnz, dtype=torch.int32), torch.ones(nnz),
              torch.arange(nnz, dtype=torch.int32))
    state = (torch.zeros(d), torch.zeros(m), torch.zeros(d), torch.zeros(m))
    rest = (torch.ones(m), torch.ones(m), torch.ones(d),
            (0.5, 1e-3, float(m), -1.0, 1.0), "hinge", "l2", True)
    plan = lambda staged: dso_serial.serial_plan(  # noqa: E731
        m, d, nnz, **LIMITS, staged=staged)
    entry, call = {
        "staged": ("dso_serial_epoch", lambda: dso_serial.launch_serial_epoch(
            *coords, *state, *rest, plan=plan(True))),
        "global": ("dso_serial_epoch", lambda: dso_serial.launch_serial_epoch(
            *coords, *state, *rest, plan=plan(False),
            rounds=torch.zeros(1, dtype=torch.int32))),
        "one thread": ("dso_serial_epoch_one_thread",
                       lambda: dso_serial.launch_serial_epoch_one_thread(
                           *coords, *state, *rest)),
        "step latency": ("dso_serial_step_latency",
                         lambda: dso_serial.launch_step_latency(
                             10, (0.3, 1.0, 2.0, 3.0), rest[3], "hinge",
                             "l2", True, torch.zeros(4))),
        "smem": ("dso_serial_smem",
                 lambda: dso_serial.kernel_smem(m, d, 2, 1024, True)),
        "max cluster": ("dso_serial_max_cluster", dso_serial.max_cluster),
    }[launcher]
    with pytest.raises(RuntimeError, match=f"{entry}: CUDA launch failed "
                                           f"with cudaError 1"):
        call()
    [(name, args)] = failing.calls
    assert name == entry and len(args) == len(build.SIGNATURES[entry])


def test_solve_serial_draws_one_randperm_per_epoch(monkeypatch):
    _, tp = _pair("hinge", "l2")
    nnz = int(torch.count_nonzero(tp.X))
    gen = torch.Generator().manual_seed(9)
    orders = [torch.randperm(nnz, generator=gen).numpy() for _ in range(4)]
    a = te.solve_serial(tp, epochs=4, eta0=0.5, seed=9, eval_every=3,
                        device="cpu")
    _replay(monkeypatch, orders)
    b = te.solve_serial(tp, epochs=4, eta0=0.5, seed=9, eval_every=1,
                        device="cpu")
    assert torch.equal(a.w, b.w) and torch.equal(a.alpha, b.alpha)
    assert a.history[-1] == b.history[-1]


def test_solve_serial_seams(monkeypatch):
    _, tp = _pair("hinge", "l2")
    from repro_torch.obs import RunRecorder
    rec = RunRecorder()
    te.solve_serial(tp, epochs=1, obs=rec, device="cpu")
    assert rec.events[0]["phase"] == "solve_serial"
    assert "epoch_chunk" in rec.span_stats()
    with pytest.raises(ValueError, match="eval_every"):
        te.solve_serial(tp, eval_every=0, device="cpu")
    res = te.solve_serial(tp, epochs=2, eval_hook=None, device="cpu")
    assert res.history == []
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        te.solve_serial(tp)
    with pytest.raises(RuntimeError, match="cuda"):
        tdso.run_dso_serial(tp)


@pytest.mark.parametrize("backend", ["dense_jnp", "sparse_jnp",
                                     "sparse_bucketed_jnp"])
def test_run_epoch_is_one_epoch_of_run_epochs(backend):
    _, tp = _pair("logistic", "l2")
    layout = te.resolve_backend(backend).layout
    data = te.make_grid_data(tp, 4) if layout == "dense" else {
        "sparse": tf.make_sparse_grid_data,
        "bucketed": tf.make_bucketed_grid_data}[layout](tp, 4, device="cpu")
    lam, m, _, _, _, lo, hi = te.prob_meta(tp)
    perm = te.cyclic_perms(1, 4)[0]
    kw = dict(backend=backend, loss_name="logistic", reg_name="l2")
    a = te.init_state(tp, data, 0.1)
    b = te.init_state_data("logistic", data, 0.1)
    a = te.run_epoch(data, a, perm, 0.5, lam, m, lo, hi, **kw)
    b = te.run_epochs(data, b, perm[None], [0.5], lam, m, lo, hi, **kw)
    assert a.epoch == b.epoch == 1
    for x, z in zip(a[:4], b[:4]):
        assert torch.equal(x, z)


@pytest.mark.parametrize("backend", ["dense_jnp", "sparse_jnp",
                                     "sparse_bucketed_jnp"])
def test_solve_without_scan_epochs_is_the_same_run(backend):
    _, tp = _pair("hinge", "l1")
    kw = dict(backend=backend, p=4, epochs=4, eta0=0.5, eval_every=2,
              device="cpu")
    a = te.solve(tp, **kw)
    b = te.solve(tp, scan_epochs=False, **kw)
    assert torch.equal(a.w, b.w) and torch.equal(a.alpha, b.alpha)
    assert a.history == b.history


def test_run_dso_serial_matches_reference(monkeypatch):
    jp, tp = _pair("logistic", "l2")
    nnz = int(np.count_nonzero(np.asarray(jp.X)))
    _replay(monkeypatch, _jax_orders(5, 4, nnz))
    kw = dict(epochs=4, eta0=0.5, seed=5, alpha0=0.0005)
    _assert_same_run(tdso.run_dso_serial(tp, **kw, device="cpu"),
                     jdso.run_dso_serial(jp, **kw))


@pytest.mark.parametrize("impl", ["jnp", "sparse", "auto"])
def test_run_dso_grid_matches_reference(impl):
    jp, tp = _pair("hinge", "l2", seed=3)
    kw = dict(p=4, epochs=3, eta0=0.5, row_batches=2, eval_every=1,
              impl=impl)
    _assert_same_run(tdso.run_dso_grid(tp, **kw, device="cpu"),
                     jdso.run_dso_grid(jp, **kw))
    _assert_same_run(
        tdso.run_dso_grid(tp, **kw, scan_epochs=False, device="cpu"),
        jdso.run_dso_grid(jp, **kw, scan_epochs=False))


def test_run_dso_random_matches_reference(monkeypatch):
    jp, tp = _pair("square", "l2", seed=2)
    _, perms = jsched.get_schedule("random").draw(jax.random.PRNGKey(4), 0,
                                                 3, 4)
    monkeypatch.setitem(tsched.SCHEDULES, "random",
                        tsched.fixed_schedule(np.asarray(perms), "random"))
    kw = dict(p=4, epochs=3, eta0=0.5, seed=4, eval_every=1,
              impl="sparse")
    _assert_same_run(t_random(tp, **kw, device="cpu"), j_random(jp, **kw))


def test_legacy_epoch_shims_match_reference():
    jp, tp = _pair("hinge", "l2", seed=6)
    jd, td = je.make_grid_data(jp, 4), te.make_grid_data(tp, 4)
    lam, m, _, _, _, lo, hi = je.prob_meta(jp)
    t_lam, t_m, _, _, _, t_lo, t_hi = te.prob_meta(tp)
    kw = dict(loss_name="hinge", reg_name="l2", use_adagrad=True,
              row_batches=1, p=4, db=td.db)
    j1 = jdso._grid_epoch(jd, je.init_state(jp, jd), jnp.float32(0.5), lam,
                          m, lo, hi, impl="jnp", **kw)
    t1 = tdso._grid_epoch(td, te.init_state(tp, td), 0.5, t_lam, t_m, t_lo,
                          t_hi, impl="jnp", **kw)
    etas = je.eta_schedule(0.5, 0, 3, True)
    j3 = jdso._grid_epochs(jd, je.init_state(jp, jd), etas, lam, m, lo, hi,
                           impl="jnp", **kw)
    t3 = tdso._grid_epochs(td, te.init_state(tp, td),
                           te.eta_schedule(0.5, 0, 3, True), t_lam, t_m,
                           t_lo, t_hi, impl="jnp", **kw)
    for t, j in ((t1, j1), (t3, j3)):
        assert t.epoch == int(j.epoch)
        for x, z in zip(t[:4], j[:4]):
            _close(x.numpy(), z)


SELECTORS = list(jdso.IMPLS) + [
    "dense_jnp", "dense_pallas_block", "dense_pallas_fused", "sparse_jnp",
    "sparse_pallas", "sparse_bucketed_jnp", "sparse_bucketed_pallas"]


@pytest.mark.parametrize("density", [0.01, 0.5])
@pytest.mark.parametrize("impl", SELECTORS)
def test_resolve_impl_matches_reference(impl, density):
    assert tdso.resolve_impl(impl, density) == jdso.resolve_impl(impl,
                                                                 density)
    assert tdso.IMPLS == jdso.IMPLS


def test_resolve_impl_refuses_what_the_reference_refuses():
    for mod in (jdso, tdso):
        with pytest.raises(ValueError, match="registered backends"):
            mod.resolve_impl("nope", 0.1)


@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_saddle_gradients_match_reference(loss, reg):
    jp, tp = _pair(loss, reg, seed=7, m=24, d=16)
    rng = np.random.default_rng(7)
    w = rng.normal(0, 0.3, tp.d).astype(np.float32)
    a = np.asarray(jsad.project_alpha(jp, jnp.asarray(
        rng.uniform(-1, 1, tp.m).astype(np.float32))))
    X = np.asarray(jp.X)
    ii, jj = np.nonzero(X)
    args = (w[jj], a[ii], np.asarray(jp.y)[ii], X[ii, jj],
            np.asarray(jp.row_nnz)[ii], np.asarray(jp.col_nnz)[jj])
    for got, want in zip(
            tsad.stochastic_grads(tp, *map(torch.tensor, args)),
            jsad.stochastic_grads(jp, *map(jnp.asarray, args))):
        _close(got.numpy(), want)
    rows, cols = slice(4, 16), slice(3, 11)
    Xt = X[rows, cols]
    tile = (Xt, np.asarray(jp.y)[rows], w[cols], a[rows],
            np.asarray(jp.row_nnz)[rows], np.asarray(jp.col_nnz)[cols],
            (Xt != 0).sum(0).astype(np.float32),
            (Xt != 0).sum(1).astype(np.float32))
    for got, want in zip(tsad.grads_tile(tp, *map(torch.tensor, tile)),
                         jsad.grads_tile(jp, *map(jnp.asarray, tile))):
        _close(got.numpy(), want)
    if reg == "l2":
        _close(tsad.argmin_w(tp, torch.tensor(a)).numpy(),
               jsad.argmin_w(jp, jnp.asarray(a)))
    else:
        for mod, prob, arr in ((jsad, jp, jnp.asarray(a)),
                               (tsad, tp, torch.tensor(a))):
            with pytest.raises(ValueError, match="only for l2"):
                mod.argmin_w(prob, arr)


def test_adagrad_and_schedule_match_reference():
    g = np.random.default_rng(8).normal(0, 1, 33).astype(np.float32)
    acc = np.abs(g[::-1]).copy()
    for got, want in zip(tada.step(torch.tensor(g), torch.tensor(acc), 0.3),
                         jada.step(jnp.asarray(g), jnp.asarray(acc), 0.3)):
        _close(got.numpy(), want)
    assert tada._EPS == jada._EPS
    z = tada.init((3, 5), device="cpu")
    assert z.dtype == torch.float32 and np.array_equal(
        z.numpy(), np.asarray(jada.init((3, 5))))
    for p in (1, 3, 4, 7):
        assert tsch.ring_perm(p) == jsch.ring_perm(p)
        assert tsch.pad_to_multiple(10, p) == jsch.pad_to_multiple(10, p)
        assert tsch.partition_even(11, p) == jsch.partition_even(11, p)
        assert [tsch.sigma(q, r, p) for q in range(p) for r in range(p)] \
            == [jsch.sigma(q, r, p) for q in range(p) for r in range(p)]


@pytest.mark.parametrize("epochs,eval_every", [(10, 3), (12, 4), (5, 9),
                                               (7, 1), (9, 6)])
def test_warn_ragged_eval_matches_reference(epochs, eval_every):
    def warned(fn):
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            fn(epochs, eval_every)
            fn(epochs, eval_every)                  # once per shape
        return [str(r.message) for r in rec
                if issubclass(r.category, RuntimeWarning)]

    j, t = warned(jdrv.warn_ragged_eval), warned(te.warn_ragged_eval)
    assert len(t) == len(j) <= 1
    if t:
        assert f"eval_every={eval_every}" in t[0] and \
            t[0].split("e.g. ")[1] == j[0].split("e.g. ")[1]


def test_core_exports_match_reference():
    import repro.core as jc
    import repro_torch.core as tc
    assert tc.__all__ == jc.__all__
    assert tc.run_dso_grid is tdso.run_dso_grid
    assert tc.run_dso_serial is tdso.run_dso_serial
    with pytest.raises(AttributeError):
        tc.run_dso_nope
    for name in ("init_state", "run_epoch", "solve_serial",
                 "warn_ragged_eval"):
        assert name in te.__all__ and hasattr(te, name)


@pytest.mark.parametrize("first", ["repro_torch.data.libsvm",
                                   "repro_torch.sparse.ingest",
                                   "repro_torch.core.dso",
                                   "repro_torch.core"])
def test_entry_modules_import_first(first):
    mods = ["repro_torch.data.libsvm", "repro_torch.sparse.ingest",
            "repro_torch.core.dso", "repro_torch.core"]
    order = [first] + [m for m in mods if m != first]
    code = "; ".join(f"import {m}" for m in order) + \
        "; import repro_torch.core as c; c.run_dso_serial; " \
        "import sys; assert 'jax' not in sys.modules"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
