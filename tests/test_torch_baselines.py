"""The port's Sec.-5 baselines (SGD, PSGD, DCD, BMRM) and the examples
that drive them, against the JAX reference (CPU, the reference tests'
sizes).

The epoch functions ``_sgd_epoch`` (six (loss, reg) pairs x batch 1 and
7, which does not divide m 400) and ``_dcd_epoch`` take the reference's
permutations and stay within 1e-5 of the reference's after every epoch;
``run_sgd``, ``run_psgd`` (p 4, ragged m) and ``run_dcd`` replay the
reference's ``jax.random`` orders through the port's draw helpers, and
their w, alpha and history are within 1e-5; ``_solve_bundle_dual`` and
``run_bmrm`` (deterministic) too.  The six tests of
``tests/test_baselines.py`` are ported with their assertions unchanged.
Every ``run_*`` refuses to run without a card at its default device.
Both examples run on the CPU; ``svm_vs_baselines`` prints the reference's
numbers within 1e-5 at a small size.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.baselines.bmrm as jbmrm
import repro.baselines.dcd as jdcd
import repro.baselines.psgd as jpsgd
import repro.baselines.sgd as jsgd
import repro.data.synthetic as jsyn
import repro_torch.baselines.bmrm as tbmrm
import repro_torch.baselines.dcd as tdcd
import repro_torch.baselines.psgd as tpsgd
import repro_torch.baselines.sgd as tsgd
import repro_torch.data.synthetic as tsyn
from repro.core.dso import run_dso_grid as j_dso
from repro_torch.core.dso import run_dso_grid as t_dso
from repro_torch.examples import quickstart, svm_vs_baselines
from repro_torch.kernels import ops

LOSS_REG_PAIRS = [("hinge", "l2"), ("hinge", "l1"), ("logistic", "l2"),
                  ("logistic", "l1"), ("square", "l2"), ("square", "l1")]
TOL = dict(rtol=1e-5, atol=1e-5)
SHAPE = dict(m=400, d=150, density=0.1, lam=1e-3, seed=1)


def _pair(loss="hinge", reg="l2", **over):
    kw = dict(SHAPE, loss=loss, reg=reg, **over)
    return (jsyn.make_classification(**kw),
            tsyn.make_classification(**kw, device="cpu"))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Every tensor here is small: one intra-op thread is as fast, and
    leaves the machine's other cores to the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def prob():
    """The reference tests' fixture, in the port."""
    return tsyn.make_classification(m=400, d=150, density=0.1, loss="hinge",
                                    lam=1e-3, seed=1, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **TOL)


def _same_history(h_t, h_j):
    assert [h["epoch"] for h in h_t] == [h["epoch"] for h in h_j]
    for a, b in zip(h_t, h_j):
        assert a.keys() == b.keys()
        np.testing.assert_allclose(a["primal"], b["primal"], **TOL)


def _jax_perms(seed, m):
    """The reference's epoch orders (sgd.py:52-53, dcd.py:59-60): a split
    and a permutation per epoch."""
    key = jax.random.PRNGKey(seed)
    while True:
        key, sk = jax.random.split(key)
        yield np.array(jax.random.permutation(sk, m))


def _jax_shard_perms(seed, p, mb):
    """The reference's PSGD orders (psgd.py:45-47), (p, mb) per epoch."""
    key = jax.random.PRNGKey(seed)
    while True:
        key, sk = jax.random.split(key)
        yield np.array(jax.vmap(lambda k: jax.random.permutation(k, mb))(
            jax.random.split(sk, p)))


def _replay(monkeypatch):
    """Make the port's draw helpers hand out the reference's orders: one
    stream per ``torch.Generator`` (so per run), from its seed."""
    streams = {}

    def draw(module, name, stream):
        def fn(key, *shape):
            if key not in streams:
                streams[key] = stream(key.initial_seed(), *shape)
            return torch.as_tensor(next(streams[key]))
        monkeypatch.setattr(module, name, fn)

    draw(tsgd, "_draw_perm", _jax_perms)
    draw(tdcd, "_draw_perm", _jax_perms)
    draw(tpsgd, "_draw_perms", _jax_shard_perms)


# ------------------------------------------------------- epoch functions --


@pytest.mark.parametrize("batch", [1, 7])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_sgd_epoch_matches_reference(loss, reg, batch):
    jp, tp = _pair(loss, reg)
    w_j = acc_j = jnp.zeros(jp.d, jnp.float32)
    w_t, acc_t = torch.zeros(tp.d), torch.zeros(tp.d)
    perms = _jax_perms(0, jp.m)
    for _ in range(3):
        perm = next(perms)
        w_j, acc_j = jsgd._sgd_epoch(
            jp.X, jp.y, jnp.asarray(perm), w_j, acc_j, jnp.float32(0.3),
            jnp.float32(jp.lam), loss_name=loss, reg_name=reg, m=jp.m,
            batch=batch)
        out = tsgd._sgd_epoch(tp.X, tp.y, torch.as_tensor(perm), w_t, acc_t,
                              0.3, tp.lam, loss_name=loss, reg_name=reg,
                              m=tp.m, batch=batch)
        assert out[0] is w_t and out[1] is acc_t     # in place
        _close(w_t.numpy(), w_j)
        _close(acc_t.numpy(), acc_j)


def test_dcd_epoch_matches_reference():
    jp, tp = _pair()
    w_j, beta_j = jnp.zeros(jp.d, jnp.float32), jnp.zeros(jp.m, jnp.float32)
    w_t, beta_t = torch.zeros(tp.d), torch.zeros(tp.m)
    xn_j = jnp.sum(jp.X * jp.X, axis=1)
    xn_t = tdcd._row_norms2(tp.X)
    _close(xn_t.numpy(), xn_j)
    perms = _jax_perms(0, jp.m)
    for _ in range(3):
        perm = next(perms)
        w_j, beta_j = jdcd._dcd_epoch(jp.X, jp.y, jnp.asarray(perm), w_j,
                                      beta_j, jnp.float32(jp.lam), xn_j,
                                      m=jp.m)
        tdcd._dcd_epoch(tp.X, tp.y, perm, w_t, beta_t, tp.lam, xn_t, m=tp.m)
        _close(w_t.numpy(), w_j)
        _close(beta_t.numpy(), beta_j)


def test_row_norms_chunked(monkeypatch):
    _, tp = _pair()
    whole = tdcd._row_norms2(tp.X)
    monkeypatch.setattr(tdcd, "_NORM_ROWS", 64)     # 400 = 6 x 64 + 16
    assert torch.equal(tdcd._row_norms2(tp.X), whole)


def test_psgd_padding_rows_take_the_regularizer_step():
    """A padding row (-1) is a zero row of label 0: its step moves w by the
    regularizer and AdaGrad alone, as the reference's padded copy does."""
    _, tp = _pair(reg="l2")
    w = torch.full((1, tp.d), 0.5)
    acc = torch.zeros_like(w)
    ops.sgd_epoch(tp.X, tp.y, torch.tensor([[-1]], dtype=torch.int32), w,
                  acc, 0.3, 1e-3, loss_name="hinge", reg_name="l2")
    g = np.float32(1e-3) * np.float32(1.0)               # lam * 2 * 0.5
    want = np.float32(0.5) - np.float32(0.3) * g / np.sqrt(g * g + 1e-8)
    _close(w.numpy(), np.full((1, tp.d), want, np.float32))
    _close(acc.numpy(), np.full((1, tp.d), g * g, np.float32))


def test_epoch_wrappers_refuse_bad_inputs():
    _, tp = _pair()
    w, acc = torch.zeros(1, tp.d), torch.zeros(1, tp.d)
    rows = torch.zeros(1, 8, dtype=torch.int32)
    kw = dict(loss_name="hinge", reg_name="l2")
    with pytest.raises(ValueError, match="nsteps"):
        ops.sgd_epoch(tp.X, tp.y, rows, w, acc, 0.1, 1e-3, batch=3, **kw)
    with pytest.raises(TypeError, match="rows"):
        ops.sgd_epoch(tp.X, tp.y, rows.long(), w, acc, 0.1, 1e-3, **kw)
    with pytest.raises(ValueError, match="loss"):
        ops.sgd_epoch(tp.X, tp.y, rows, w, acc, 0.1, 1e-3,
                      loss_name="huber", reg_name="l2")
    with pytest.raises(ValueError, match="w must have shape"):
        ops.sgd_epoch(tp.X, tp.y, rows, torch.zeros(2, tp.d), acc, 0.1,
                      1e-3, **kw)
    with pytest.raises(ValueError, match="beta must have shape"):
        ops.dcd_epoch(tp.X, tp.y, rows[0], w[0], torch.zeros(3), 1e-3,
                      torch.zeros(tp.m))
    with pytest.raises(ValueError, match="m=3"):
        tdcd._dcd_epoch(tp.X, tp.y, rows[0], w[0], torch.zeros(tp.m),
                        1e-3, torch.zeros(tp.m), m=3)


class _FailingLibrary:
    """A kernel library whose every entry point records its arguments and
    returns cudaErrorLaunchOutOfResources (701)."""

    def __init__(self):
        self.calls = []
        self.lib = self

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 701
        return entry


@pytest.mark.parametrize("entry", ["sgd_epoch", "dcd_epoch"])
def test_launchers_raise_on_an_error_from_their_entry(monkeypatch, entry):
    """A refused launch raises through ``build.check``, and the launcher
    passes as many arguments as the entry point's signature has."""
    from repro_torch.kernels import baselines as kb
    from repro_torch.kernels import build
    failing = _FailingLibrary()
    monkeypatch.setattr(kb, "library", lambda: failing)
    monkeypatch.setattr(kb, "_stream", lambda t: 0)
    _, tp = _pair()
    perm = torch.arange(tp.m, dtype=torch.int32)
    with pytest.raises(RuntimeError, match=f"{entry}: CUDA launch failed "
                                           f"with cudaError 701"):
        if entry == "sgd_epoch":
            kb.launch_sgd_epoch(tp.X, tp.y, perm.reshape(1, -1),
                                torch.zeros(1, tp.d), torch.zeros(1, tp.d),
                                0.3, 1e-3, "logistic", "l1", 1)
        else:
            kb.launch_dcd_epoch(tp.X, tp.y, perm, torch.zeros(tp.d),
                                torch.zeros(tp.m), 1e-3, torch.ones(tp.m))
    [(name, args)] = failing.calls
    assert name == entry and len(args) == len(build.SIGNATURES[entry])


def test_wrappers_route_cpu_tensors_to_the_plain_version():
    from repro_torch.kernels import baselines as kb
    _, tp = _pair()
    rows = torch.randperm(tp.m, generator=torch.Generator().manual_seed(0))
    rows = rows.to(torch.int32)
    before = ops.launch_counts()
    a = [torch.zeros(1, tp.d), torch.zeros(1, tp.d)]
    b = [torch.zeros(1, tp.d), torch.zeros(1, tp.d)]
    kb.sgd_epoch_plain(tp.X, tp.y, rows.reshape(1, -1), *a, 0.3, 1e-3,
                       "square", "l1", 4)
    ops.sgd_epoch(tp.X, tp.y, rows.reshape(1, -1), *b, 0.3, 1e-3,
                  loss_name="square", reg_name="l1", batch=4)
    assert all(torch.equal(x, z) for x, z in zip(a, b))
    xn = tdcd._row_norms2(tp.X)
    a = [torch.zeros(tp.d), torch.zeros(tp.m)]
    b = [torch.zeros(tp.d), torch.zeros(tp.m)]
    kb.dcd_epoch_plain(tp.X, tp.y, rows, *a, 1e-3, xn)
    ops.dcd_epoch(tp.X, tp.y, rows, *b, 1e-3, xn)
    assert all(torch.equal(x, z) for x, z in zip(a, b))
    assert ops.launch_counts() == before     # the plain path launches none
    assert {"sgd_epoch", "dcd_epoch"} <= set(before)


# --------------------------------------------------------- the runners --


@pytest.mark.parametrize("loss,reg,batch", [("hinge", "l2", 1),
                                            ("logistic", "l1", 7),
                                            ("square", "l2", 8)])
def test_run_sgd_matches_reference(monkeypatch, loss, reg, batch):
    jp, tp = _pair(loss, reg)
    _replay(monkeypatch)
    kw = dict(epochs=3, eta0=0.3, batch=batch, seed=2, eval_every=2)
    w_j, h_j = jsgd.run_sgd(jp, **kw)
    w_t, h_t = tsgd.run_sgd(tp, **kw, device="cpu")
    _close(w_t.numpy(), w_j)
    _same_history(h_t, h_j)


@pytest.mark.parametrize("m,batch", [(398, 1), (401, 3)])
def test_run_psgd_matches_reference(monkeypatch, m, batch):
    jp, tp = _pair("logistic", m=m)
    _replay(monkeypatch)
    kw = dict(p=4, epochs=3, eta0=0.3, batch=batch, seed=1)
    w_j, h_j = jpsgd.run_psgd(jp, **kw)
    w_t, h_t = tpsgd.run_psgd(tp, **kw, device="cpu")
    _close(w_t.numpy(), w_j)
    _same_history(h_t, h_j)


def test_run_dcd_matches_reference(monkeypatch):
    jp, tp = _pair()
    _replay(monkeypatch)
    w_j, a_j, h_j = jdcd.run_dcd(jp, epochs=4, seed=3, eval_every=3)
    w_t, a_t, h_t = tdcd.run_dcd(tp, epochs=4, seed=3, eval_every=3,
                                 device="cpu")
    _close(w_t.numpy(), w_j)
    _close(a_t.numpy(), a_j)
    _same_history(h_t, h_j)


def test_run_dcd_refuses_other_losses():
    jp, tp = _pair("logistic")
    with pytest.raises(ValueError, match="hinge"):
        jdcd.run_dcd(jp)
    with pytest.raises(ValueError, match="hinge"):
        tdcd.run_dcd(tp, device="cpu")


def test_solve_bundle_dual_matches_reference():
    rng = np.random.default_rng(7)
    A = rng.normal(0, 0.1, (150, 12)).astype(np.float32)
    b = rng.normal(0, 0.1, 12).astype(np.float32)
    beta_j = jbmrm._solve_bundle_dual(jnp.asarray(A), jnp.asarray(b),
                                      jnp.float32(1e-3))
    beta_t = tbmrm._solve_bundle_dual(torch.as_tensor(A), torch.as_tensor(b),
                                      1e-3)
    _close(beta_t.numpy(), beta_j)
    risk_j, grad_j = jbmrm._risk_and_grad(_pair()[0], jnp.asarray(A[:, 0]))
    risk_t, grad_t = tbmrm._risk_and_grad(_pair()[1], torch.as_tensor(A[:, 0]))
    _close(float(risk_t), float(risk_j))
    _close(grad_t.numpy(), grad_j)


@pytest.mark.parametrize("loss,max_planes", [("hinge", 100), ("logistic", 4)])
def test_run_bmrm_matches_reference(loss, max_planes):
    jp, tp = _pair(loss)
    kw = dict(iters=8, eval_every=3, max_planes=max_planes)
    w_j, h_j = jbmrm.run_bmrm(jp, **kw)
    w_t, h_t = tbmrm.run_bmrm(tp, **kw, device="cpu")
    _close(w_t.numpy(), w_j)
    _same_history(h_t, h_j)


def test_runners_default_to_the_card(prob):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for run in (tsgd.run_sgd, tpsgd.run_psgd, tdcd.run_dcd, tbmrm.run_bmrm):
        with pytest.raises(RuntimeError, match="cuda"):
            run(prob)
    with pytest.raises(RuntimeError, match="cuda"):
        quickstart.main([])


# ------------------------- tests/test_baselines.py, ported unchanged --


def test_sgd_converges(prob):
    _, hist = tsgd.run_sgd(prob, epochs=8, eta0=0.3, device="cpu")
    assert hist[-1]["primal"] < hist[0]["primal"]


def test_psgd_converges(prob):
    _, hist = tpsgd.run_psgd(prob, p=4, epochs=8, eta0=0.3, device="cpu")
    assert hist[-1]["primal"] < hist[0]["primal"]


def test_bmrm_converges(prob):
    _, hist = tbmrm.run_bmrm(prob, iters=25, device="cpu")
    assert hist[-1]["primal"] < hist[2]["primal"]


def test_dcd_converges(prob):
    _, alpha, hist = tdcd.run_dcd(prob, epochs=10, device="cpu")
    assert hist[-1]["primal"] < hist[0]["primal"]
    # alpha feasible for the saddle problem: y*alpha in [0, 1]
    ya = prob.y.numpy() * alpha.numpy()
    assert ya.min() >= -1e-6 and ya.max() <= 1 + 1e-6


def test_all_methods_agree_on_optimum(prob):
    """Every optimizer drives P(w) to the same neighbourhood (Sec. 5.1)."""
    h_dcd = tdcd.run_dcd(prob, epochs=20, device="cpu")[2]
    _, h_sgd = tsgd.run_sgd(prob, epochs=25, eta0=0.3, device="cpu")
    _, h_bmrm = tbmrm.run_bmrm(prob, iters=40, device="cpu")
    _, _, h_dso = t_dso(prob, p=4, epochs=50, eta0=0.5, device="cpu")
    ref = h_dcd[-1]["primal"]  # DCD = de-facto exact for hinge
    for name, h in [("sgd", h_sgd), ("bmrm", h_bmrm), ("dso", h_dso)]:
        assert abs(h[-1]["primal"] - ref) < 0.05, (name, h[-1], ref)


def test_logistic_loss_sgd_vs_dso():
    prob = tsyn.make_classification(m=300, d=100, density=0.15,
                                    loss="logistic", lam=1e-3, seed=5,
                                    device="cpu")
    _, h_sgd = tsgd.run_sgd(prob, epochs=20, eta0=0.3, device="cpu")
    _, _, h_dso = t_dso(prob, p=4, epochs=40, eta0=0.5,
                        alpha0=0.0005, device="cpu")  # App. B logistic init
    assert abs(h_sgd[-1]["primal"] - h_dso[-1]["primal"]) < 0.05


# ------------------------------------------------------------ examples --


def test_quickstart_runs_on_the_cpu(capsys):
    hist = quickstart.main(["--device", "cpu"])
    assert hist[-1]["gap"] < hist[0]["gap"] and len(hist) == 6
    assert "train accuracy" in capsys.readouterr().out


def test_svm_vs_baselines_matches_reference(monkeypatch, capsys):
    """The example's line for one lambda, at a fifth of ``paper_like``'s
    real-sim rows and columns, equals what the reference's example
    computes there (its calls, with ``impl="jnp"``), within 1e-5."""
    small = dict(m=400, d=160, density=0.0125)     # 2 nonzeros per row
    monkeypatch.setattr(
        svm_vs_baselines, "paper_like",
        lambda name, loss, lam, device: tsyn.make_classification(
            **small, loss=loss, lam=lam, device=device))
    _replay(monkeypatch)
    rows = svm_vs_baselines.main(["--device", "cpu"])
    assert len(capsys.readouterr().out.splitlines()) == 2
    for loss, lam, got in rows:
        jp = jsyn.make_classification(**small, loss=loss, lam=lam)
        a0 = 0.0005 if loss == "logistic" else 0.0
        _, _, h_dso = j_dso(jp, p=4, epochs=30, eta0=0.5, alpha0=a0)
        _, h_sgd = jsgd.run_sgd(jp, epochs=15, eta0=0.3)
        _, h_psgd = jpsgd.run_psgd(jp, p=4, epochs=15, eta0=0.3)
        _, h_bmrm = jbmrm.run_bmrm(jp, iters=25)
        want = dict(dso=h_dso[-1]["primal"], dso_gap=h_dso[-1]["gap"],
                    sgd=h_sgd[-1]["primal"], psgd=h_psgd[-1]["primal"],
                    bmrm=h_bmrm[-1]["primal"])
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k], want[k], err_msg=(loss, k),
                                       **TOL)
