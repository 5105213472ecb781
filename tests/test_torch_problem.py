"""The port's problem math against the JAX reference (CPU, small sizes).

Objectives, gaps and projections within 1e-6 relative on the six
(loss, reg) pairs, and the synthetic generators give an identical ``X, y``
for the same seed.
"""

import numpy as np
import pytest
import torch

import repro.core.saddle as js
import repro.data.synthetic as jsyn
import repro_torch.core.saddle as ts
import repro_torch.data.synthetic as tsyn
from repro.core.losses import get_loss as j_loss
from repro.core.regularizers import get_regularizer as j_reg
from repro_torch.core.losses import get_loss as t_loss
from repro_torch.core.regularizers import get_regularizer as t_reg

LOSS_REG_PAIRS = [("hinge", "l2"), ("hinge", "l1"), ("logistic", "l2"),
                  ("logistic", "l1"), ("square", "l2"), ("square", "l1")]

RTOL = 1e-6


def _pair(loss, reg, seed=0):
    if loss == "square":
        kw = dict(m=120, d=60, density=0.15, seed=seed, reg=reg)
        return (jsyn.make_regression(**kw),
                tsyn.make_regression(**kw, device="cpu"))
    kw = dict(m=120, d=60, density=0.15, loss=loss, lam=1e-3, seed=seed,
              reg=reg)
    return (jsyn.make_classification(**kw),
            tsyn.make_classification(**kw, device="cpu"))


def _iterates(prob_np_y, m, d, seed, loss):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 0.3, d).astype(np.float32)
    a = (prob_np_y * rng.uniform(0.05, 0.95, m)).astype(np.float32)
    if loss == "square":
        a = rng.normal(0, 0.5, m).astype(np.float32)
    return w, a


def _close(a, b, rtol=RTOL):
    a, b = float(a), float(b)
    if np.isinf(a) or np.isinf(b):
        assert a == b
    else:
        assert abs(a - b) <= rtol * max(abs(a), abs(b), 1e-12), (a, b)


@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_objectives_and_gap_match_reference(loss, reg):
    jp, tp = _pair(loss, reg)
    w, a = _iterates(np.asarray(jp.y), jp.m, jp.d, 3, loss)
    tw, ta = torch.from_numpy(w), torch.from_numpy(a)
    _close(js.primal_objective(jp, w), ts.primal_objective(tp, tw))
    _close(js.dual_objective(jp, a), ts.dual_objective(tp, ta))
    _close(js.saddle_objective(jp, w, a), ts.saddle_objective(tp, tw, ta))
    _close(js.duality_gap(jp, w, a), ts.duality_gap(tp, tw, ta))
    np.testing.assert_allclose(ts.project_w(tp, tw * 50).numpy(),
                               np.asarray(js.project_w(jp, w * 50)),
                               rtol=RTOL)
    np.testing.assert_allclose(ts.project_alpha(tp, ta * 3).numpy(),
                               np.asarray(js.project_alpha(jp, a * 3)),
                               rtol=RTOL)
    for f in ("row_nnz", "col_nnz"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)))
    assert tp.nnz == jp.nnz and tp.lam == jp.lam


@pytest.mark.parametrize("loss", ["hinge", "logistic", "square"])
def test_loss_functions_match_reference(loss):
    rng = np.random.default_rng(1)
    u = rng.normal(0, 2, 64).astype(np.float32)
    y = np.where(rng.random(64) < 0.5, 1.0, -1.0).astype(np.float32)
    a = (y * rng.uniform(-0.2, 1.2, 64)).astype(np.float32)
    jl, tl = j_loss(loss), t_loss(loss)
    for name, args in (("value", (u, y)), ("grad", (u, y)),
                       ("neg_conjugate", (a, y)), ("dual_grad", (a, y)),
                       ("project_alpha", (a, y))):
        want = np.asarray(getattr(jl, name)(*args))
        got = getattr(tl, name)(*map(torch.from_numpy, args)).numpy()
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7,
                                   err_msg=f"{loss}.{name}")
    if jl.w_box is None:
        assert tl.w_box is None
    else:
        assert tl.w_box(1e-4) == float(np.float32(jl.w_box(1e-4)))


@pytest.mark.parametrize("reg", ["l2", "l1"])
def test_regularizers_match_reference(reg):
    w = np.linspace(-2, 2, 41).astype(np.float32)
    jr, tr = j_reg(reg), t_reg(reg)
    tw = torch.from_numpy(w)
    np.testing.assert_array_equal(tr.value(tw).numpy(),
                                  np.asarray(jr.value(w)))
    np.testing.assert_array_equal(tr.grad(tw).numpy(), np.asarray(jr.grad(w)))
    np.testing.assert_array_equal(tr.conjugate_min(tw, 0.5).numpy(),
                                  np.asarray(jr.conjugate_min(w, 0.5)))


@pytest.mark.parametrize("name,kw", [
    ("make_classification", dict(m=80, d=50, density=0.1, seed=4)),
    ("make_skewed_classification", dict(m=80, d=50, density=0.1, alpha=1.3,
                                        seed=5)),
    ("make_regression", dict(m=70, d=40, density=0.2, seed=6)),
    ("make_dense_classification", dict(m=30, d=16, seed=7)),
])
def test_generators_give_identical_data(name, kw):
    jp = getattr(jsyn, name)(**kw)
    tp = getattr(tsyn, name)(**kw, device="cpu")
    np.testing.assert_array_equal(tp.X.numpy(), np.asarray(jp.X))
    np.testing.assert_array_equal(tp.y.numpy(), np.asarray(jp.y))
    assert (tp.loss_name, tp.reg_name, tp.lam) == \
        (jp.loss_name, jp.reg_name, jp.lam)


def test_powerlaw_columns_and_paper_like_match():
    c1 = jsyn.powerlaw_columns(np.random.default_rng(2), 20, 64, 6, 1.3)
    c2 = tsyn.powerlaw_columns(np.random.default_rng(2), 20, 64, 6, 1.3)
    np.testing.assert_array_equal(c1, c2)
    assert tsyn.PAPER_LIKE == jsyn.PAPER_LIKE
    jp = jsyn.paper_like("real-sim", seed=1)
    tp = tsyn.paper_like("real-sim", seed=1, device="cpu")
    np.testing.assert_array_equal(tp.X.numpy(), np.asarray(jp.X))
