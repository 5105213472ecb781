"""The legacy K-bucket switch backends of the port against the reference
(CPU, small sizes).

The ``"buckets"`` payload of ``as_tile_data`` (the per-bucket rectangles
and the (p, p) bucket maps) equals the reference's array for array;
``sparse_bucketed_jnp_switch`` stays within 1e-5 of the reference's (and
of the port's flat ``sparse_bucketed_jnp``) for six (loss, reg) pairs x
row_batches {1, 3}; ``sparse_bucketed_pallas_switch`` on CPU tensors runs
the block-ELL kernel's plain version on each rectangle and agrees too.
"""

import numpy as np
import pytest
import torch

import repro.data.synthetic as jsyn
import repro.engine as je
import repro_torch.data.synthetic as tsyn
import repro_torch.engine as te
from repro.sparse import format as jformat
from repro_torch.sparse import format as tformat

LOSS_REG_PAIRS = [("hinge", "l2"), ("hinge", "l1"), ("logistic", "l2"),
                  ("logistic", "l1"), ("square", "l2"), ("square", "l1")]
TOL = dict(rtol=1e-5, atol=1e-5)


def _pair(loss="hinge", reg="l2", seed=1):
    kw = dict(m=120, d=60, density=0.15, seed=seed, reg=reg)
    if loss == "square":
        return (jsyn.make_regression(**kw),
                tsyn.make_regression(**kw, device="cpu"))
    kw.update(loss=loss, lam=1e-3, alpha=1.3)
    return (jsyn.make_skewed_classification(**kw),
            tsyn.make_skewed_classification(**kw, device="cpu"))


@pytest.mark.parametrize("p", [1, 2, 4])
def test_buckets_payload_matches_reference(p):
    jp, tp = _pair()
    jg = jformat.make_bucketed_grid_data(jp, p)
    tg = tformat.make_bucketed_grid_data(tp, p, device="cpu")
    ja = je.as_tile_data(jg, bucketed_payload="buckets").arrays
    ta = te.as_tile_data(tg, bucketed_payload="buckets").arrays
    assert len(ta) == len(ja) == 2 * len(jg.bucket_ks) + 2
    for a, b in zip(ta, ja):
        assert isinstance(a, torch.Tensor) and a.device == tg.yg.device
        assert a.numpy().dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tile = te.as_tile_data(tg, bucketed_payload="buckets")
    assert tile.layout == "bucketed"
    with pytest.raises(ValueError, match="bucketed_payload"):
        te.as_tile_data(tg, bucketed_payload="chunks")


def test_switch_backends_resolve():
    names = te.registered_backends()
    for name in ("sparse_bucketed_jnp_switch",
                 "sparse_bucketed_pallas_switch"):
        be = te.get_backend(name)
        assert name in names and be.layout == "bucketed"
        assert be.payload == "buckets"
    assert te.get_backend("sparse_bucketed_jnp").payload == "flat"
    assert set(names) == set(je.registered_backends())


@pytest.mark.parametrize("row_batches", [1, 3])
@pytest.mark.parametrize("loss,reg", LOSS_REG_PAIRS)
def test_jnp_switch_matches_reference(loss, reg, row_batches):
    jp, tp = _pair(loss, reg)
    kw = dict(p=4, epochs=3, eta0=0.5, row_batches=row_batches)
    j = je.solve(jp, backend="sparse_bucketed_jnp_switch", **kw)
    t = te.solve(tp, backend="sparse_bucketed_jnp_switch", device="cpu",
                 **kw)
    flat = te.solve(tp, backend="sparse_bucketed_jnp", device="cpu", **kw)
    for got in (t.w, flat.w):
        np.testing.assert_allclose(got.numpy(), np.asarray(j.w), **TOL)
    np.testing.assert_allclose(t.alpha.numpy(), np.asarray(j.alpha), **TOL)
    np.testing.assert_allclose(t.w.numpy(), flat.w.numpy(), **TOL)
    for a, b in zip(t.history, j.history):
        np.testing.assert_allclose(a["primal"], b["primal"], **TOL)


@pytest.mark.parametrize("schedule", ["cyclic", "lpt"])
def test_pallas_switch_runs_plain_on_cpu_tensors(schedule):
    jp, tp = _pair("logistic", "l2")
    kw = dict(p=4, epochs=3, eta0=0.5, schedule=schedule, row_batches=2)
    j = je.solve(jp, backend="sparse_bucketed_pallas_switch", **kw)
    t = te.solve(tp, backend="sparse_bucketed_pallas_switch", device="cpu",
                 **kw)
    t_jnp = te.solve(tp, backend="sparse_bucketed_jnp_switch", device="cpu",
                     **kw)
    np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), **TOL)
    np.testing.assert_allclose(t.w.numpy(), t_jnp.w.numpy(), **TOL)
    np.testing.assert_allclose(t.alpha.numpy(), t_jnp.alpha.numpy(), **TOL)


def test_switch_on_prebuilt_grid_and_run_epochs():
    """A pre-built ``BucketedGridData`` through ``solve`` and straight into
    ``run_epochs``: each backend takes its own payload."""
    _, tp = _pair()
    grid = tformat.make_bucketed_grid_data(tp, 4, device="cpu")
    kw = dict(loss_name="hinge", reg_name="l2", lam=1e-3, m=120, d=60,
              p=4, epochs=2, eta0=0.5, device="cpu")
    a = te.solve(grid, backend="sparse_bucketed_jnp_switch", **kw)
    b = te.solve(grid, backend="sparse_bucketed_jnp", **kw)
    np.testing.assert_allclose(a.w.numpy(), b.w.numpy(), **TOL)
    lam, m_f, _, _, _, lo, hi = te.prob_meta(tp)
    perms = te.cyclic_perms(2, 4)
    st = te.init_state_data("hinge", grid)
    st = te.run_epochs(grid, st, perms, [0.5, 0.5], lam, m_f, lo, hi,
                       backend="sparse_bucketed_jnp_switch",
                       loss_name="hinge", reg_name="l2")
    np.testing.assert_allclose(te.gather_w(st, 60).numpy(), a.w.numpy(),
                               **TOL)
