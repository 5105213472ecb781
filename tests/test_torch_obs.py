"""The port's observability layer against the JAX reference (CPU).

  1. metrics, spans, recorder — the registry, histogram quantiles (exact
     while the reservoir holds the stream, and equal to the reference's
     past it), span nesting, the Chrome export, the JSONL round trip with
     a truncated tail, and the spans passed to ``torch.profiler``.
  2. ``solve(obs=...)`` and ``solve_serial(obs=...)`` — the recorder's
     event stream matches the reference's type for type and name for
     name, in order (with a snapshot store and a health rollback too).
  3. the telemetry lane — ``TELEMETRY_FIELDS`` literally equal on both
     sides; the drained buffers within 1e-5 of the reference's
     ``run_epochs_telemetry`` with rows/nnz exact, for {sparse_jnp,
     sparse_bucketed_jnp, dense_jnp} x {cyclic, lpt};
     ``comm_bytes_matrix`` and ``render_heatmap`` equal the reference's.
  4. the contracts — telemetry and obs on against off max |delta| = 0.0;
     ``obs=None`` makes no obs call; ``repro_torch.engine`` never imports
     ``repro_torch.obs`` or ``repro_torch.runtime``.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.data.synthetic as jsyn
import repro.engine as je
import repro.obs as jobs
import repro.runtime as jrt
import repro_torch.data.synthetic as tsyn
import repro_torch.engine as te
import repro_torch.obs as tobs
import repro_torch.runtime as trt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
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


# ---------------------------------------------- metrics, spans, recorder --


def test_registry_memoizes_and_separates_labels():
    reg = tobs.MetricRegistry()
    a = reg.gauge("rows_per_s", phase="train")
    assert reg.gauge("rows_per_s", phase="train") is a
    assert reg.gauge("rows_per_s", phase="eval") is not a
    assert len(reg) == 2
    with pytest.raises(ValueError, match="already registered"):
        reg.counter("rows_per_s", phase="train")
    with pytest.raises(ValueError, match="cannot decrease"):
        reg.counter("c").inc(-1)
    reg.counter("c").inc(2)
    snap = reg.snapshot()
    assert snap["c"] == {"kind": "counter", "value": 2.0}
    assert "rows_per_s{phase=train}" in snap


def test_histogram_quantiles_exact_then_deterministic():
    h = tobs.MetricRegistry().histogram("h")
    for v in np.random.default_rng(0).permutation(1000):
        h.observe(float(v))
    assert h.quantiles() == {"p50": 500.0, "p90": 900.0, "p99": 990.0}
    assert (h.count, h.min, h.max, h.mean) == (1000, 0.0, 999.0, 499.5)
    # past the reservoir: a pure function of (name, stream), the same as
    # the reference's
    from repro_torch.obs.metrics import _RESERVOIR_CAP
    vals = np.random.default_rng(1).normal(size=_RESERVOIR_CAP + 500)
    ht = tobs.MetricRegistry().histogram("lat")
    hj = jobs.MetricRegistry().histogram("lat")
    for v in vals:
        ht.observe(float(v))
        hj.observe(float(v))
    assert ht.quantiles() == hj.quantiles()


def test_span_nesting_depth_order_and_chrome_export():
    rec = tobs.RunRecorder()
    with rec.span("outer", k=1):
        with rec.span("inner"):
            rec.metrics.gauge("g").set(3.0)
    spans = [e for e in rec.events if e["type"] == "span"]
    assert [(s["name"], s["depth"]) for s in spans] == [("inner", 1),
                                                        ("outer", 0)]
    assert spans[1]["attrs"] == {"k": 1}
    trace = tobs.chrome_trace_events(rec.events)
    assert {ev["ph"] for ev in trace["traceEvents"]} == {"X", "C"}
    ticks = iter([0.0, 1.0, 3.0])
    tr = tobs.SpanTracer(clock=lambda: next(ticks))
    with tr.span("a"):
        pass
    assert tr.depth == 0


def test_span_shows_in_a_profiler_trace():
    from torch.profiler import ProfilerActivity, profile
    rec = tobs.RunRecorder(profiler_annotations=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with rec.span("epoch_chunk"):
            torch.ones(8).sum()
    assert "epoch_chunk" in {e.key for e in prof.key_averages()}


def test_recorder_jsonl_round_trip_and_truncated_tail(tmp_path):
    path = str(tmp_path / "run.jsonl")
    rec = tobs.RunRecorder(path, meta=dict(run="t"))
    rec.metrics.counter("ingest.rows").inc(5)
    with rec.span("epoch_chunk", epochs=2):
        rec.metrics.gauge("rows_per_s").set(torch.tensor(10.0))
    rec.record_ledger(trt.LedgerEvent(kind="crash", epoch=3))
    rec.close()
    back = tobs.read_events(path)
    assert back == rec.events
    assert [e["type"] for e in back] == ["meta", "metric", "metric", "span",
                                        "ledger"]
    assert rec.summary()["ledger"] == {"crash": 1}
    with open(path, "a") as f:
        f.write('{"seq": 99, "ts": 1.0, "type": "met')
    gen = tobs.iter_events(path)
    assert next(gen)["type"] == "meta"
    assert len(list(gen)) == 4


def test_health_guard_forwards_to_recorder():
    rec = tobs.RunRecorder()
    guard = trt.HealthGuard()
    guard.obs = rec
    guard.note(kind="health", epoch=3, action="rollback", failure="nan")
    assert rec.events[-1]["kind"] == "health"
    assert rec.events[-1]["failure"] == "nan"


# ----------------------------------------------------- the solve stream --


def _shape_of(events):
    """(type, name) of every event: the metric's or span's name, the
    meta's phase, the ledger's kind."""
    out = []
    for e in events:
        key = {"meta": "phase", "ledger": "kind",
               "telemetry": "kind"}.get(e["type"], "name")
        out.append((e["type"], e.get(key)))
    return out


@pytest.mark.parametrize("backend", ["sparse_jnp", "sparse_bucketed_jnp",
                                     "dense_jnp"])
def test_solve_records_the_reference_stream(backend):
    jp, tp = _pair(skewed=backend == "sparse_bucketed_jnp")
    kw = dict(backend=backend, p=4, epochs=4, eta0=0.5, eval_every=2,
              seed=3)
    jr, tr = jobs.RunRecorder(), tobs.RunRecorder()
    je.solve(jp, obs=jr, **kw)
    te.solve(tp, obs=tr, device="cpu", **kw)
    assert _shape_of(tr.events) == _shape_of(jr.events)
    meta_t, meta_j = tr.events[0], jr.events[0]
    assert {k: v for k, v in meta_t.items() if k not in ("ts", "seq")} == \
        {k: v for k, v in meta_j.items() if k not in ("ts", "seq")}
    gauges = {e["name"]: e["value"] for e in tr.events
              if e["type"] == "metric"}
    want = {e["name"]: e["value"] for e in jr.events
            if e["type"] == "metric"}
    np.testing.assert_allclose(gauges["eval.primal"], want["eval.primal"],
                               **TOL)
    assert gauges["nnz_per_s"] > 0


def test_solve_stream_with_store_and_rollback(tmp_path):
    jp, tp = _pair()
    kw = dict(backend="sparse_jnp", p=4, epochs=6, eta0=0.5, eval_every=2,
              seed=3, checkpoint_every=2)
    jr, tr = jobs.RunRecorder(), tobs.RunRecorder()
    je.solve(jp, obs=jr, store=jrt.SnapshotStore(str(tmp_path / "j")),
             health=jrt.HealthGuard(injector=jrt.NaNInjector({2: ("w", 0)})),
             **kw)
    te.solve(tp, obs=tr, store=trt.SnapshotStore(str(tmp_path / "t")),
             health=trt.HealthGuard(injector=trt.NaNInjector({2: ("w", 0)})),
             device="cpu", **kw)
    shape = _shape_of(tr.events)
    assert shape == _shape_of(jr.events)
    assert {("span", "snapshot_save"), ("span", "restore"),
            ("ledger", "health")} <= set(shape)


def test_solve_serial_records_the_reference_stream():
    jp, tp = _pair(m=40, d=20)
    jr, tr = jobs.RunRecorder(), tobs.RunRecorder()
    je.solve_serial(jp, epochs=3, eta0=0.5, eval_every=2, obs=jr)
    te.solve_serial(tp, epochs=3, eta0=0.5, eval_every=2, obs=tr,
                    device="cpu")
    assert _shape_of(tr.events) == _shape_of(jr.events)
    assert tr.events[0]["nnz"] == jr.events[0]["nnz"]


# ---------------------------------------------------- the telemetry lane --


def test_telemetry_fields_literal_sync():
    from repro.engine import driver as jdrv
    from repro_torch.engine import driver as tdrv
    assert tdrv.TELEMETRY_FIELDS == tobs.TELEMETRY_FIELDS == \
        jdrv.TELEMETRY_FIELDS == jobs.TELEMETRY_FIELDS


@pytest.mark.parametrize("schedule", ["cyclic", "lpt"])
@pytest.mark.parametrize("backend", ["sparse_jnp", "sparse_bucketed_jnp",
                                     "dense_jnp"])
def test_telemetry_buffers_match_reference(backend, schedule):
    jp, tp = _pair(skewed=backend == "sparse_bucketed_jnp")
    kw = dict(backend=backend, schedule=schedule, p=4, epochs=5, eta0=0.5,
              eval_every=2, seed=3, row_batches=2)
    js, ts = jobs.TelemetrySpec(), tobs.TelemetrySpec()
    je.solve(jp, telemetry=js, **kw)
    te.solve(tp, telemetry=ts, device="cpu", **kw)
    assert [c.epochs for c in ts.chunks] == [c.epochs for c in js.chunks] \
        == [2, 2, 1]
    for a, b in zip(ts.chunks, js.chunks):
        assert (a.t0, a.p, a.db, a.transport) == (b.t0, b.p, b.db,
                                                  b.transport)
        np.testing.assert_array_equal(a.buf[..., 2:], b.buf[..., 2:])
        np.testing.assert_allclose(a.buf[..., :2], b.buf[..., :2], **TOL)
        np.testing.assert_array_equal(a.comm, b.comm)
        np.testing.assert_array_equal(a.etas, b.etas)
    assert ts.nonfinite_total() == 0


def test_telemetry_rows_and_nnz_are_the_tile_statistics():
    _, tp = _pair()
    grid = te.make_grid_data(tp, 4)
    ts = tobs.TelemetrySpec()
    te.solve(tp, backend="dense_jnp", p=4, epochs=2, eval_every=2,
             telemetry=ts, device="cpu")
    trn = grid.tile_row_nnz_g.numpy()
    buf = ts.chunks[0].buf
    for e in range(2):
        for r in range(4):
            for q in range(4):
                b = (q + r) % 4
                assert buf[e, r, q, 2] == (trn[q, b] > 0).sum()
                assert buf[e, r, q, 3] == trn[q, b].sum()


@pytest.mark.parametrize("transport", ["ring", "p2p", "allgather"])
def test_comm_bytes_matrix_matches_reference(transport):
    rng = np.random.default_rng(5)
    perms = np.stack([np.stack([rng.permutation(5) for _ in range(5)])
                      for _ in range(3)])
    np.testing.assert_array_equal(
        tobs.comm_bytes_matrix(torch.tensor(perms), 16, transport),
        jobs.comm_bytes_matrix(perms, 16, transport))
    with pytest.raises(ValueError, match="transport"):
        tobs.comm_bytes_matrix(perms, 16, "smoke-signals")


def test_render_heatmap_matches_reference(tmp_path):
    rng = np.random.default_rng(2)
    specs = (tobs.TelemetrySpec(), jobs.TelemetrySpec())
    perms = np.tile(np.arange(4), (2, 4, 1))
    for t0 in (0, 2):
        buf = rng.uniform(1, 9, size=(2, 4, 4, 5)).astype(np.float32)
        buf[..., 4] = 0.0
        for spec in specs:
            spec.drain(buf, t0=t0, etas=[0.5, 0.5], perms=perms, db=4,
                       transport="ring", wall_s=0.4)
    for spec in specs:
        spec.attribute_delay(1, 3.0, t0=2, epochs=2)
    tspec, jspec = specs
    assert tobs.render_heatmap(tspec) == jobs.render_heatmap(jspec)
    np.testing.assert_array_equal(tobs.nnz_throughput(tspec),
                                  jobs.nnz_throughput(jspec))
    tm, tt = tobs.wall_balance(tspec)
    jm, jt = jobs.wall_balance(jspec)
    np.testing.assert_array_equal(tm, jm)
    assert tt == jt
    # from a run-event log, as from the spec
    path = str(tmp_path / "ev.jsonl")
    with tobs.RunRecorder(path) as rec:
        spec = tobs.TelemetrySpec(obs=rec)
        for c in tspec.chunks:
            spec.drain(torch.tensor(c.buf), t0=c.t0, etas=c.etas,
                       perms=perms, db=c.db, transport=c.transport,
                       wall_s=c.wall_s)
        spec.attribute_delay(1, 3.0, t0=2, epochs=2)
    assert "argmax worker: 1" in tobs.render_heatmap(tobs.iter_events(path))
    with pytest.raises(ValueError, match="telemetry buffer"):
        tspec.drain(np.zeros((2, 2, 2, 3)), t0=0, etas=[0.5, 0.5],
                    perms=np.tile(np.arange(2), (2, 2, 1)), db=4,
                    transport="ring")


# -------------------------------------------------------- the contracts --


@pytest.mark.parametrize("backend", ["sparse_jnp", "sparse_bucketed_jnp",
                                     "dense_jnp",
                                     "sparse_bucketed_jnp_switch"])
def test_telemetry_and_obs_on_against_off_bit_identical(backend, tmp_path):
    _, tp = _pair(skewed="bucketed" in backend)
    kw = dict(backend=backend, p=4, epochs=6, eta0=0.5, eval_every=2,
              seed=0, device="cpu")
    off = te.solve(tp, **kw)
    with tobs.RunRecorder(str(tmp_path / "run.jsonl")) as rec:
        on = te.solve(tp, obs=rec, telemetry=tobs.TelemetrySpec(obs=rec),
                      **kw)
    tel = te.solve(tp, telemetry=tobs.TelemetrySpec(), **kw)
    for r in (on, tel):
        assert (r.w - off.w).abs().max().item() == 0.0
        assert (r.alpha - off.alpha).abs().max().item() == 0.0
        assert r.history == off.history


def test_metrics_off_is_true_noop(monkeypatch):
    import repro_torch.engine.driver as drv

    def boom(*a, **kw):
        raise AssertionError("obs path entered with obs=None")

    monkeypatch.setattr(drv, "_obs_throughput", boom)
    monkeypatch.setattr(drv, "_obs_eval", boom)
    monkeypatch.setattr(drv, "run_epochs_telemetry", boom)
    _, tp = _pair()
    res = drv.solve(tp, epochs=3, p=4, eta0=0.5, device="cpu")
    assert len(res.history) == 3
    res = drv.solve_serial(tp, epochs=2, eta0=0.5, device="cpu")
    assert len(res.history) == 2


def test_telemetry_requires_scan_epochs():
    _, tp = _pair()
    with pytest.raises(ValueError, match="telemetry"):
        te.solve(tp, p=4, epochs=2, telemetry=tobs.TelemetrySpec(),
                 scan_epochs=False, device="cpu")


def test_engine_never_imports_obs_or_runtime():
    code = ("import sys\n"
            "import repro_torch.engine, repro_torch.sparse\n"
            "import repro_torch.core.dso, repro_torch.kernels.ops\n"
            "bad = [m for m in sys.modules if m.startswith("
            "('repro_torch.obs', 'repro_torch.runtime'))]\n"
            "assert not bad, bad\n"
            "print('CLEAN')\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONPATH=os.path.join(REPO, "src")))
    assert out.returncode == 0 and "CLEAN" in out.stdout, out.stderr
