"""Observability of the port: metric registry, span tracer, run-event log
and the device-side telemetry lane.

One ``RunRecorder`` merges three streams into a single ordered event log
(JSONL) and an end-of-run summary:

   metrics.py    Counter / Gauge / Histogram with labels, memoized in a
     |           MetricRegistry bound to the recorder (rows/s, nnz/s,
     |           packed bytes/s, eta, eval.primal, eval.gap, ...)
   trace.py      SpanTracer: nested host spans on perf_counter
     |           (epoch_chunk, snapshot_save, restore, eval) -> JSONL span
     |           events + Chrome trace export; optional
     |           torch.profiler.record_function pass-through, so the spans
     |           sit above their kernels in a profiler trace of the card
   recorder.py   RunRecorder: the one sink; also takes the runtime's typed
                 LedgerEvent stream (record_ledger)
   telemetry.py  TelemetrySpec: the device-side lane — per-(epoch, inner
                 iteration r, worker q) buffers of update norms, rows/nnz
                 and nonfinite flags filled on the grid's device beside the
                 update, drained at chunk boundaries into
                 ``type="telemetry"`` events; comm bytes priced from the
                 schedule's permutations; heatmap renderers.

Seams (duck-typed, default ``None``; the engine never imports this
package):

  engine.solve(..., obs=rec)          chunk spans, per-chunk throughput
                                      gauges, eval.<key> gauges, the
                                      health guard's ledger
  engine.solve_serial(..., obs=rec)   chunk spans, gauges, eval metrics
  engine.solve(..., telemetry=spec)   the telemetry lane

Event schema — one JSON object per line, ``seq`` (monotone int) and
``ts`` (seconds since recorder construction) on every event:

  {"seq", "ts", "type": "meta",   ...run identity (free-form)}
  {"seq", "ts", "type": "metric", "name", "kind": "counter"|"gauge"|
      "histogram", "value"[, "labels"]}
  {"seq", "ts", "type": "span",   "name", "t0", "dur_s", "depth"
      [, "attrs"]}
  {"seq", "ts", "type": "ledger", "kind", "epoch", "action",
      "epochs_lost", "retry", ...detail fields}
  {"seq", "ts", "type": "telemetry", "kind": "chunk", "t0", "epochs",
      "p", "db", "transport": "ring"|"p2p"|"allgather", "wall_s",
      "eta": [per-epoch], "nonfinite": int, and per-(epoch, r, q) nested
      lists "dw_norm", "dalpha_norm", "rows", "nnz", "comm_bytes"}
  {"seq", "ts", "type": "telemetry", "kind": "delay", "worker",
      "seconds", "t0", "epochs"}

METRICS-OFF CONTRACT: every seam defaults to ``obs=None`` and guards all
instrumentation behind ``if obs is not None``: the chunk loop then makes
no obs call and allocates nothing for obs, and a recorder-on run's
trajectory equals a recorder-off run's (the recorder only observes).
``telemetry=None`` leaves ``run_epochs`` as it is: no copy, no
allocation and no extra launch.
"""

from repro_torch.obs.metrics import (Counter, Gauge, Histogram, Metric,
                                     MetricRegistry)
from repro_torch.obs.recorder import RunRecorder, iter_events, read_events
from repro_torch.obs.telemetry import (TELEMETRY_FIELDS, TelemetrySpec,
                                       comm_bytes_matrix, nnz_throughput,
                                       render_heatmap, render_matrix,
                                       wall_balance)
from repro_torch.obs.trace import (WELL_KNOWN_SPANS, SpanTracer,
                                   chrome_trace_events)

__all__ = [
    "Counter", "Gauge", "Histogram", "Metric", "MetricRegistry",
    "RunRecorder", "iter_events", "read_events",
    "TELEMETRY_FIELDS", "TelemetrySpec", "comm_bytes_matrix",
    "nnz_throughput", "render_heatmap", "render_matrix", "wall_balance",
    "SpanTracer", "chrome_trace_events", "WELL_KNOWN_SPANS",
]
