"""Span tracer: host-side timed regions as nested ``span(...)`` contexts.

``SpanTracer.span("epoch_chunk", epochs=4)`` times a ``with`` region on
``time.perf_counter`` and emits ONE event at exit (``type="span"`` with
``t0``/``dur_s``/``depth``), so a span costs two clock reads plus one
sink append.  Nesting is tracked per tracer (``depth``), which is what
lets the Chrome-trace export stack child spans under their parents.

Two consumers:

* the run-event log — spans interleave with metric samples and ledger
  events in ``RunRecorder``'s ordered JSONL stream;
* Perfetto / chrome://tracing — ``chrome_trace_events`` converts recorded
  span events into Chrome trace-event dicts (``ph="X"`` complete events,
  microsecond timestamps), written by ``RunRecorder.write_chrome_trace``.

``profiler_annotations=True`` also enters a
``torch.profiler.record_function(name)`` for the span's duration, so in a
``torch.profiler`` trace of a run on the card the host spans sit above
the kernels they launched; without an active profiler it records
nothing.
"""

from __future__ import annotations

import time
from contextlib import contextmanager

#: standard span names the engine emits (an open set; the report renders
#: any name)
WELL_KNOWN_SPANS = ("epoch_chunk", "snapshot_save", "restore", "reshard",
                    "eval", "ingest_pass1", "ingest_pass2", "serve_batch")


def _profiler_annotation(name: str):
    """``torch.profiler.record_function(name)``, entered by the caller."""
    import torch
    return torch.profiler.record_function(name)


class SpanTracer:
    """Nested timed regions over one monotonic clock.

    ``sink`` is anything with ``record(type=..., **fields)`` (a
    ``RunRecorder``); with no sink the spans still time and nest but emit
    nowhere.  ``clock`` is injectable for tests.
    """

    def __init__(self, sink=None, *, clock=time.perf_counter,
                 profiler_annotations: bool = False):
        self._sink = sink
        self._clock = clock
        self._annotate = profiler_annotations
        self._stack: list = []
        #: origin of the tracer's relative timeline (t0 fields are offsets
        #: from this, so JSONL stays small and runs are comparable)
        self.epoch0 = clock()

    @property
    def depth(self) -> int:
        return len(self._stack)

    @contextmanager
    def span(self, name: str, **attrs):
        """Time a region; emits one span event at exit.  ``attrs`` ride
        along verbatim; keep them JSON-serializable."""
        ann = _profiler_annotation(name) if self._annotate else None
        if ann is not None:
            ann.__enter__()
        depth = len(self._stack)
        t0 = self._clock()
        self._stack.append(name)
        try:
            yield self
        finally:
            dur = self._clock() - t0
            self._stack.pop()
            if ann is not None:
                ann.__exit__(None, None, None)
            if self._sink is not None:
                self._sink.record(type="span", name=name,
                                  t0=t0 - self.epoch0, dur_s=dur,
                                  depth=depth,
                                  **({"attrs": attrs} if attrs else {}))


def chrome_trace_events(events, *, pid: int = 0) -> dict:
    """Recorded run events -> Chrome trace-event JSON (Perfetto-loadable).

    Span events become ``ph="X"`` complete events (timestamps in
    microseconds, one ``tid`` per nesting depth); numeric metric events
    become ``ph="C"`` counter samples on the same timeline.  Ledger and
    meta events are skipped (the JSONL log is their home).
    """
    out = []
    for ev in events:
        if ev.get("type") == "span":
            out.append({
                "name": ev["name"], "ph": "X", "pid": pid,
                "tid": ev.get("depth", 0),
                "ts": round(ev["t0"] * 1e6, 3),
                "dur": round(ev["dur_s"] * 1e6, 3),
                "args": ev.get("attrs", {}),
            })
        elif ev.get("type") == "metric" and isinstance(
                ev.get("value"), (int, float)) and "ts" in ev:
            out.append({
                "name": ev["name"], "ph": "C", "pid": pid, "tid": 0,
                "ts": round(ev["ts"] * 1e6, 3),
                "args": {ev["name"]: ev["value"]},
            })
    return {"traceEvents": out, "displayTimeUnit": "ms"}
