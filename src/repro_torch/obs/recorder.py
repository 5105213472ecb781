"""``RunRecorder``: the one sink metrics, spans, and ledger events share.

Every update lands in ONE ordered in-memory event list (monotone ``seq``,
relative ``ts`` seconds from recorder construction) and is written as one
JSONL line per event — the run-event log a run report reads back
(``iter_events`` / ``read_events``).  The three
producers:

  obs.metrics   — ``rec.metrics.gauge("rows_per_s").set(...)`` (the
                  registry is bound to the recorder at construction)
  obs.trace     — ``with rec.span("epoch_chunk", epochs=4): ...``
  runtime ledger— ``rec.record_ledger(LedgerEvent(...))`` (a
                  ``HealthGuard`` forwards every typed recovery event)

plus free-form ``rec.record(type=..., **fields)`` for meta events (run
config, phase markers).  ``summary()`` folds the whole stream into one
end-of-run dict: final metric values, per-span-name timing totals, and
the ledger ``kind`` counts.

Event schema (one JSON object per line; ``seq``/``ts`` on every event):

  {"seq": N, "ts": s, "type": "metric", "name": ..., "kind":
      "counter"|"gauge"|"histogram", "value": v[, "labels": {...}]}
  {"seq": N, "ts": s, "type": "span", "name": ..., "t0": s, "dur_s": s,
      "depth": D[, "attrs": {...}]}
  {"seq": N, "ts": s, "type": "ledger", "kind": ..., "epoch": E,
      "action": ..., "epochs_lost": L, "retry": R, ...detail}
  {"seq": N, "ts": s, "type": "meta", ...}

The recorder is the duck-typed object every ``obs=`` seam accepts; the
layers below (engine, runtime, sparse, serving) never import this module.
"""

from __future__ import annotations

import json
import os
import time

from repro_torch.obs.metrics import MetricRegistry
from repro_torch.obs.trace import SpanTracer, chrome_trace_events


def _jsonable(v):
    """Best-effort JSON coercion: numpy/torch scalars -> python scalars,
    unknown objects -> str.  Event values must never make a write throw
    mid-run."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple, set)):
        return [_jsonable(x) for x in v]
    item = getattr(v, "item", None)
    if item is not None:
        try:
            return _jsonable(item())
        except Exception:
            pass
    return str(v)


class RunRecorder:
    """Ordered merge of metrics + spans + ledger into one event log.

    ``path`` — when given, every event is appended to the JSONL file as it
    is recorded (line-buffered via flush, so a crashed run still leaves a
    readable prefix); with ``path=None`` events stay in memory until
    ``write``.  ``profiler_annotations`` passes host span names through to
    ``torch.profiler.record_function``, so they show in a profiler
    trace.  ``meta`` is recorded as the first
    event (run config / shape / seed — whatever identifies the run).
    """

    def __init__(self, path: str | None = None, *,
                 profiler_annotations: bool = False,
                 meta: dict | None = None,
                 clock=time.perf_counter):
        self._clock = clock
        self.epoch0 = clock()
        self.events: list = []
        self._seq = 0
        self.path = path
        self._file = open(path, "w") if path is not None else None
        self.tracer = SpanTracer(self, clock=clock,
                                 profiler_annotations=profiler_annotations)
        self.tracer.epoch0 = self.epoch0      # one shared time origin
        self.metrics = MetricRegistry(self)
        self.ledger: list = []                # the typed events, verbatim
        if meta is not None:
            self.record(type="meta", **meta)

    # ------------------------------------------------------------ record --

    def record(self, *, type: str, **fields):           # noqa: A002
        """Append one event (stamped with ``seq`` and relative ``ts``)."""
        ev = {"seq": self._seq, "ts": self._clock() - self.epoch0,
              "type": type}
        self._seq += 1
        for k, v in fields.items():
            ev[k] = _jsonable(v)
        self.events.append(ev)
        if self._file is not None:
            self._file.write(json.dumps(ev) + "\n")
            self._file.flush()
        return ev

    def span(self, name: str, **attrs):
        """``with rec.span("epoch_chunk", epochs=4): ...`` — forwarded to
        the bound tracer (one shared nesting stack and time origin)."""
        return self.tracer.span(name, **attrs)

    def record_ledger(self, event) -> None:
        """Fold one typed ``LedgerEvent`` (or anything with ``to_dict``,
        or a plain dict) into the stream as a ``type="ledger"`` event."""
        d = event.to_dict() if hasattr(event, "to_dict") else dict(event)
        self.ledger.append(event)
        self.record(type="ledger", **d)

    # ----------------------------------------------------------- summary --

    def span_stats(self) -> dict:
        """``{span name: {count, total_s, mean_s, max_s}}``."""
        out: dict = {}
        for ev in self.events:
            if ev["type"] != "span":
                continue
            s = out.setdefault(ev["name"],
                               {"count": 0, "total_s": 0.0, "max_s": 0.0})
            s["count"] += 1
            s["total_s"] += ev["dur_s"]
            s["max_s"] = max(s["max_s"], ev["dur_s"])
        for s in out.values():
            s["mean_s"] = s["total_s"] / s["count"]
        return out

    def ledger_counts(self) -> dict:
        out: dict = {}
        for ev in self.events:
            if ev["type"] == "ledger":
                out[ev["kind"]] = out.get(ev["kind"], 0) + 1
        return out

    def summary(self) -> dict:
        """The end-of-run dict: final metrics, span totals, ledger
        counts, and stream size — everything a one-screen report needs."""
        return {
            "events": len(self.events),
            "metrics": self.metrics.snapshot(),
            "spans": self.span_stats(),
            "ledger": self.ledger_counts(),
        }

    # ------------------------------------------------------------- files --

    def write(self, path: str | None = None) -> str:
        """Write (or finalize) the JSONL event log; returns its path."""
        path = path or self.path
        if path is None:
            raise ValueError("RunRecorder has no path: pass one to write()")
        if self._file is not None and path == self.path:
            self._file.close()
            self._file = None
            return path
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev) + "\n")
        return path

    def write_chrome_trace(self, path: str) -> str:
        """Chrome trace-event JSON of the recorded spans + counters —
        drag into Perfetto / chrome://tracing."""
        with open(path, "w") as f:
            json.dump(chrome_trace_events(self.events), f)
        return path

    def close(self):
        if self._file is not None:
            self._file.close()
            self._file = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_events(path: str):
    """Stream a JSONL run-event log lazily, one event dict at a time.

    Generator — a multi-GB event log costs one line of memory, so report
    sections can fold over runs far larger than RAM.  A truncated final
    line (crashed run mid-write) ends the stream: the valid prefix is
    yielded, the torn tail is dropped.
    """
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                if os.path.getsize(path) and line is not None:
                    return     # truncated tail: keep the valid prefix


def read_events(path: str) -> list:
    """Load a JSONL run-event log back into a list of event dicts
    (tolerates a truncated final line from a crashed run).  Materializing
    wrapper over ``iter_events`` — prefer the generator for large logs."""
    return list(iter_events(path))
