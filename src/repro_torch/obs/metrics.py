"""Process-local metric registry: counters, gauges, and histograms.

A metric is a named instrument plus a frozen label set; the registry
memoizes instruments by ``(name, labels)`` so hot paths pay one dict hit,
not an allocation, per update.  Instruments hold their state locally
(``value`` / summary statistics) AND forward every update to the sink the
registry was bound to (a ``RunRecorder`` or anything with
``record(type=..., **fields)``), which is what merges them into the
ordered run-event log.  With no sink bound, updates are pure local state —
a few float ops — so a registry is usable standalone (tests, ad-hoc
probes).

The engine never imports this module: the drivers take a duck-typed
``obs=`` object (``None`` by default) and guard every touch with
``if obs is not None`` — the metrics-off contract is that the solver's
chunk loop performs NO obs work and allocates nothing when ``obs`` is
``None`` (pinned by tests/test_torch_obs.py).  The reference's module
(pure Python) is kept here as the port's own copy.

Instruments:

  Counter    — monotone float; ``inc(v)``.   (rows scanned, tokens out)
  Gauge      — last-write-wins; ``set(v)``.  (rows/s, eta, primal, gap)
  Histogram  — running count/sum/min/max;    (per-chunk epoch seconds)
               ``observe(v)``.
"""

from __future__ import annotations

import random
import zlib

# quantile reservoir size: 4096 floats (~32 KiB) bounds the memory of a
# histogram no matter how many samples it sees; nearest-rank quantiles
# over a uniform reservoir of this size are exact for short runs and
# within ~2% rank error for long ones — plenty for a summary table
_RESERVOIR_CAP = 4096


def _label_key(labels: dict) -> tuple:
    """Canonical hashable form of a label dict (sorted item tuple)."""
    return tuple(sorted(labels.items()))


class Metric:
    """Shared instrument core: identity, labels, and sink forwarding."""

    kind = "metric"

    def __init__(self, name: str, labels: dict, sink=None):
        self.name = name
        self.labels = dict(labels)
        self._sink = sink

    def _emit(self, value: float):
        if self._sink is not None:
            self._sink.record(type="metric", name=self.name, kind=self.kind,
                              value=value,
                              **({"labels": self.labels} if self.labels
                                 else {}))


class Counter(Metric):
    """Monotone accumulator."""

    kind = "counter"

    def __init__(self, name: str, labels: dict, sink=None):
        super().__init__(name, labels, sink)
        self.value = 0.0

    def inc(self, v: float = 1.0):
        if v < 0:
            raise ValueError(f"counter {self.name} cannot decrease (v={v})")
        self.value += v
        self._emit(self.value)
        return self


class Gauge(Metric):
    """Last-write-wins sample."""

    kind = "gauge"

    def __init__(self, name: str, labels: dict, sink=None):
        super().__init__(name, labels, sink)
        self.value = None

    def set(self, v: float):
        self.value = float(v)
        self._emit(self.value)
        return self


class Histogram(Metric):
    """Running summary (count / sum / min / max / quantiles) of samples.

    Deliberately bucketless: the run-event log keeps every observation (the
    emitted events ARE the samples), so the report can re-bucket offline;
    the in-process summary keeps the moments plus a bounded reservoir for
    p50/p90/p99.  The reservoir is Vitter's Algorithm R with a PRNG seeded
    from the metric NAME (crc32 — ``hash()`` is salted per process), so
    the same sample stream always yields the same quantile estimates:
    summaries are reproducible run to run.
    """

    kind = "histogram"

    def __init__(self, name: str, labels: dict, sink=None):
        super().__init__(name, labels, sink)
        self.count = 0
        self.sum = 0.0
        self.min = None
        self.max = None
        self._reservoir: list = []
        self._rng = random.Random(zlib.crc32(name.encode()))

    def observe(self, v: float):
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self._reservoir) < _RESERVOIR_CAP:
            self._reservoir.append(v)
        else:
            j = self._rng.randrange(self.count)
            if j < _RESERVOIR_CAP:
                self._reservoir[j] = v
        self._emit(v)
        return self

    @property
    def mean(self):
        return self.sum / self.count if self.count else None

    def quantile(self, q: float):
        """Nearest-rank quantile over the reservoir (``q`` in [0, 1]);
        exact while the stream fits the reservoir, approximate after."""
        if not self._reservoir:
            return None
        s = sorted(self._reservoir)
        return s[min(len(s) - 1, max(0, int(q * len(s))))]

    def quantiles(self) -> dict:
        """The summary trio: ``{"p50": ..., "p90": ..., "p99": ...}``."""
        return {"p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricRegistry:
    """Memoized ``(name, labels) -> instrument`` map bound to one sink.

    ``registry.counter("ingest.rows")``, ``registry.gauge("rows_per_s",
    phase="train")`` — repeated calls with the same identity return the
    SAME instrument; asking for an existing name with a different kind
    raises (one name, one instrument type, or the summary is ambiguous).
    """

    def __init__(self, sink=None):
        self._sink = sink
        self._metrics: dict = {}

    def _get(self, kind: str, name: str, labels: dict):
        key = (name, _label_key(labels))
        got = self._metrics.get(key)
        if got is not None:
            if got.kind != kind:
                raise ValueError(
                    f"metric {name!r} already registered as {got.kind}, "
                    f"requested {kind}")
            return got
        m = _KINDS[kind](name, labels, self._sink)
        self._metrics[key] = m
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get("histogram", name, labels)

    def __len__(self) -> int:
        return len(self._metrics)

    def snapshot(self) -> dict:
        """``{name{labels}: final value summary}`` — the metrics half of
        the end-of-run summary."""
        out = {}
        for (name, lkey), m in sorted(self._metrics.items()):
            tag = name if not lkey else \
                name + "{" + ",".join(f"{k}={v}" for k, v in lkey) + "}"
            if m.kind == "histogram":
                out[tag] = dict(kind=m.kind, count=m.count, sum=m.sum,
                                min=m.min, max=m.max, mean=m.mean,
                                **m.quantiles())
            else:
                out[tag] = dict(kind=m.kind, value=m.value)
        return out
