"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms (the port's copy of ``fm_spark_tpu/obs/metrics.py``).

- :class:`Counter`: monotonically increasing totals;
- :class:`Gauge`: last-written values;
- :class:`Histogram`: fixed-bucket distributions with p50/p95/p99
  interpolated inside the bucket the rank lands in, clamped to the exact
  observed min/max.

All thread-safe, with reentrant locks (the SIGTERM dump handler snapshots
the registry on the main thread, possibly while that thread is inside an
``add``). One :class:`MetricsRegistry` per process (:func:`registry`);
snapshots export as JSONL lines (:meth:`MetricsRegistry.export_jsonl`,
the run dir's ``metrics.jsonl``) and as Prometheus text
(:meth:`MetricsRegistry.prometheus_text`, the live ``/metrics``
endpoint). No torch import: every layer, the ingest producer thread
included, imports this module.
"""

from __future__ import annotations

import bisect
import json
import threading
import time

from fm_spark_tpu_torch.utils import durable

__all__ = [
    "DEFAULT_BUCKETS_MS",
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "counter",
    "gauge",
    "histogram",
    "registry",
]

#: Default histogram bucket upper bounds, tuned for millisecond
#: latencies from a sub-ms CPU step to a multi-minute compile stall.
DEFAULT_BUCKETS_MS = (
    0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 200.0, 500.0, 1_000.0, 2_000.0, 5_000.0, 10_000.0,
    30_000.0, 120_000.0, 600_000.0,
)


class Counter:
    """Monotonic counter. ``add`` is the only mutator."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()
        self._value = 0.0

    def add(self, n: float = 1.0) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-written value; ``None`` until first set."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()
        self._value: float | None = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float | None:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with interpolated percentiles.

    ``bounds`` are bucket UPPER edges (ascending); one implicit
    overflow bucket catches everything above the last bound.
    ``percentile(p)`` walks the cumulative counts to the bucket the
    rank lands in and interpolates linearly between the bucket's
    edges, clamped to the exact observed ``min``/``max`` — coarse by
    construction (the fixed-bucket trade), but monotone and bounded.
    """

    __slots__ = ("name", "bounds", "_lock", "_counts", "count", "sum",
                 "min", "max", "_exemplars")

    def __init__(self, name: str, buckets=None):
        self.name = name
        self.bounds = tuple(sorted(float(b) for b in
                                   (buckets or DEFAULT_BUCKETS_MS)))
        if not self.bounds:
            raise ValueError(f"histogram {self.name!r} needs >= 1 bucket")
        self._lock = threading.RLock()
        self._counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        # bucket index -> (value, exemplar id): the LAST exemplar-tagged
        # observation to land in each bucket.
        self._exemplars: dict[int, tuple[float, str]] = {}

    def observe(self, v: float, exemplar: str | None = None) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if exemplar is not None:
                self._exemplars[i] = (v, str(exemplar))

    def exemplars(self) -> dict[str, dict]:
        """Per-bucket exemplars keyed by the bucket's upper edge
        (``"+Inf"`` for overflow): ``{le: {"value", "trace_id"}}``.
        :func:`tail_exemplar` picks the slowest one — the id that
        resolves a p99 figure to one concrete merged request trace."""
        with self._lock:
            items = dict(self._exemplars)
        out = {}
        for i, (v, ex) in sorted(items.items()):
            le = (f"{self.bounds[i]:g}" if i < len(self.bounds)
                  else "+Inf")
            out[le] = {"value": round(v, 6), "trace_id": ex}
        return out

    def percentile(self, p: float) -> float | None:
        """Interpolated p-quantile (``p`` in [0, 1]); None when empty."""
        if not (0.0 <= p <= 1.0):
            raise ValueError(f"percentile wants p in [0, 1], got {p}")
        with self._lock:
            if self.count == 0:
                return None
            target = p * self.count
            cum = 0
            for i, c in enumerate(self._counts):
                if c == 0:
                    continue
                if cum + c >= target:
                    lb = self.bounds[i - 1] if i > 0 else self.min
                    ub = (self.bounds[i] if i < len(self.bounds)
                          else self.max)
                    lb = max(lb, self.min)
                    ub = min(ub, self.max) if ub is not None else self.max
                    if ub <= lb:
                        return float(lb)
                    frac = (target - cum) / c
                    return float(lb + frac * (ub - lb))
                cum += c
            return float(self.max)

    def bucket_counts(self) -> tuple[tuple, list, int, float]:
        """One consistent read of the raw per-bucket counts (ascending
        ``bounds`` + the overflow slot) with count/sum — what the
        Prometheus histogram exposition is built from."""
        with self._lock:
            return self.bounds, list(self._counts), self.count, self.sum

    def summary(self) -> dict:
        with self._lock:
            count, total = self.count, self.sum
            vmin, vmax = self.min, self.max
        if count == 0:
            return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                    "max": None, "p50": None, "p95": None, "p99": None}
        out = {
            "count": count,
            "sum": round(total, 6),
            "mean": round(total / count, 6),
            "min": round(vmin, 6),
            "max": round(vmax, 6),
            "p50": round(self.percentile(0.50), 6),
            "p95": round(self.percentile(0.95), 6),
            "p99": round(self.percentile(0.99), 6),
        }
        exemplars = self.exemplars()
        if exemplars:
            out["exemplars"] = exemplars
        return out


class MetricsRegistry:
    """Name → instrument map with get-or-create accessors.

    Re-requesting a name returns the SAME instrument; requesting it as
    a different kind is an error (two subsystems silently splitting one
    name across kinds would corrupt every export).
    """

    def __init__(self):
        self._lock = threading.RLock()
        self._items: dict[str, object] = {}

    def _get(self, name: str, kind, factory):
        with self._lock:
            item = self._items.get(name)
            if item is None:
                item = self._items[name] = factory()
            elif not isinstance(item, kind):
                raise TypeError(
                    f"metric {name!r} is a {type(item).__name__}, "
                    f"requested as {kind.__name__}"
                )
            return item

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get(name, Histogram,
                         lambda: Histogram(name, buckets=buckets))

    def peek(self, name: str) -> float | None:
        """NON-CREATING read of a counter/gauge value (None when the
        instrument does not exist, or is a histogram). Read-only
        consumers — the /healthz endpoint above all — must never
        create instruments as a scrape side effect: a phantom
        None-valued gauge would pollute every later snapshot of a run
        that never touched that subsystem."""
        with self._lock:
            item = self._items.get(name)
        if isinstance(item, (Counter, Gauge)):
            return item.value
        return None

    def reset(self) -> None:
        """Drop every instrument (a new run's clean slate; tests)."""
        with self._lock:
            self._items.clear()

    def snapshot(self) -> dict:
        """One point-in-time export of every instrument."""
        with self._lock:
            items = dict(self._items)
        out = {"ts": round(time.time(), 3), "counters": {}, "gauges": {},
               "histograms": {}}
        for name in sorted(items):
            item = items[name]
            if isinstance(item, Counter):
                out["counters"][name] = item.value
            elif isinstance(item, Gauge):
                out["gauges"][name] = item.value
            elif isinstance(item, Histogram):
                out["histograms"][name] = item.summary()
        return out

    def export_jsonl(self, path: str) -> dict:
        """Append one snapshot line to ``path`` (best-effort by the
        journal contract: telemetry must never kill the run it
        narrates). Returns the snapshot either way."""
        snap = self.snapshot()
        try:
            durable.append_line_path(path, json.dumps(snap),
                                     path_class="obs",
                                     best_effort=True)
        except (TypeError, ValueError):
            pass
        return snap

    def prometheus_text(self, prefix: str = "fm_spark",
                        labels: dict | None = None) -> str:
        """Prometheus exposition-format dump: counters/gauges as-is,
        histograms in NATIVE histogram format — cumulative
        ``_bucket{le="..."}`` lines (one per bound, plus the mandatory
        ``+Inf``) with ``_sum``/``_count``. The live ``/metrics``
        endpoint serves this
        to real scrapers, so the bucket lines are the real exposition
        contract, not a summary approximation. ``labels`` (e.g.
        ``{"run_id": ...}``) attach to every sample; values are escaped
        per the exposition rules (backslash, double-quote, newline)."""

        def clean(name: str) -> str:
            safe = "".join(c if c.isalnum() or c == "_" else "_"
                           for c in name)
            return f"{prefix}_{safe}" if prefix else safe

        def esc(v) -> str:
            return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                    .replace("\n", "\\n"))

        def lab(extra: dict | None = None) -> str:
            items = dict(labels or {})
            if extra:
                items.update(extra)
            if not items:
                return ""
            return ("{" + ",".join(f'{k}="{esc(v)}"'
                                   for k, v in items.items()) + "}")

        def num(v: float) -> str:
            # Full-precision sample values: '%g' keeps 6 significant
            # digits, which quantizes a large counter so hard that
            # rate() over consecutive scrapes reads zero — integers
            # render as integers, floats shortest-round-trip.
            f = float(v)
            return str(int(f)) if f.is_integer() else repr(f)

        with self._lock:
            items = dict(self._items)
        lines = []
        for name in sorted(items):
            item = items[name]
            m = clean(name)
            if isinstance(item, Counter):
                lines.append(f"# TYPE {m} counter")
                lines.append(f"{m}{lab()} {num(item.value)}")
            elif isinstance(item, Gauge):
                v = item.value
                if v is None:
                    continue
                lines.append(f"# TYPE {m} gauge")
                lines.append(f"{m}{lab()} {num(v)}")
            elif isinstance(item, Histogram):
                bounds, counts, count, total = item.bucket_counts()
                if not count:
                    continue
                exemplars = item.exemplars()
                lines.append(f"# TYPE {m} histogram")
                cum = 0
                for b, c in zip(bounds, counts):
                    cum += c
                    line = f'{m}_bucket{lab({"le": f"{b:g}"})} {cum}'
                    ex = exemplars.get(f"{b:g}")
                    if ex:
                        # OpenMetrics exemplar suffix: the trace_id
                        # that landed in this bucket last (tail
                        # buckets -> the p99's concrete request).
                        line += (f' # {{trace_id="{esc(ex["trace_id"])}"'
                                 f'}} {num(ex["value"])}')
                    lines.append(line)
                line = f'{m}_bucket{lab({"le": "+Inf"})} {count}'
                ex = exemplars.get("+Inf")
                if ex:
                    line += (f' # {{trace_id="{esc(ex["trace_id"])}"}} '
                             f'{num(ex["value"])}')
                lines.append(line)
                lines.append(f"{m}_sum{lab()} {num(total)}")
                lines.append(f"{m}_count{lab()} {count}")
        return "\n".join(lines) + ("\n" if lines else "")

    def bucket_snapshot(self) -> dict:
        """Raw per-histogram bucket counts + exemplars — the fleet
        metrics rollup's wire format (``/metrics.json`` on a replica):
        summaries cannot be aggregated across processes, raw bucket
        counts can (element-wise sum over identical bounds)."""
        with self._lock:
            items = dict(self._items)
        out = {}
        for name in sorted(items):
            item = items[name]
            if not isinstance(item, Histogram):
                continue
            bounds, counts, count, total = item.bucket_counts()
            out[name] = {
                "bounds": list(bounds),
                "counts": counts,
                "count": count,
                "sum": round(total, 6),
                "exemplars": item.exemplars(),
            }
        return out


_GLOBAL = MetricsRegistry()


def registry() -> MetricsRegistry:
    """The process-wide registry every subsystem shares."""
    return _GLOBAL


def counter(name: str) -> Counter:
    return _GLOBAL.counter(name)


def gauge(name: str) -> Gauge:
    return _GLOBAL.gauge(name)


def histogram(name: str, buckets=None) -> Histogram:
    return _GLOBAL.histogram(name, buckets)
