"""Process-wide metrics registry: counters, gauges, fixed-bucket
histograms (a reduced copy of ``fm_spark_tpu/obs/metrics.py``: the
serving engine's ``serve.*`` counters and histograms, the tiered store's
``embed/*`` gauges, the online loop's ``online/*`` gauges). Thread-safe;
its exports (Prometheus text, JSONL snapshots) wait for the rest of the
obs plane (ROADMAP Queue 1 item 13)."""

from __future__ import annotations

import bisect
import threading

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "counter",
           "gauge", "histogram", "registry"]

#: Default histogram bucket upper bounds, in milliseconds.
DEFAULT_BUCKETS_MS = (
    0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0, 20.0, 50.0,
    100.0, 200.0, 500.0, 1_000.0, 2_000.0, 5_000.0, 10_000.0,
    30_000.0, 120_000.0, 600_000.0,
)


class Counter:
    """Monotonic counter. ``add`` is the only mutator."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
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

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value: float | None = None

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    @property
    def value(self) -> float | None:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with percentiles interpolated inside the
    bucket the rank lands in, clamped to the observed min/max."""

    def __init__(self, name: str, buckets=None):
        self.name = name
        self.bounds = tuple(sorted(float(b) for b in
                                   (buckets or DEFAULT_BUCKETS_MS)))
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None

    def observe(self, v: float) -> None:
        v = float(v)
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self._counts[i] += 1
            self.count += 1
            self.sum += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)

    def percentile(self, p: float) -> float | None:
        """Interpolated p-quantile (``p`` in [0, 1]); None when empty."""
        if not 0.0 <= p <= 1.0:
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
                    lb = max(self.bounds[i - 1] if i > 0 else self.min, self.min)
                    ub = min(self.bounds[i] if i < len(self.bounds)
                             else self.max, self.max)
                    if ub <= lb:
                        return float(lb)
                    return float(lb + (target - cum) / c * (ub - lb))
                cum += c
            return float(self.max)

    def summary(self) -> dict:
        with self._lock:
            count, total, vmin, vmax = self.count, self.sum, self.min, self.max
        if count == 0:
            return {"count": 0, "sum": 0.0, "mean": None, "min": None,
                    "max": None, "p50": None, "p95": None, "p99": None}
        return {"count": count, "sum": total, "mean": total / count,
                "min": vmin, "max": vmax, "p50": self.percentile(0.50),
                "p95": self.percentile(0.95), "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Name → instrument map with get-or-create accessors; asking for a
    name as another kind than it was created is an error."""

    def __init__(self):
        self._lock = threading.Lock()
        self._items: dict[str, object] = {}

    def _get(self, name, kind, factory):
        with self._lock:
            item = self._items.get(name)
            if item is None:
                item = self._items[name] = factory()
            elif not isinstance(item, kind):
                raise TypeError(f"metric {name!r} is a {type(item).__name__}, "
                                f"requested as {kind.__name__}")
            return item

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str, buckets=None) -> Histogram:
        return self._get(name, Histogram, lambda: Histogram(name, buckets))

    def reset(self) -> None:
        """Drop every instrument (a new run's clean slate; tests)."""
        with self._lock:
            self._items.clear()

    def snapshot(self) -> dict:
        """One point-in-time export of every instrument."""
        with self._lock:
            items = dict(self._items)
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(items):
            item = items[name]
            if isinstance(item, Counter):
                out["counters"][name] = item.value
            elif isinstance(item, Gauge):
                out["gauges"][name] = item.value
            else:
                out["histograms"][name] = item.summary()
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
