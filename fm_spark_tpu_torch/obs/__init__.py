"""The port's telemetry plane (a reduced copy of ``fm_spark_tpu/obs``).

- :mod:`.metrics`: the process-wide registry of counters, gauges and
  histograms, re-exported here (``obs.counter``, ``obs.gauge``...);
- the run id (:func:`new_run_id`, :func:`run_id`), named spans
  (:func:`span`) and events (:func:`event`): both go to the sink that
  :func:`configure` names, a :class:`~fm_spark_tpu_torch.utils.logging
  .EventLog`, and are dropped while none is configured (the reference's
  plane switched off: one attribute check, no allocation on the hot
  path);
- :mod:`.ledger` and :mod:`.sentinel`: the quality ledger and its
  regression sentinel (the online loop's ``quality_eval`` records).

The reference's trace export, flight recorder, run directory and live
introspection are not ported yet (ROADMAP Queue 1 item 13).
"""

from __future__ import annotations

import os
import threading
import time

from fm_spark_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                            MetricsRegistry, counter, gauge,
                                            histogram, registry)

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry", "configure",
           "counter", "enabled", "event", "gauge", "histogram",
           "new_run_id", "registry", "run_id", "shutdown", "span"]

_lock = threading.Lock()
_state = {"sink": None, "run_id": None}


def new_run_id() -> str:
    """UTC-timestamped, pid-suffixed run id (the reference's form)."""
    return time.strftime("%Y%m%d-%H%M%S", time.gmtime()) + f"-p{os.getpid()}"


def configure(sink, run_id: str | None = None) -> str:
    """Send spans and events to ``sink`` (an object with ``emit(event,
    **fields)``, such as an ``EventLog``) under ``run_id`` (a new one by
    default); returns the run id."""
    with _lock:
        _state.update(sink=sink, run_id=run_id or new_run_id())
        return _state["run_id"]


def shutdown() -> None:
    """Stop recording (the sink is the caller's to close)."""
    with _lock:
        _state.update(sink=None, run_id=None)


def enabled() -> bool:
    return _state["sink"] is not None


def run_id() -> str | None:
    """The configured run's id, None while nothing is configured."""
    return _state["run_id"]


class _NoopSpan:
    """The shared span of an unconfigured plane."""

    __slots__ = ()

    def set(self, **attrs) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class Span:
    """One named interval: emitted at exit as a ``span`` event with its
    ``t_start``, ``dur_ms`` and attributes (``set`` adds more)."""

    __slots__ = ("sink", "name", "attrs", "ts", "_t0")

    def __init__(self, sink, name: str, attrs: dict):
        self.sink = sink
        self.name = name
        self.attrs = attrs
        self.ts = 0.0
        self._t0 = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        self.ts = time.time()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        dur_ms = (time.perf_counter() - self._t0) * 1e3
        fields = {"name": self.name, "t_start": round(self.ts, 6),
                  "dur_ms": round(dur_ms, 3), **self.attrs}
        if exc_type is not None:
            fields["error"] = exc_type.__name__
        try:
            self.sink.emit("span", **fields)
        except Exception:       # noqa: BLE001 — telemetry is best-effort
            pass
        return False


def span(name: str, **attrs):
    """A timing context for ``name``, or the shared no-op while no sink
    is configured."""
    sink = _state["sink"]
    if sink is None:
        return NOOP_SPAN
    return Span(sink, name, attrs)


def event(kind: str, **fields) -> None:
    """Record one event to the sink (dropped while none is configured;
    best-effort)."""
    sink = _state["sink"]
    if sink is None:
        return
    try:
        fields.pop("event", None)
        sink.emit(kind, **fields)
    except Exception:           # noqa: BLE001 — telemetry is best-effort
        pass
