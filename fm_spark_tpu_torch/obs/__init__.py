"""The port's telemetry plane (the port of ``fm_spark_tpu/obs``): span
tracing, metrics, the flight recorder, deep captures and the live
endpoint, under one per-run directory (``<obs-dir>/<run_id>/``):

======================  ====================================================
``trace.jsonl``         span records (:mod:`.trace`)
``metrics.jsonl``       registry snapshots (:mod:`.metrics`)
``flight.jsonl``        flight-recorder spool: last-N window, SIGKILL-safe
``flight_dump.json``    atomic last-N dump on a fault, SIGTERM or run end
``captures/``           trigger-fired capture bundles (:mod:`.introspect`)
``serve_health.jsonl``  the serving journal (``fmtorch serve``)
``deadletter.jsonl``    the quarantine's dead-letter journal, when
                        ``--quarantine-dir`` is not given
======================  ====================================================

This module is the facade the rest of the port calls. Everything is a
cheap no-op until :func:`configure` runs: library code instruments
unconditionally and an unobserved process pays one attribute check (the
shared :data:`NOOP_SPAN`, no registry write from a span or an event).
The metrics registry is the exception: it is always live (memory only).
:mod:`.ledger` and :mod:`.sentinel` hold the quality ledger and its
regression sentinel; :mod:`.export` the ``/metrics`` and ``/healthz``
endpoint.
"""

from __future__ import annotations

import functools
import os
import signal as _signal
import threading
import time

from fm_spark_tpu_torch.obs import introspect
from fm_spark_tpu_torch.obs import trace as _trace_mod
from fm_spark_tpu_torch.obs.flight import FlightRecorder, read_spool
from fm_spark_tpu_torch.obs.metrics import (Counter, Gauge, Histogram,
                                            MetricsRegistry, counter, gauge,
                                            histogram, registry)
from fm_spark_tpu_torch.obs.trace import (NOOP_SPAN, TRACE_HEADER, Span,
                                          TraceContext, Tracer)

__all__ = [
    "FAULT_KINDS",
    "NOOP_SPAN",
    "TRACE_HEADER",
    "Counter",
    "FlightRecorder",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "Span",
    "TraceContext",
    "Tracer",
    "configure",
    "counter",
    "device_memory_snapshot",
    "emit_span",
    "enabled",
    "event",
    "export_snapshot",
    "fault_timeline",
    "flight_dump",
    "gauge",
    "histogram",
    "install_signal_dump",
    "introspect",
    "is_signal_dump",
    "mint_trace",
    "new_run_id",
    "read_spool",
    "registry",
    "run_dir",
    "run_id",
    "shutdown",
    "signal_dump",
    "span",
    "telemetry_block",
    "traced",
]

TRACE_FILE = "trace.jsonl"
METRICS_FILE = "metrics.jsonl"
FLIGHT_FILE = "flight.jsonl"
FLIGHT_DUMP_FILE = "flight_dump.json"

#: Event kinds that belong on a run's fault and retry timeline (the
#: health journals' transitions, the ingest and checkpoint failures, the
#: near misses and SLO overruns and the captures they fired): what
#: :func:`fault_timeline` returns.
FAULT_KINDS = frozenset({
    "failure", "backoff", "attempt", "probe",
    "circuit_open", "circuit_half_open", "circuit_rejected",
    "permanent_fault", "recovered", "supervisor_reset",
    "fault_classified", "mesh_shrink", "elastic_exhausted",
    "divergence_detected", "divergence_rollback",
    "divergence_rollback_exhausted",
    "ingest_aborted", "bad_record",
    "checkpoint_corrupt", "checkpoint_unverified_skipped",
    "checkpoint_unreadable", "checkpoint_walked_back",
    "backend_init_timeout", "down",
    "hang_detected", "reload_failed", "serve_batch_failed",
    "watchdog_near_miss", "serve_slo_overrun", "capture_fired",
})

_lock = threading.Lock()
_state = {"dir": None, "run_id": None, "tracer": None, "flight": None,
          "sink": None}
_prev_handlers: dict[int, object] = {}


def new_run_id() -> str:
    """UTC-timestamped, pid-suffixed run id: sortable and unique enough
    for one host's runs."""
    return time.strftime("%Y%m%d-%H%M%S", time.gmtime()) + f"-p{os.getpid()}"


def configure(obs_dir: str, run_id: str | None = None,
              enabled: bool = True, flight_capacity: int = 256,
              install_signals: bool = False,
              reset_metrics: bool = True) -> str:
    """Point the telemetry plane at a run directory and arm it.

    Creates ``obs_dir``, opens the trace sink (``trace.jsonl``) and the
    flight spool (``flight.jsonl``, appended, so a retried run re-entering
    its run dir continues the window), and (by default) resets the
    process-wide metrics registry. Replaces any previous configuration
    (shut down first). With ``install_signals``, SIGTERM dumps the flight
    window and a metrics snapshot before the handler it displaced runs
    (:func:`install_signal_dump`). Returns the run id.
    """
    shutdown(reason=None)
    obs_dir = os.path.abspath(str(obs_dir))
    os.makedirs(obs_dir, exist_ok=True)
    from fm_spark_tpu_torch.utils.logging import EventLog

    if reset_metrics:
        registry().reset()
    sink = EventLog(os.path.join(obs_dir, TRACE_FILE), keep=False)
    flight = FlightRecorder(flight_capacity,
                            spool_path=os.path.join(obs_dir, FLIGHT_FILE))
    tracer = Tracer(sink=sink, flight=flight, enabled=enabled)
    with _lock:
        _state.update(dir=obs_dir, run_id=run_id or new_run_id(),
                      tracer=tracer, flight=flight, sink=sink)
    flight.record("run_start", run_id=_state["run_id"])
    if install_signals:
        install_signal_dump()
    return _state["run_id"]


def shutdown(reason: str | None = "run_end") -> None:
    """Flush and close the telemetry plane (a no-op when unconfigured).
    With a ``reason``, a final metrics snapshot and flight dump are
    written first, so a clean end leaves the artifacts a fault would, and
    the live endpoint's thread is stopped. The capture engine is
    disarmed (a bounded trace it still runs is stopped)."""
    with _lock:
        flight, sink = _state["flight"], _state["sink"]
        d = _state["dir"]
        _state.update(dir=None, run_id=None, tracer=None, flight=None,
                      sink=None)
    introspect.clear()
    if reason is not None:
        try:
            from fm_spark_tpu_torch.obs import export as _export

            _export.stop_metrics_server()
        except Exception:
            pass
    if flight is None:
        return
    try:
        if reason is not None:
            flight.record(reason)
            registry().export_jsonl(os.path.join(d, METRICS_FILE))
            flight.dump(reason)
        flight.close()
        if sink is not None:
            sink.close()
    except Exception:
        pass


def enabled() -> bool:
    tr = _state["tracer"]
    return tr is not None and tr.enabled


def run_dir() -> str | None:
    """The configured run's directory, None while nothing is configured."""
    return _state["dir"]


def run_id() -> str | None:
    """The configured run's id, None while nothing is configured."""
    return _state["run_id"]


# ------------------------------------------------------------------ spans

def span(name: str, **attrs):
    """A span context manager, or the shared no-op when unconfigured."""
    tr = _state["tracer"]
    if tr is None:
        return NOOP_SPAN
    return tr.span(name, **attrs)


def emit_span(name: str, t_start: float, dur_s: float, **attrs) -> None:
    """A span record for an interval the caller timed
    (:meth:`Tracer.emit_span`); no-op when unconfigured."""
    tr = _state["tracer"]
    if tr is not None:
        tr.emit_span(name, t_start, dur_s, **attrs)


def mint_trace(sample: float = 1.0) -> TraceContext | None:
    """A per-request :class:`TraceContext`, or None when tracing is off
    or the request is sampled out (one tracer check when off)."""
    tr = _state["tracer"]
    if tr is None or not tr.enabled:
        return None
    return _trace_mod.mint_trace(sample)


def traced(name: str | None = None):
    """Decorator form of :func:`span`; binds the tracer at CALL time, so
    decoration at import (before :func:`configure`) still traces."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            tr = _state["tracer"]
            if tr is None or not tr.enabled:
                return fn(*args, **kwargs)
            with tr.span(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco


# ----------------------------------------------------------------- events

def event(kind: str, **fields) -> None:
    """Record one event into the flight ring (no-op when unconfigured;
    best-effort)."""
    flight = _state["flight"]
    if flight is None:
        return
    try:
        fields.pop("seq", None)
        fields.pop("kind", None)
        flight.record(kind, **fields)
    except Exception:
        pass


def flight_dump(reason: str, path: str | None = None,
                **extra) -> str | None:
    """Atomically dump the last-N window now (fault endings call this).
    ``path`` overrides the default ``flight_dump.json`` (a capture bundle
    dumps into itself, so a later default dump never overwrites it)."""
    flight = _state["flight"]
    if flight is None:
        return None
    return flight.dump(reason, path=path, extra=extra or None)


def fault_timeline(limit: int = 50) -> list[dict]:
    """The flight ring filtered to :data:`FAULT_KINDS`, oldest first,
    capped to the most recent ``limit``."""
    flight = _state["flight"]
    if flight is None:
        return []
    out = [e for e in flight.events() if e.get("kind") in FAULT_KINDS]
    return out[-max(int(limit), 0):]


# ---------------------------------------------------------------- metrics

def export_snapshot() -> dict | None:
    """Append one registry snapshot to the run dir's ``metrics.jsonl``
    (no-op without a run dir)."""
    d = _state["dir"]
    if d is None:
        return None
    return registry().export_jsonl(os.path.join(d, METRICS_FILE))


def device_memory_snapshot(device=None) -> dict | None:
    """The card's memory watermarks into the registry:
    ``device.bytes_in_use`` (``torch.cuda.memory_allocated``) and
    ``device.peak_bytes_in_use`` (``max_memory_allocated``), the
    counterparts of the reference's PJRT figures. torch is only looked
    up, never imported; None when it is not loaded or has no card."""
    import sys

    torch = sys.modules.get("torch")
    if torch is None:
        return None
    try:
        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return None
        in_use = int(torch.cuda.memory_allocated(device))
        peak = int(torch.cuda.max_memory_allocated(device))
    except Exception:
        return None
    reg = registry()
    reg.gauge("device.bytes_in_use").set(in_use)
    reg.gauge("device.peak_bytes_in_use").set(peak)
    return {"bytes_in_use": in_use, "peak_bytes_in_use": peak}


def telemetry_block() -> dict:
    """The run's headline telemetry as one JSON-ready block: step-time
    percentiles (the ``step_time_ms`` histogram), ingest accounting, the
    card's memory watermarks and the fault timeline."""
    reg = registry()
    step = reg.histogram("step_time_ms").summary()
    return {
        "run_id": _state["run_id"],
        "obs_dir": _state["dir"],
        "step_time_ms": {k: step[k] for k in
                         ("count", "mean", "p50", "p95", "p99")},
        "ingest_rows_per_sec": reg.gauge("ingest.rows_per_sec").value,
        "ingest_rows_total": reg.counter("ingest.rows_ok_total").value,
        "ingest_quarantined_total":
            reg.counter("ingest.rows_quarantined_total").value,
        "device_memory": {
            "bytes_in_use": reg.gauge("device.bytes_in_use").value,
            "peak_bytes_in_use": reg.gauge(
                "device.peak_bytes_in_use").value,
        },
        "fault_events": [
            {k: v for k, v in e.items() if k != "seq"}
            for e in fault_timeline()
        ],
    }


# ---------------------------------------------------------------- signals

def signal_dump(signum) -> None:
    """The flight dump and metrics snapshot a signal leaves: what
    :func:`install_signal_dump`'s handler writes before it delegates, and
    what ``checkpoint.PreemptionGuard`` writes when the handler it
    displaced is that one (its own save-and-stop is then the ending)."""
    event("signal", signum=int(signum))
    flight_dump(f"signal:{signum}")
    export_snapshot()


def is_signal_dump(handler) -> bool:
    """Whether ``handler`` is :func:`install_signal_dump`'s."""
    return handler is _signal_handler


def _signal_handler(signum, frame):
    signal_dump(signum)
    prev = _prev_handlers.get(signum)
    if callable(prev):
        prev(signum, frame)
    elif prev != _signal.SIG_IGN:
        # SIG_DFL, or None (a handler installed from C that cannot be
        # re-invoked): restore the default action and re-raise, so the
        # signal still ends the process.
        _signal.signal(signum, _signal.SIG_DFL)
        os.kill(os.getpid(), signum)


def install_signal_dump(signals=(_signal.SIGTERM,)) -> bool:
    """Chain a dump-then-delegate handler onto ``signals``, so a SIGTERM
    leaves the last-N window on disk before whatever handler it displaced
    runs (the checkpoint's ``PreemptionGuard`` installed later chains
    this one in turn, so both run). Main thread only (the signal API's
    rule); returns whether it installed."""
    if threading.current_thread() is not threading.main_thread():
        return False
    for sig in signals:
        prev = _signal.getsignal(sig)
        if prev is _signal_handler:
            continue
        _prev_handlers[sig] = prev
        _signal.signal(sig, _signal_handler)
    return True
