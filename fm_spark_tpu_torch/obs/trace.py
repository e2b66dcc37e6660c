"""Span tracing (the port's copy of ``fm_spark_tpu/obs/trace.py``): a
span is a named interval with a monotonic-clock duration, a
process-unique id and the id of the span it nests inside (a per-thread
parent stack), emitted as one JSONL record through an
:class:`~fm_spark_tpu_torch.utils.logging.EventLog` sink (``event:
"span"``) and mirrored into the flight recorder's ring, so the last-N
window survives a crash.

The disabled path is nearly free: :meth:`Tracer.span` on a disabled
tracer returns a shared no-op singleton (no allocation, trivial
``__enter__``/``__exit__``), and the instrumented loops latch
``obs.enabled()`` once, so per-step work is one attribute check. A span
reads only the host clock: it adds no device synchronisation, so a span
around a CUDA graph's replay times the host's dispatch of it.

Usage::

    with obs.span("train/eval", step=120) as sp:
        metrics = evaluate(...)
        sp.set(auc=metrics["auc"])
"""

from __future__ import annotations

import functools
import itertools
import os
import random
import re
import threading
import time

__all__ = ["NOOP_SPAN", "Span", "TraceContext", "TRACE_HEADER",
           "Tracer", "mint_trace"]

_SEQ = itertools.count(1)
_TLS = threading.local()

#: The cross-process propagation header: every HTTP hop
#: inside the serving fleet carries ``X-FM-Trace: <trace_id>;<parent
#: span_id>`` so spans minted in different processes stitch into one
#: request timeline.
TRACE_HEADER = "X-FM-Trace"

_TOKEN_RE = re.compile(r"[A-Za-z0-9][A-Za-z0-9_\-]{0,63}$")


class TraceContext:
    """Cross-process trace identity: the request's ``trace_id`` plus the
    span_id of the hop that handed it over (the remote parent).

    Stdlib-only and deliberately tiny — two string slots and a header
    codec. A context is minted ONCE per accepted request at the front
    door (:func:`mint_trace`) and re-derived at every hop via
    :meth:`child`, so each process's spans carry the same ``trace``
    attribute and a ``remote_parent`` link into the upstream process.
    """

    __slots__ = ("trace_id", "parent_span_id")

    def __init__(self, trace_id: str, parent_span_id: str | None = None):
        self.trace_id = str(trace_id)
        self.parent_span_id = parent_span_id

    def child(self, span_id: str | None) -> "TraceContext":
        """The context to hand DOWNSTREAM from a hop whose span is
        ``span_id`` (None — e.g. tracing disabled locally — keeps the
        current parent so the chain degrades, never breaks)."""
        if span_id is None:
            return self
        return TraceContext(self.trace_id, str(span_id))

    def to_header(self) -> str:
        return f"{self.trace_id};{self.parent_span_id or ''}"

    @classmethod
    def from_header(cls, value) -> "TraceContext | None":
        """Parse an ``X-FM-Trace`` header value; junk (None, empty,
        malformed, oversized tokens) returns None — an untrusted peer
        must never crash the replica's request path."""
        if not value or not isinstance(value, str):
            return None
        trace_id, _, parent = value.partition(";")
        trace_id = trace_id.strip()
        parent = parent.strip()
        if not _TOKEN_RE.match(trace_id):
            return None
        if parent and not _TOKEN_RE.match(parent):
            parent = ""
        return cls(trace_id, parent or None)

    def __repr__(self):
        return (f"TraceContext({self.trace_id!r}, "
                f"{self.parent_span_id!r})")


def mint_trace(sample: float = 1.0) -> TraceContext | None:
    """Mint a fresh request trace, or None when sampled out.

    ``sample`` is the kept fraction (the ``--trace-sample`` knob):
    1.0 traces every request (the test default), 0.0 none. The id is
    ``os.urandom`` hex — unique across the fleet's processes without
    any coordination.
    """
    if sample < 1.0 and random.random() >= sample:
        return None
    return TraceContext(os.urandom(8).hex())


def _stack() -> list:
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
    return st


class _NoopSpan:
    """Shared do-nothing span: the disabled fast path (no allocation)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


NOOP_SPAN = _NoopSpan()


class Span:
    """One named interval. Use as a context manager; ``set()`` attaches
    attributes any time before exit (they ride the emitted record)."""

    __slots__ = ("tracer", "name", "attrs", "span_id", "parent_id",
                 "ts", "_t0", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self.tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = None
        self.parent_id = None
        self.ts = 0.0
        self._t0 = 0.0
        self.dur_s = 0.0

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        st = _stack()
        self.parent_id = st[-1].span_id if st else None
        self.span_id = f"{os.getpid():x}-{next(_SEQ):x}"
        self.ts = time.time()
        st.append(self)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.dur_s = time.perf_counter() - self._t0
        st = _stack()
        if st and st[-1] is self:
            st.pop()
        else:
            # Mis-nested manual open/close: drop this span wherever it
            # sits rather than corrupting the siblings' parentage.
            try:
                st.remove(self)
            except ValueError:
                pass
        if exc_type is not None:
            self.attrs.setdefault("error", exc_type.__name__)
        self.tracer._finish(self)
        return False


class Tracer:
    """Span factory bound to a JSONL sink + flight-recorder ring.

    ``sink`` is anything with ``emit(event, **fields)`` (an
    :class:`~fm_spark_tpu_torch.utils.logging.EventLog`); ``flight`` anything
    with ``record(kind, **fields)``. Both optional and best-effort —
    tracing must never take down the operation it narrates.
    """

    def __init__(self, sink=None, flight=None, enabled: bool = True):
        self.sink = sink
        self.flight = flight
        self.enabled = bool(enabled)

    def span(self, name: str, **attrs):
        if not self.enabled:
            return NOOP_SPAN
        return Span(self, name, attrs)

    def traced(self, name: str | None = None):
        """Decorator form; the label defaults to the qualname."""

        def deco(fn):
            label = name or fn.__qualname__

            @functools.wraps(fn)
            def wrapper(*args, **kwargs):
                if not self.enabled:
                    return fn(*args, **kwargs)
                with Span(self, label, {}):
                    return fn(*args, **kwargs)

            return wrapper

        return deco

    def emit_span(self, name: str, t_start: float, dur_s: float,
                  **attrs) -> None:
        """Emit a RETROACTIVE span record for an interval timed by the
        caller (``t_start`` wall-clock, ``dur_s`` monotonic duration).
        For windows that outlive any single ``with`` block — e.g. the
        trainer's log windows, where holding an open span across loop
        iterations would leak it onto the parent stack on an exception
        mid-window. Parented to the current innermost open span."""
        if not self.enabled:
            return
        sp = Span(self, name, attrs)
        st = _stack()
        sp.parent_id = st[-1].span_id if st else None
        sp.span_id = f"{os.getpid():x}-{next(_SEQ):x}"
        sp.ts = float(t_start)
        sp.dur_s = float(dur_s)
        self._finish(sp)

    def _finish(self, span: Span) -> None:
        fields = {
            "name": span.name,
            "span_id": span.span_id,
            "parent_id": span.parent_id,
            "t_start": round(span.ts, 6),
            "dur_ms": round(span.dur_s * 1e3, 3),
            "thread": threading.get_ident(),
        }
        for k, v in span.attrs.items():
            fields.setdefault(k, v)
        try:
            if self.sink is not None:
                self.sink.emit("span", **fields)
            if self.flight is not None:
                self.flight.record("span", **fields)
        except Exception:
            pass
