"""Scrapeable live-metrics endpoint (the port's copy of
``fm_spark_tpu/obs/export.py``): inspect a running ``fmtorch train`` or
``fmtorch serve`` without touching the process. The telemetry plane is
served over stdlib HTTP (:class:`http.server.ThreadingHTTPServer` on a
daemon thread: no new dependency, nothing on the request path of the
loop being observed):

``GET /metrics``
    the process-wide registry's Prometheus text
    (:meth:`~fm_spark_tpu_torch.obs.metrics.MetricsRegistry.prometheus_text`),
    with a ``run_id`` label on every sample when a run is configured;

``GET /healthz``
    one JSON document of liveness facts: ``run_id``, the served
    ``generation_step``, ``staleness_steps`` and ``degraded`` gauges,
    the supervisor's ``breaker_state`` gauge, the last sentinel verdict
    (:func:`note_sentinel_verdict`), the capture-bundle counts of the
    introspection engine, and the online loop's AUC.

The server binds ``127.0.0.1`` (an introspection port, not a service
port); port 0 asks the OS for an ephemeral one, which the CLIs echo as a
``{"metrics_port": N}`` JSON line. One process-wide server
(:func:`start_metrics_server` / :func:`stop_metrics_server`;
``obs.shutdown`` stops it); the handler never raises into the server's
threads. :func:`render_fleet_metrics` renders the serving fleet's rollup
(every replica's scraped registry) onto the front door's ``/metrics``.
"""

from __future__ import annotations

import http.server
import json
import threading
import time

from fm_spark_tpu_torch.obs.metrics import registry

__all__ = [
    "MetricsServer",
    "note_sentinel_verdict",
    "render_fleet_metrics",
    "start_metrics_server",
    "status",
    "stop_metrics_server",
]

_status_lock = threading.Lock()
_status: dict = {}


def render_fleet_metrics(rollup: dict | None,
                         prefix: str = "fm_spark_fleet") -> str:
    """Prometheus text for the fleet rollup: per-replica
    counters/gauges with a ``replica`` label, plus fleet-level
    histogram aggregates rebuilt from RAW bucket counts.

    ``rollup`` is :meth:`fm_spark_tpu_torch.serve.fleet.Fleet.metrics_rollup`
    output: ``{"replicas": {idx: {"pid", "snapshot", "buckets"}}}``
    where ``snapshot`` is a registry snapshot and ``buckets`` a
    :meth:`~fm_spark_tpu_torch.obs.metrics.MetricsRegistry.bucket_snapshot`.
    Per-replica percentile summaries are deliberately NOT merged —
    quantiles don't aggregate — instead bucket counts are summed
    element-wise (identical bounds only) and exposed as one cumulative
    ``_bucket{le=...}`` exposition per histogram name. Returns ``""``
    on an empty/None rollup; malformed replica docs are skipped, a
    scrape must never raise into the front door's handler thread.
    """
    if not rollup or not rollup.get("replicas"):
        return ""

    def clean(name: str) -> str:
        safe = "".join(c if c.isalnum() or c == "_" else "_"
                       for c in name)
        return f"{prefix}_{safe}" if prefix else safe

    def esc(v) -> str:
        return (str(v).replace("\\", "\\\\").replace('"', '\\"')
                .replace("\n", "\\n"))

    def num(v: float) -> str:
        f = float(v)
        return str(int(f)) if f.is_integer() else repr(f)

    lines: list[str] = []
    # name -> (bounds tuple, summed counts, count, sum)
    agg: dict[str, list] = {}
    typed: set[str] = set()
    for idx in sorted(rollup["replicas"]):
        doc = rollup["replicas"][idx]
        if not isinstance(doc, dict):
            continue
        snap = doc.get("snapshot") or {}
        lab = f'{{replica="{esc(idx)}"}}'
        for kind, ptype in (("counters", "counter"), ("gauges", "gauge")):
            for name in sorted(snap.get(kind) or {}):
                v = snap[kind][name]
                if v is None:
                    continue
                m = clean(name)
                if m not in typed:
                    typed.add(m)
                    lines.append(f"# TYPE {m} {ptype}")
                try:
                    lines.append(f"{m}{lab} {num(v)}")
                except (TypeError, ValueError):
                    continue
        for name, h in sorted((doc.get("buckets") or {}).items()):
            try:
                bounds = tuple(float(b) for b in h["bounds"])
                counts = [int(c) for c in h["counts"]]
                count, total = int(h["count"]), float(h["sum"])
            except (KeyError, TypeError, ValueError):
                continue
            if len(counts) != len(bounds) + 1:
                continue
            cur = agg.get(name)
            if cur is None:
                agg[name] = [bounds, counts, count, total]
            elif cur[0] == bounds:
                cur[1] = [a + b for a, b in zip(cur[1], counts)]
                cur[2] += count
                cur[3] += total
            # mismatched bounds: keep the first replica's series rather
            # than summing apples onto oranges
    for name in sorted(agg):
        bounds, counts, count, total = agg[name]
        if not count:
            continue
        m = clean(name)
        lines.append(f"# TYPE {m} histogram")
        cum = 0
        for b, c in zip(bounds, counts):
            cum += c
            lines.append(f'{m}_bucket{{le="{b:g}"}} {cum}')
        lines.append(f'{m}_bucket{{le="+Inf"}} {count}')
        lines.append(f"{m}_sum {num(total)}")
        lines.append(f"{m}_count {count}")
    return "\n".join(lines) + ("\n" if lines else "")


def note_sentinel_verdict(leg: str | None, block: dict | None) -> None:
    """Record the most recent sentinel verdict for ``/healthz`` (called
    best-effort by :meth:`fm_spark_tpu_torch.obs.sentinel.Sentinel.observe`)."""
    with _status_lock:
        _status["last_sentinel"] = {
            "leg": leg,
            "verdict": (block or {}).get("verdict"),
            "reason": (block or {}).get("reason"),
            "ts": round(time.time(), 3),
        }


def status() -> dict:
    with _status_lock:
        return dict(_status)


def _healthz_doc() -> dict:
    """The liveness document. Gauges are read from the live registry —
    the same instruments serving/supervision already maintain — so the
    endpoint adds no bookkeeping to the loops it observes."""
    from fm_spark_tpu_torch import obs
    from fm_spark_tpu_torch.obs import introspect

    reg = registry()

    # peek, never gauge(): a scrape is read-only — the get-or-create
    # accessor would conjure phantom serve/online gauges into every
    # later snapshot of a process that never serves.
    def g(name):
        return reg.peek(name)

    eng = introspect.engine()
    doc = {
        "status": "ok",
        "ts": round(time.time(), 3),
        "run_id": obs.run_id(),
        "obs_dir": obs.run_dir(),
        "generation_step": g("serve/generation_step"),
        "staleness_steps": g("serve/staleness_steps"),
        "degraded": bool(g("serve/degraded") or 0),
        "breaker_state": g("resilience.breaker_state"),
        "last_sentinel": status().get("last_sentinel"),
        "captures": (len(eng.captures) if eng is not None else 0),
        "captures_suppressed": (eng.suppressed if eng is not None
                                else 0),
        "online_auc": g("online/auc"),
    }
    return doc


class _Handler(http.server.BaseHTTPRequestHandler):
    server_version = "fm-spark-metrics/1"

    def do_GET(self):  # noqa: N802 — http.server API
        try:
            path = self.path.split("?", 1)[0]
            if path == "/metrics":
                from fm_spark_tpu_torch import obs

                rid = obs.run_id()
                body = registry().prometheus_text(
                    labels={"run_id": rid} if rid else None
                ).encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            elif path == "/healthz":
                body = (json.dumps(_healthz_doc()) + "\n").encode()
                ctype = "application/json"
            else:
                self.send_error(404, "want /metrics or /healthz")
                return
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except Exception:  # noqa: BLE001 — a scrape must never kill
            # the handler thread (or worse, leak into the served loop)
            try:
                self.send_error(500, "scrape failed")
            except Exception:
                pass

    def log_message(self, fmt, *args):  # silence per-request stderr
        pass


class MetricsServer:
    """One live endpoint over the process-wide registry."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1"):
        self._server = http.server.ThreadingHTTPServer(
            (host, int(port)), _Handler)
        self._server.daemon_threads = True
        self.host = host
        self.port = int(self._server.server_address[1])
        self._thread = threading.Thread(
            target=self._server.serve_forever,
            name="fm-spark-metrics-endpoint", daemon=True)
        self._thread.start()

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}"

    def close(self) -> None:
        try:
            self._server.shutdown()
            self._server.server_close()
        except Exception:
            pass
        self._thread.join(timeout=10.0)


_server: MetricsServer | None = None


def start_metrics_server(port: int = 0,
                         host: str = "127.0.0.1") -> MetricsServer:
    """Start (or replace) the process-wide endpoint; returns it with
    ``.port`` resolved (port 0 = ephemeral)."""
    global _server
    stop_metrics_server()
    _server = MetricsServer(port, host=host)
    return _server


def stop_metrics_server() -> None:
    global _server
    if _server is not None:
        _server.close()
        _server = None
