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
threads. The fleet's metrics rollup comes with the fleet (ROADMAP Queue 1
item 6b).
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
    "start_metrics_server",
    "status",
    "stop_metrics_server",
]

_status_lock = threading.Lock()
_status: dict = {}


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
