"""The serving front door: stdlib HTTP transport with deadline-aware
admission control (the port's copy of ``fm_spark_tpu/serve/frontdoor.py``).

It puts a service on the in-process submit/future API of
:class:`~fm_spark_tpu_torch.serve.engine.PredictEngine` (stdlib
``http.server``, no new dependency):

``POST /predict``   score a request — JSON ``{"id", "class",
                    "deadline_ms", "ids", "vals"}`` → ``200`` with
                    scores + the generation that produced them,
                    ``429`` + ``Retry-After`` when shed, ``400`` when
                    rejected, ``504`` when the deadline expired after
                    admission, ``503`` on an explicit backend failure
``GET /healthz``    readiness + per-replica fleet state + admission
                    snapshot
``GET /metrics``    the live metrics registry (Prometheus text), with
                    the fleet's per-replica rollup when the backend
                    has one

Admission control sheds **before** the coalescer: a request whose SLO
is unpayable under the current estimated wait is answered ``429`` at
once — it never takes a queue slot, batch capacity or device time.
Priority classes are ordered (first = highest); a class's wait estimate
counts only traffic at its own priority and above, so under pressure
background traffic sheds first while interactive keeps its deadline.
Per-class queues are bounded: the queue-full shed is the backstop that
keeps the door's memory flat under a retry storm. Every verdict is
counted (``frontdoor.accepted_total``, ``frontdoor.shed_total`` (+ per
class and reason), ``frontdoor.timeout_total``,
``frontdoor.rejected_total``, ``frontdoor.failed_total``,
``frontdoor.answered_total``).

Admitted requests carry an absolute deadline into the engine's
coalescer (:meth:`PredictEngine.submit`). One ``frontdoor_request``
watchdog phase guards the admitted request end to end; the
``frontdoor_accept`` fault point fires per inbound request before
admission. A sampled request gets its trace minted here (``obs.mint_trace``,
the trust boundary: an inbound ``X-FM-Trace`` is ignored), and its
context rides into the backend.
"""

from __future__ import annotations

import dataclasses
import http.server
import inspect
import json
import random
import socketserver
import threading
import time

from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.obs import export as obs_export
from fm_spark_tpu_torch.resilience import faults, watchdog

__all__ = [
    "DEFAULT_CLASSES",
    "AdmissionController",
    "BackendError",
    "ClassSpec",
    "FrontDoor",
    "LocalBackend",
    "Verdict",
    "parse_classes",
]

#: Default priority ladder, highest first: ``name:queue_cap:
#: default_deadline_ms``. Order IS priority — interactive's wait
#: estimate ignores batch/background traffic; background queues behind
#: everyone and sheds first.
DEFAULT_CLASSES = "interactive:64:500,batch:64:2000,background:32:8000"


class BackendError(RuntimeError):
    """The backend failed an admitted request explicitly (after any
    retry policy it owns) — surfaces as a 503, never a silent drop."""


@dataclasses.dataclass(frozen=True)
class ClassSpec:
    name: str
    priority: int            # 0 = highest (position in the spec)
    queue_cap: int
    default_deadline_ms: float


def parse_classes(spec: str) -> tuple[ClassSpec, ...]:
    """Parse the ``name:cap:deadline_ms`` ladder (priority = order)."""
    out = []
    for i, part in enumerate(p for p in spec.split(",") if p.strip()):
        bits = part.strip().split(":")
        if len(bits) != 3:
            raise ValueError(
                f"class spec {part!r}: want name:queue_cap:deadline_ms")
        name, cap, dl = bits
        cap_i, dl_f = int(cap), float(dl)
        if not name or cap_i < 1 or dl_f <= 0:
            raise ValueError(f"class spec {part!r}: need a name, "
                             "cap >= 1 and deadline > 0")
        out.append(ClassSpec(name, i, cap_i, dl_f))
    if not out:
        raise ValueError(f"empty class spec {spec!r}")
    if len({c.name for c in out}) != len(out):
        raise ValueError(f"duplicate class name in {spec!r}")
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class Verdict:
    decision: str            # admitted | shed_queue | shed_deadline
    #                        # | rejected
    est_ms: float
    retry_after_ms: float = 0.0

    @property
    def admitted(self) -> bool:
        return self.decision == "admitted"


class AdmissionController:
    """Deadline-aware, priority-ordered admission.

    The wait estimate is deliberately simple and honest: an EWMA of
    observed per-request service time, multiplied by the number of
    requests already admitted at this class's priority or higher
    (they are ahead of us or indistinguishable from us), plus one
    service time for the request itself. If that exceeds the request's
    deadline the SLO is unpayable NOW — shedding is cheaper for
    everyone than queueing work we already know we will time out.
    """

    def __init__(self, classes: "str | tuple[ClassSpec, ...]"
                 = DEFAULT_CLASSES, *,
                 service_est_ms: float = 5.0, ewma_alpha: float = 0.2,
                 retry_jitter_frac: float = 0.5,
                 jitter_seed: int = 0):
        self.classes = (parse_classes(classes)
                        if isinstance(classes, str) else tuple(classes))
        self._by_name = {c.name: c for c in self.classes}
        self._lock = threading.Lock()
        self._inflight = {c.name: 0 for c in self.classes}
        self._service_ms = float(service_est_ms)
        self._alpha = float(ewma_alpha)
        if not 0.0 <= retry_jitter_frac <= 1.0:
            raise ValueError(f"retry_jitter_frac in [0,1], "
                             f"got {retry_jitter_frac}")
        #: Seeded Retry-After jitter: shed
        #: clients all backing off by the SAME deterministic hint
        #: re-synchronize into the exact burst that got them shed;
        #: each verdict's hint is stretched by a seeded factor in
        #: [1, 1+frac] so the retry wave de-clumps — reproducibly,
        #: since drills replay from seeds.
        self._retry_jitter_frac = float(retry_jitter_frac)
        self._retry_rng = random.Random(int(jitter_seed))

    def spec(self, cls: str) -> "ClassSpec | None":
        return self._by_name.get(cls)

    def estimate_ms(self, cls: str) -> float:
        """Estimated time-to-answer for a NEW request of ``cls``."""
        c = self._by_name[cls]
        with self._lock:
            ahead = sum(n for name, n in self._inflight.items()
                        if self._by_name[name].priority <= c.priority)
            return self._service_ms * (ahead + 1)

    def admit(self, cls: str, deadline_ms: "float | None") -> Verdict:
        c = self._by_name.get(cls)
        if c is None:
            obs.counter("frontdoor.rejected_total").add(1)
            return Verdict("rejected", 0.0)
        deadline_ms = float(deadline_ms if deadline_ms is not None
                            else c.default_deadline_ms)
        with self._lock:
            svc = self._service_ms
            if self._inflight[cls] >= c.queue_cap:
                decision = "shed_queue"
                # Queue is full: come back after roughly one queue
                # drain at current service speed.
                retry_after = svc * c.queue_cap
                est = svc * (c.queue_cap + 1)
            else:
                ahead = sum(
                    n for name, n in self._inflight.items()
                    if self._by_name[name].priority <= c.priority)
                est = svc * (ahead + 1)
                if est > deadline_ms:
                    decision = "shed_deadline"
                    retry_after = max(est - deadline_ms, svc)
                else:
                    self._inflight[cls] += 1
                    obs.counter("frontdoor.accepted_total").add(1)
                    obs.counter(
                        f"frontdoor.accepted_total.{cls}").add(1)
                    return Verdict("admitted", est)
        obs.counter("frontdoor.shed_total").add(1)
        obs.counter(f"frontdoor.shed_total.{cls}").add(1)
        obs.counter(f"frontdoor.{decision}_total").add(1)
        with self._lock:
            retry_after *= (1.0 + self._retry_jitter_frac
                            * self._retry_rng.random())
        return Verdict(decision, est, retry_after_ms=retry_after)

    def release(self, cls: str,
                service_ms: "float | None" = None) -> None:
        """One admitted request reached a terminal outcome; fold its
        observed service time into the estimate (successes only —
        timeouts would teach the estimator that failure is fast)."""
        with self._lock:
            if self._inflight.get(cls, 0) > 0:
                self._inflight[cls] -= 1
            if service_ms is not None and service_ms > 0:
                self._service_ms += self._alpha * (
                    float(service_ms) - self._service_ms)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "service_est_ms": round(self._service_ms, 3),
                "inflight": dict(self._inflight),
                "classes": [dataclasses.asdict(c)
                            for c in self.classes],
            }


class LocalBackend:
    """In-process backend: one :class:`PredictEngine` behind the door
    (the single-replica deployment, and the unit-test seam). The engine
    runs where it was built: on the card it replays its CUDA graphs."""

    def __init__(self, engine, follower=None):
        self.engine = engine
        self.follower = follower

    def score(self, ids, vals, deadline: float, trace=None):
        fut = self.engine.submit(ids, vals, deadline=deadline,
                                 trace=trace)
        out = fut.result(max(deadline - time.monotonic(), 0.001))
        return out, {"generation_step": self.engine.generation().step,
                     "replica": 0}

    def healthz(self) -> dict:
        gen = self.engine.generation()
        return {"ready": True, "n_replicas": 1,
                "replicas": [{"replica": 0, "state": "ready",
                              "generation_step": gen.step}]}

    def close(self) -> None:
        if self.follower is not None:
            self.follower.stop()
        self.engine.close()


def _json_body(doc) -> bytes:
    # HTTP response wire format — the one sanctioned json.dumps seam
    # in this module (journal writes go through EventLog).
    return (json.dumps(doc) + "\n").encode()


class _ThreadingHTTPServer(socketserver.ThreadingMixIn,
                           http.server.HTTPServer):
    daemon_threads = True
    # A slow client holds a handler thread by design (the
    # slow_clients drill); the accept loop must keep accepting.
    request_queue_size = 128


class FrontDoor:
    """The serving front door: admission control + HTTP transport over
    any backend with ``score/healthz/close``."""

    def __init__(self, backend, *, admission=None,
                 host: str = "127.0.0.1", port: int = 0,
                 journal=None, trace_sample: float = 1.0):
        self.backend = backend
        self.admission = admission or AdmissionController()
        self.journal = journal
        self.trace_sample = float(trace_sample)
        # Backends predate tracing; only thread the context through
        # score() when the signature takes it (computed once, not per
        # request).
        try:
            self._score_takes_trace = ("trace" in inspect.signature(
                backend.score).parameters)
        except (TypeError, ValueError):
            self._score_takes_trace = False
        self._host, self._want_port = host, int(port)
        self._server = None
        self._thread = None
        self._lock = threading.Lock()

    # ------------------------------------------------------ lifecycle

    def start(self) -> "FrontDoor":
        with self._lock:
            if self._server is not None:
                return self
            door = self

            class Handler(http.server.BaseHTTPRequestHandler):
                server_version = "fm-spark-frontdoor/1"

                def log_message(self, fmt, *args):
                    pass  # per-request narrative goes to the journal

                def do_GET(self):  # noqa: N802 — http.server API
                    try:
                        path = self.path.split("?", 1)[0]
                        if path == "/healthz":
                            self._reply(200, door._healthz_doc())
                        elif path == "/metrics":
                            text = obs.registry().prometheus_text()
                            rollup = getattr(door.backend,
                                             "metrics_rollup", None)
                            if rollup is not None:
                                try:
                                    text += (obs_export
                                             .render_fleet_metrics(
                                                 rollup()))
                                except Exception:  # noqa: BLE001 —
                                    # a torn replica scrape must not
                                    # fail the front door's own dump
                                    pass
                            body = text.encode()
                            self.send_response(200)
                            self.send_header(
                                "Content-Type",
                                "text/plain; version=0.0.4; "
                                "charset=utf-8")
                            self.send_header("Content-Length",
                                             str(len(body)))
                            self.end_headers()
                            self.wfile.write(body)
                        else:
                            self.send_error(
                                404, "want /predict, /healthz "
                                     "or /metrics")
                    except Exception:  # noqa: BLE001 — a broken
                        # scrape/socket must never kill the handler
                        pass

                def do_POST(self):  # noqa: N802 — http.server API
                    try:
                        if self.path.split("?", 1)[0] != "/predict":
                            self.send_error(404, "want /predict")
                            return
                        status, doc, retry_after = door._predict(
                            self.rfile, self.headers)
                        self._reply(status, doc,
                                    retry_after=retry_after)
                    except Exception:  # noqa: BLE001 — the client
                        # socket died mid-reply; the request outcome
                        # was already counted
                        pass

                def _reply(self, status, doc, retry_after=None):
                    body = _json_body(doc)
                    self.send_response(status)
                    self.send_header("Content-Type",
                                     "application/json")
                    self.send_header("Content-Length",
                                     str(len(body)))
                    if retry_after is not None:
                        # HTTP wants integer seconds; the JSON body
                        # carries the precise retry_after_ms.
                        self.send_header(
                            "Retry-After",
                            str(max(1, int(retry_after / 1e3))))
                    self.end_headers()
                    self.wfile.write(body)

            self._server = _ThreadingHTTPServer(
                (self._host, self._want_port), Handler)
            self._thread = threading.Thread(
                target=self._server.serve_forever,
                name="fm-spark-frontdoor", daemon=True)
            self._thread.start()
            if self.journal is not None:
                self.journal.emit(
                    "frontdoor_start", host=self._host,
                    port=self.port,
                    classes=[c.name for c in self.admission.classes])
            return self

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._host}:{self.port}"

    def stop(self, close_backend: bool = True) -> None:
        with self._lock:
            server, thread = self._server, self._thread
            self._server = self._thread = None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=10.0)
        if self.journal is not None:
            self.journal.emit("frontdoor_summary", **self.stats())
        if close_backend:
            self.backend.close()

    # ----------------------------------------------------- accounting

    def stats(self) -> dict:
        reg = obs.registry()

        def c(name):
            return int(reg.peek(name) or 0)

        return {
            "accepted": c("frontdoor.accepted_total"),
            "answered": c("frontdoor.answered_total"),
            "shed": c("frontdoor.shed_total"),
            "shed_queue": c("frontdoor.shed_queue_total"),
            "shed_deadline": c("frontdoor.shed_deadline_total"),
            "rejected": c("frontdoor.rejected_total"),
            "timeout": c("frontdoor.timeout_total"),
            "slo_burn": c("frontdoor.slo_burn_total"),
            "failed": c("frontdoor.failed_total"),
            "retries": c("frontdoor.retries_total"),
            "admission": self.admission.snapshot(),
        }

    def _healthz_doc(self) -> dict:
        doc = self.backend.healthz()
        doc["admission"] = self.admission.snapshot()
        doc["counters"] = {k: v for k, v in self.stats().items()
                           if k != "admission"}
        return doc

    # ------------------------------------------------------- predict

    def _predict(self, rfile, headers):
        """Handle one /predict. Returns (status, doc, retry_after_ms
        | None). Every path is counted; an admitted request ALWAYS
        releases its queue slot."""
        try:
            faults.inject("frontdoor_accept")
        except Exception as e:  # noqa: BLE001 — injected transport
            # fault: the client sees an explicit 500, never a hang
            obs.counter("frontdoor.failed_total").add(1)
            return 500, {"error": f"accept failed: "
                                  f"{type(e).__name__}"}, None
        try:
            n = int(headers.get("Content-Length") or 0)
            req = json.loads(rfile.read(n).decode() or "{}")
            ids, vals = req["ids"], req["vals"]
            if (not ids or not vals or len(ids) != len(vals)
                    or len(ids[0]) != len(vals[0])):
                raise ValueError("ids/vals shape mismatch")
        except Exception:  # noqa: BLE001 — malformed request
            obs.counter("frontdoor.rejected_total").add(1)
            return 400, {"error": "malformed request: want JSON "
                                  "{ids, vals, [class, deadline_ms, "
                                  "id]}"}, None
        req_id = str(req.get("id") or "")
        cls = str(req.get("class")
                  or self.admission.classes[0].name)
        deadline_ms = req.get("deadline_ms")

        # One TraceContext per sampled request, minted HERE — the
        # front door is the trust boundary; inbound X-FM-Trace headers
        # from clients are ignored. ctx None = sampled out (or tracing
        # disabled): the request runs the exact pre-trace path.
        ctx = obs.mint_trace(self.trace_sample)
        if ctx is not None:
            with obs.span("frontdoor/admit", trace=ctx.trace_id,
                          cls=cls, req_id=req_id):
                v = self.admission.admit(cls, deadline_ms)
        else:
            v = self.admission.admit(cls, deadline_ms)
        if v.decision == "rejected":
            return 400, {"id": req_id,
                         "error": f"unknown class {cls!r}"}, None
        if not v.admitted:
            return 429, {"id": req_id, "error": v.decision,
                         "retry_after_ms": round(v.retry_after_ms, 3),
                         "est_ms": round(v.est_ms, 3)
                         }, v.retry_after_ms

        spec = self.admission.spec(cls)
        dl_ms = float(deadline_ms if deadline_ms is not None
                      else spec.default_deadline_ms)
        t_in = time.monotonic()
        deadline = t_in + dl_ms / 1e3
        sp_req = (obs.span("frontdoor/request", trace=ctx.trace_id,
                           cls=cls, req_id=req_id)
                  if ctx is not None else obs.NOOP_SPAN)
        try:
            with watchdog.phase("frontdoor_request"), sp_req as sp:
                trace_kw = {}
                if ctx is not None and self._score_takes_trace:
                    # Hand downstream a context parented to THIS hop's
                    # span — the cross-process stitch point.
                    trace_kw["trace"] = ctx.child(
                        getattr(sp, "span_id", None))
                out, meta = self.backend.score(ids, vals, deadline,
                                               **trace_kw)
        except TimeoutError:
            self.admission.release(cls)
            obs.counter("frontdoor.timeout_total").add(1)
            self._count_slo_burn(cls)
            return 504, {"id": req_id,
                         "error": "deadline expired"}, None
        except Exception as e:  # noqa: BLE001 — backend failed the
            # admitted request (after its own retry policy): explicit
            # 503, counted, slot released
            self.admission.release(cls)
            obs.counter("frontdoor.failed_total").add(1)
            if self.journal is not None:
                self.journal.emit(
                    "frontdoor_backend_failed", req_id=req_id,
                    cls=cls, error=type(e).__name__)
            return 503, {"id": req_id,
                         "error": f"backend failed: "
                                  f"{type(e).__name__}"}, None
        service_ms = (time.monotonic() - t_in) * 1e3
        self.admission.release(cls, service_ms=service_ms)
        obs.counter("frontdoor.answered_total").add(1)
        if service_ms > dl_ms:
            # Answered, but late: SLO budget burned all the same.
            self._count_slo_burn(cls)
        obs.histogram("frontdoor/request_ms").observe(
            service_ms, exemplar=ctx.trace_id if ctx else None)
        doc = {"id": req_id, "scores": [float(x) for x in out],
               "generation_step": meta.get("generation_step"),
               "replica": meta.get("replica")}
        if ctx is not None:
            doc["trace"] = ctx.trace_id
        return 200, doc, None

    @staticmethod
    def _count_slo_burn(cls: str) -> None:
        """SLO burn-rate feed: one tick per request that
        missed its deadline (504, or answered late) — burn rate =
        rate(slo_burn_total) / rate(accepted_total) on any scraper."""
        obs.counter("frontdoor.slo_burn_total").add(1)
        obs.counter(f"frontdoor.slo_burn_total.{cls}").add(1)
