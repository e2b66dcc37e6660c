"""Seeded traffic-replay load generator (the port's copy of
``fm_spark_tpu/serve/loadgen.py``).

Traffic *shapes* — diurnal ramps, flash crowds, slow clients, retry
storms — as pure functions of a seed, replayed against the serving
front door over plain HTTP. Every attempt is journaled to the **tap**,
a JSONL journal with one record per attempt (request id, attempt
number, priority class, HTTP status, outcome, latency, the generation
and replica that scored it), from which a run is graded.
``make_schedule(shape, seed)`` is deterministic, so a failing run IS its
repro.

No dependencies beyond the stdlib: ``http.client`` for transport,
:class:`~fm_spark_tpu_torch.utils.logging.EventLog` for the tap.
"""

from __future__ import annotations

import dataclasses
import http.client
import json
import math
import random
import threading
import time

from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.utils.logging import EventLog, read_events

__all__ = [
    "SHAPES",
    "TrafficEvent",
    "TrafficSchedule",
    "event_payload",
    "make_schedule",
    "run_loadgen",
    "summarize_tap",
]

#: The traffic-shape vocabulary.
#: Append-only: ``SHAPES.index`` seeds each shape's rng, so reordering
#: would silently re-roll every existing schedule.
SHAPES = ("diurnal", "flash_crowd", "slow_clients", "retry_storm",
          "partition_storm")

#: Terminal attempt outcomes written to the tap. ``ok`` is the only
#: success; everything else is an explicit failure the client SAW — an
#: exactly-once audit counts these, so a silently dropped request shows
#: up as an attempt with no terminal record.
OUTCOMES = ("ok", "shed", "rejected", "timeout", "error",
            "client_timeout")


@dataclasses.dataclass(frozen=True)
class TrafficEvent:
    """One logical client request within a schedule."""

    idx: int                 # position in the schedule (payload seed)
    t_offset_s: float        # send time relative to replay start
    req_id: str
    cls: str                 # priority class name
    rows: int
    deadline_ms: float
    slow_s: float = 0.0      # client-side stall mid-request (slow POST)
    max_retries: int = 0     # client retries on shed/error, never on ok


@dataclasses.dataclass(frozen=True)
class TrafficSchedule:
    """An ordered, seeded replay script."""

    shape: str
    seed: int
    events: tuple
    duration_s: float

    @property
    def n_requests(self) -> int:
        return len(self.events)


def make_schedule(shape: str, seed: int, *, duration_s: float = 1.5,
                  base_rps: float = 60.0, rows: int = 2,
                  deadline_ms: float = 500.0) -> TrafficSchedule:
    """Build one seeded traffic schedule. Pure function of its
    arguments — two calls with the same (shape, seed, knobs) replay
    byte-identical traffic.

    ``diurnal``       sinusoidal rate ramp over the window (the
                      compressed day): trough 30% of ``base_rps``,
                      peak 170%
    ``flash_crowd``   a quiet baseline, then ~40% into the window a
                      burst of 2-3s worth of traffic lands inside
                      ~120ms
    ``slow_clients``  moderate rate, but a seeded third of clients
                      stall mid-POST (they hold a server thread while
                      interactive traffic keeps its deadline)
    ``retry_storm``   over-capacity rate with deadlines tight enough
                      to shed, and every client retrying — the storm
                      only converges because 429s carry Retry-After
    ``partition_storm`` steady demand where EVERY client retries
                      (a parent↔replica partition surfaces as 503s,
                      and sheds as 429s — both retried, honoring the
                      door's jittered Retry-After), plus a surge at
                      ~55% of the window: the deferred traffic
                      replaying just after a canonical partition
                      window heals
    """
    if shape not in SHAPES:
        raise ValueError(f"unknown traffic shape {shape!r}; "
                         f"known: {SHAPES}")
    # SHAPES.index, not hash(): str hashing is salted per process and
    # the schedule must replay identically across processes.
    rng = random.Random((int(seed) << 8) ^ SHAPES.index(shape))
    duration_s = float(duration_s)
    events = []

    def add(t, cls, *, dl=None, slow=0.0, retries=0):
        idx = len(events)
        events.append(TrafficEvent(
            idx=idx, t_offset_s=round(max(0.0, t), 4),
            req_id=f"{shape[:2]}{int(seed)}-{idx:05d}", cls=cls,
            rows=max(1, rows), deadline_ms=float(dl or deadline_ms),
            slow_s=round(slow, 3), max_retries=int(retries)))

    def cls_for(r):
        # ~70/20/10 interactive/batch/background, seeded.
        return ("interactive" if r < 0.7
                else "batch" if r < 0.9 else "background")

    if shape == "diurnal":
        t = 0.0
        while t < duration_s:
            # Rate ramps through one compressed "day".
            frac = t / duration_s
            rate = base_rps * (1.0 + 0.7 * math.sin(
                2.0 * math.pi * (frac - 0.25)))
            rate = max(rate, 0.3 * base_rps)
            t += rng.expovariate(rate)
            if t < duration_s:
                add(t, cls_for(rng.random()))
    elif shape == "flash_crowd":
        t = 0.0
        while t < duration_s:
            t += rng.expovariate(0.4 * base_rps)
            if t < duration_s:
                add(t, cls_for(rng.random()))
        t_spike = 0.4 * duration_s
        n_spike = int(base_rps * (2.0 + rng.random()))
        for _ in range(n_spike):
            add(t_spike + rng.random() * 0.12, "interactive",
                retries=1)
        events.sort(key=lambda e: e.t_offset_s)
        events[:] = [dataclasses.replace(e, idx=i)
                     for i, e in enumerate(events)]
    elif shape == "slow_clients":
        t = 0.0
        while t < duration_s:
            t += rng.expovariate(0.8 * base_rps)
            if t >= duration_s:
                break
            if rng.random() < 0.33:
                # Slow client: stalls mid-POST for a good chunk of the
                # window, on a lenient background deadline.
                add(t, "background", dl=8.0 * deadline_ms,
                    slow=0.15 + 0.25 * rng.random())
            else:
                add(t, "interactive")
    elif shape == "retry_storm":
        t = 0.0
        while t < duration_s:
            t += rng.expovariate(1.6 * base_rps)
            if t < duration_s:
                add(t, cls_for(rng.random()),
                    dl=0.25 * deadline_ms, retries=2)
    else:  # partition_storm
        t = 0.0
        while t < duration_s:
            t += rng.expovariate(1.2 * base_rps)
            if t < duration_s:
                add(t, cls_for(rng.random()), retries=3)
        t_surge = 0.55 * duration_s
        n_surge = int(base_rps * (1.0 + rng.random()))
        for _ in range(n_surge):
            add(t_surge + rng.random() * 0.2, "interactive",
                retries=3)
        events.sort(key=lambda e: e.t_offset_s)
        events[:] = [dataclasses.replace(e, idx=i)
                     for i, e in enumerate(events)]

    return TrafficSchedule(shape=shape, seed=int(seed),
                           events=tuple(events),
                           duration_s=duration_s)


def event_payload(ev: TrafficEvent, schedule: TrafficSchedule, *,
                  nnz: int, num_features: int):
    """Deterministic feature rows for one event: seeded by (schedule
    seed, event idx), so a replayed schedule scores identical rows."""
    rng = random.Random((int(schedule.seed) << 20) ^ int(ev.idx))
    ids = [[rng.randrange(num_features) for _ in range(nnz)]
           for _ in range(ev.rows)]
    vals = [[round(rng.random(), 6) for _ in range(nnz)]
            for _ in range(ev.rows)]
    return ids, vals


def _post_predict(host: str, port: int, body: bytes, *,
                  timeout_s: float, slow_s: float = 0.0):
    """One HTTP attempt. A slow client sends headers, stalls, then the
    body — holding a server handler thread exactly the way a congested
    mobile uplink does."""
    # The loadgen IS the client: user traffic arrives from outside the
    # fleet's transport, so the netfault plane (the parent<->replica
    # link) does not intercept it; traces are minted at the door.
    conn = http.client.HTTPConnection(host, port, timeout=timeout_s)  # fmlint: disable=fleet-transport-discipline -- the loadgen IS the client: it models user traffic arriving from outside the fleet's transport boundary
    try:
        conn.putrequest("POST", "/predict")  # fmlint: disable=trace-propagation -- client side of the trust boundary: traces are MINTED at the front door (inbound X-FM-Trace is ignored there)
        conn.putheader("Content-Type", "application/json")
        conn.putheader("Content-Length", str(len(body)))
        conn.endheaders()
        if slow_s > 0.0:
            half = len(body) // 2
            conn.send(body[:half])
            time.sleep(slow_s)
            conn.send(body[half:])
        else:
            conn.send(body)
        resp = conn.getresponse()
        payload = resp.read()
        try:
            doc = json.loads(payload.decode() or "{}")
        except ValueError:
            doc = {}
        return resp.status, doc
    finally:
        conn.close()


_STATUS_OUTCOME = {200: "ok", 400: "rejected", 429: "shed",
                   500: "error", 503: "error", 504: "timeout"}


def run_loadgen(host: str, port: int, schedule: TrafficSchedule,
                tap_path: str, *, nnz: int, num_features: int,
                threads: int = 8, attempt_timeout_s: float = 10.0,
                time_scale: float = 1.0) -> dict:
    """Replay one schedule against a front door, journaling every
    attempt to the tap. Returns :func:`summarize_tap` of the run.

    ``time_scale`` compresses/stretches the schedule clock (drills run
    the same shape faster). Retries honor the server's Retry-After
    (capped at 100ms so a drill-sized storm converges inside its
    budget) and NEVER follow a 200 — exactly-once by construction on
    the client side; the auditor re-proves it from the tap.
    """
    tap = EventLog(tap_path)
    tap_lock = threading.Lock()
    work = list(schedule.events)
    work_lock = threading.Lock()
    t0 = time.monotonic()

    def emit(ev, attempt, status, outcome, t_send, doc):
        with tap_lock:
            tap.emit("attempt", req_id=ev.req_id, attempt=attempt,
                     cls=ev.cls, rows=ev.rows, status=status,
                     outcome=outcome,
                     latency_ms=round(
                         (time.monotonic() - t_send) * 1e3, 3),
                     gen_step=doc.get("generation_step"),
                     replica=doc.get("replica"),
                     trace=doc.get("trace"),
                     retry_after_ms=doc.get("retry_after_ms"))

    def one_event(ev):
        target = t0 + ev.t_offset_s * time_scale
        delay = target - time.monotonic()
        if delay > 0:
            time.sleep(delay)
        ids, vals = event_payload(ev, schedule, nnz=nnz,
                                  num_features=num_features)
        body = json.dumps({  # fmlint: disable=eventlog-only -- HTTP request wire format, not a journal write
            "id": ev.req_id, "class": ev.cls,
            "deadline_ms": ev.deadline_ms, "ids": ids, "vals": vals,
        }).encode()
        for attempt in range(1, ev.max_retries + 2):
            t_send = time.monotonic()
            t_send_wall = time.time()
            try:
                status, doc = _post_predict(
                    host, port, body,
                    timeout_s=attempt_timeout_s, slow_s=ev.slow_s)
                outcome = _STATUS_OUTCOME.get(status, "error")
            except TimeoutError:
                status, doc, outcome = None, {}, "client_timeout"
            except OSError:
                # Connection died under us (replica kill mid-burst
                # surfaces here when the FRONT DOOR dies; a replica
                # death is absorbed by the fleet's retry): an explicit
                # client-visible failure, eligible for retry.
                status, doc, outcome = None, {}, "error"
            emit(ev, attempt, status, outcome, t_send, doc)
            if outcome == "ok" and doc.get("trace"):
                # Retroactive client-side hop: when the loadgen runs
                # in an obs-configured process, the request's full
                # round trip joins the merged trace (wall start,
                # monotonic duration).
                obs.emit_span(
                    "client/request", t_send_wall,
                    time.monotonic() - t_send,
                    trace=doc["trace"], req_id=ev.req_id,
                    attempt=attempt, cls=ev.cls)
            if outcome == "ok" or attempt > ev.max_retries:
                return
            if outcome == "rejected":
                return  # malformed stays malformed; retry is hammering
            backoff = min((doc.get("retry_after_ms") or 5.0) / 1e3,
                          0.1)
            time.sleep(backoff)

    def worker():
        while True:
            with work_lock:
                if not work:
                    return
                ev = work.pop(0)
            one_event(ev)

    pool = [threading.Thread(target=worker, name=f"loadgen-{i}",
                             daemon=True)
            for i in range(max(1, int(threads)))]
    for th in pool:
        th.start()
    for th in pool:
        th.join()
    return summarize_tap(tap_path)


def summarize_tap(tap_path: str) -> dict:
    """Aggregate one tap into the numbers a run reports."""
    events = [e for e in read_events(tap_path)
              if e.get("event") == "attempt"]
    by_outcome: dict[str, int] = {}
    by_cls: dict[str, dict] = {}
    ok_lat = []
    for e in events:
        out = e.get("outcome") or "?"
        by_outcome[out] = by_outcome.get(out, 0) + 1
        c = by_cls.setdefault(e.get("cls") or "?",
                              {"attempts": 0, "ok": 0, "shed": 0})
        c["attempts"] += 1
        if out == "ok":
            c["ok"] += 1
            ok_lat.append(float(e.get("latency_ms") or 0.0))
        elif out == "shed":
            c["shed"] += 1
    ok_lat.sort()

    def pct(p):
        if not ok_lat:
            return None
        k = max(0, min(len(ok_lat) - 1,
                       int(round(p / 100.0 * (len(ok_lat) - 1)))))
        return round(ok_lat[k], 3)

    req_ids = {e.get("req_id") for e in events}
    return {
        "attempts": len(events),
        "requests": len(req_ids),
        "by_outcome": by_outcome,
        "by_class": by_cls,
        "ok_p50_ms": pct(50), "ok_p99_ms": pct(99),
    }
