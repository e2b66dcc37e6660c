"""The serving front door (``fm_spark_tpu_torch/serve/frontdoor.py``) and
the fleet's pure parts against the reference's: admission control, the
HTTP door over a backend, the seeded load generator, the autoscaler and
the fleet metrics rollup (mirroring ``tests/test_fleet.py``'s and
``tests/test_serve.py``'s door cases and ``tests/test_netfaults.py``'s
autoscaler cases).

- Admission gives the reference's verdicts, estimates, seeded
  Retry-After hints and snapshots on the same admit/release sequences.
- The door sheds before the backend scores (429 + Retry-After), rejects
  malformed requests and unknown classes (400), turns an injected
  ``frontdoor_accept`` fault into a counted 500 and a backend failure
  into a 503, and a deadline that expires in the engine into a 504.
- A sampled request's trace is minted at the door (an inbound
  ``X-FM-Trace`` is ignored), handed to the backend, and shows as the
  engine's ``serve/coalesce`` link span and the latency exemplar.
- ``make_schedule``/``event_payload`` replay the reference's traffic,
  the autoscaler makes its decisions, ``render_fleet_metrics`` renders
  its text.
"""

import dataclasses
import http.client
import json

import numpy as np
import pytest
import torch

from fm_spark_tpu.obs import export as jexport
from fm_spark_tpu.serve import autoscale as jautoscale
from fm_spark_tpu.serve import frontdoor as jdoor
from fm_spark_tpu.serve import loadgen as jloadgen
from fm_spark_tpu_torch import models, obs
from fm_spark_tpu_torch.obs import export
from fm_spark_tpu_torch.resilience import faults, watchdog
from fm_spark_tpu_torch.serve import (AdmissionController, BackendError,
                                      FrontDoor, LocalBackend, PredictEngine,
                                      autoscale, loadgen, parse_classes)
from fm_spark_tpu_torch.serve import frontdoor as pdoor


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    monkeypatch.delenv(watchdog.ENV_SPEC, raising=False)
    faults.clear()
    watchdog.clear()
    yield
    faults.clear()
    watchdog.clear()
    obs.shutdown()


def _spec():
    return models.FieldFMSpec(num_features=4 * 64, rank=4, num_fields=4,
                              bucket=64, init_std=0.1)


def _post(port, doc, headers=None, timeout_s=30.0):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout_s)
    try:
        body = doc if isinstance(doc, (bytes, str)) else json.dumps(doc)
        conn.request("POST", "/predict", body=body, headers={
            "Content-Type": "application/json", **(headers or {})})
        resp = conn.getresponse()
        payload = resp.read().decode()
        return resp.status, json.loads(payload or "{}"), dict(
            resp.getheaders())
    finally:
        conn.close()


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, resp.read().decode()
    finally:
        conn.close()


def _doc(rows=2, cls="interactive", deadline_ms=8000.0, req_id="r0"):
    rng = np.random.default_rng(0)
    return {"id": req_id, "class": cls, "deadline_ms": deadline_ms,
            "ids": rng.integers(0, 64, (rows, 4)).astype(int).tolist(),
            "vals": rng.random((rows, 4)).astype(float).tolist()}


def _delta(before, after):
    return {k: after[k] - before[k] for k in after if k != "admission"}


class _CountingBackend:
    """Counts ``score`` calls (shed-before-backend is then assertable)
    and keeps the trace it was handed; ``fail`` raises BackendError."""

    def __init__(self, fail=False):
        self.calls, self.traces, self.fail = 0, [], fail

    def score(self, ids, vals, deadline, trace=None):
        self.calls += 1
        self.traces.append(trace)
        if self.fail:
            raise BackendError("no ready replica")
        return [0.0] * len(ids), {"generation_step": 1, "replica": 0}

    def healthz(self):
        return {"ready": True, "n_replicas": 1, "replicas": [
            {"replica": 0, "state": "ready", "generation_step": 1}]}

    def close(self):
        pass


# ------------------------------------------------------------- admission


@pytest.mark.parametrize("spec", [
    "interactive:64:500,batch:64:2000,background:32:8000", "a:1:5",
    "x:3:100,y:2:50"])
def test_parse_classes_matches_the_reference(spec):
    assert [dataclasses.asdict(c) for c in parse_classes(spec)] == [
        dataclasses.asdict(c) for c in jdoor.parse_classes(spec)]


@pytest.mark.parametrize("bad", ["", "interactive:64", "interactive:0:500",
                                 "interactive:8:0", ":8:500",
                                 "a:8:500,a:8:500"])
def test_parse_classes_rejects_malformed_specs(bad):
    with pytest.raises(ValueError):
        parse_classes(bad)
    with pytest.raises(ValueError):
        jdoor.parse_classes(bad)


def _admissions(mod, script, **kw):
    adm = mod.AdmissionController(
        "interactive:3:500,batch:2:2000,background:2:8000", **kw)
    out = []
    for op in script:
        if op[0] == "admit":
            v = adm.admit(op[1], op[2])
            out.append((v.decision, round(v.est_ms, 6),
                        round(v.retry_after_ms, 6)))
        else:
            adm.release(op[1], service_ms=op[2])
            out.append(adm.snapshot())
        out.append(adm.estimate_ms(op[1]) if op[1] != "nope" else None)
    return out


@pytest.mark.parametrize("seed", [0, 5])
def test_admission_matches_the_reference(seed):
    """Queue-full and deadline sheds with their seeded Retry-After,
    priority-aware estimates, an unknown class, the EWMA's learning."""
    script = ([("admit", "background", 8000)] * 3
              + [("admit", "interactive", 25.0), ("admit", "batch", 11.0),
                 ("admit", "nope", 500), ("release", "background", 3.0),
                 ("admit", "interactive", None)]
              + [("admit", "interactive", 500)] * 4
              + [("release", "interactive", 40.0),
                 ("admit", "batch", 60.0), ("admit", "batch", None)])
    kw = dict(service_est_ms=10.0, jitter_seed=seed)
    assert _admissions(pdoor, script, **kw) == _admissions(jdoor, script,
                                                           **kw)


# ----------------------------------------------------------- the door


def test_door_sheds_before_the_backend_scores():
    backend = _CountingBackend()
    door = FrontDoor(backend, admission=AdmissionController(
        "interactive:1:500", service_est_ms=50.0)).start()
    try:
        before = door.stats()
        status, doc, headers = _post(door.port, _doc(deadline_ms=10.0))
        assert status == 429 and doc["error"] == "shed_deadline"
        assert doc["retry_after_ms"] > 0 and "Retry-After" in headers
        assert door.admission.admit("interactive", 1000).admitted
        status, doc, _ = _post(door.port, _doc(deadline_ms=1000.0))
        assert status == 429 and doc["error"] == "shed_queue"
        assert backend.calls == 0
        door.admission.release("interactive")
        status, doc, _ = _post(door.port, _doc(deadline_ms=1000.0))
        assert status == 200 and backend.calls == 1
        d = _delta(before, door.stats())
        assert (d["shed"], d["shed_queue"], d["shed_deadline"],
                d["answered"]) == (2, 1, 1, 1)
    finally:
        door.stop()


@pytest.mark.parametrize("case", ["malformed", "unknown class", "accept",
                                  "backend"])
def test_door_answers_every_failure_explicitly(case):
    """400 for a malformed request or an unknown class (never scored), a
    counted 500 for an injected ``frontdoor_accept`` fault, a 503 for a
    backend that fails an admitted request; the next request is clean."""
    backend = _CountingBackend(fail=case == "backend")
    door = FrontDoor(backend).start()
    try:
        before = door.stats()
        if case == "accept":
            faults.activate("frontdoor_accept@1=error")
        body = {"malformed": b"{not json",
                "unknown class": _doc(cls="no-such-class")}.get(case, _doc())
        status, doc, _ = _post(door.port, body)
        want = {"malformed": (400, "malformed"),
                "unknown class": (400, "unknown class"),
                "accept": (500, "accept failed"),
                "backend": (503, "backend failed: BackendError")}[case]
        assert status == want[0] and want[1] in doc["error"]
        d = _delta(before, door.stats())
        assert d["failed"] == (case in ("accept", "backend"))
        assert d["rejected"] == (case in ("malformed", "unknown class"))
        assert backend.calls == (case == "backend")
        assert all(n == 0 for n in door.admission.snapshot()[
            "inflight"].values())
        if case != "backend":
            assert _post(door.port, _doc())[0] == 200
    finally:
        door.stop()


@pytest.fixture(scope="module")
def engine():
    spec = _spec()
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    eng = PredictEngine(spec, params, buckets=(1, 4), latency_budget_ms=5.0,
                        device="cpu")
    eng.warmup()
    yield spec, params, eng
    eng.close()


def test_local_backend_scores_and_a_late_deadline_is_a_504(engine):
    """The engine behind the door: scores equal ``spec.predict`` of the
    rows; an admitted request whose deadline expires in the coalescer is
    a 504 under the armed ``frontdoor_request`` phase, its slot
    released."""
    spec, params, eng = engine
    watchdog.configure("frontdoor_request=30")
    door = FrontDoor(LocalBackend(eng), admission=AdmissionController(
        service_est_ms=0.01, ewma_alpha=0.0)).start()
    try:
        before = door.stats()
        req = _doc(rows=3)
        status, doc, _ = _post(door.port, req)
        want = spec.predict(params,
                            torch.tensor(req["ids"], dtype=torch.int32),
                            torch.tensor(req["vals"], dtype=torch.float32))
        assert status == 200
        np.testing.assert_array_equal(np.float32(doc["scores"]),
                                      want.numpy())
        assert doc["generation_step"] == eng.generation().step
        status, doc, _ = _post(door.port, _doc(deadline_ms=0.05))
        assert status == 504 and "deadline expired" in doc["error"]
        d = _delta(before, door.stats())
        assert d["answered"] == 1 and d["timeout"] == 1
        assert all(n == 0 for n in door.admission.snapshot()[
            "inflight"].values())
        status, body = _get(door.port, "/healthz")
        health = json.loads(body)
        assert status == 200 and health["ready"]
        assert health["counters"]["answered"] >= 1
        status, body = _get(door.port, "/metrics")
        assert status == 200 and "frontdoor_answered_total" in body
    finally:
        door.stop(close_backend=False)


def test_the_trace_is_minted_at_the_door_and_links_the_engine(engine,
                                                              tmp_path):
    """The door mints the trace (an inbound header is ignored), hands the
    backend a context parented to its ``frontdoor/request`` span, and the
    engine's coalescer writes the request's ``serve/coalesce`` link span
    and tags the latency histogram's exemplar with the trace id."""
    spec, _, eng = engine
    obs.configure(str(tmp_path / "run"))
    backend = _CountingBackend()
    door = FrontDoor(backend, trace_sample=1.0).start()
    try:
        status, doc, _ = _post(door.port, _doc(), headers={
            obs.TRACE_HEADER: "feedface;abc"})
        assert status == 200 and doc["trace"] != "feedface"
        ctx = backend.traces[0]
        assert ctx.trace_id == doc["trace"] and ctx.parent_span_id
        fut = eng.submit(np.array(_doc()["ids"]), np.array(_doc()["vals"]),
                         trace=ctx)
        fut.result(30)
    finally:
        door.stop()
    obs.shutdown()
    with open(tmp_path / "run" / "trace.jsonl") as f:
        spans = [json.loads(x) for x in f]
    names = {s["name"] for s in spans if s.get("trace") == doc["trace"]}
    assert {"frontdoor/admit", "frontdoor/request",
            "serve/coalesce"} <= names
    link = next(s for s in spans if s["name"] == "serve/coalesce")
    assert link["remote_parent"] == ctx.parent_span_id
    exemplars = obs.histogram("serve/request_ms").exemplars()
    assert doc["trace"] in {e["trace_id"] for e in exemplars.values()}


# ------------------------------------------------- the pure fleet parts


@pytest.mark.parametrize("shape", jloadgen.SHAPES)
@pytest.mark.parametrize("seed", [0, 3])
def test_schedules_and_payloads_match_the_reference(shape, seed):
    a = loadgen.make_schedule(shape, seed)
    b = jloadgen.make_schedule(shape, seed)
    assert [dataclasses.asdict(e) for e in a.events] == [
        dataclasses.asdict(e) for e in b.events]
    assert (a.shape, a.seed, a.duration_s) == (b.shape, b.seed, b.duration_s)
    ev = a.events[len(a.events) // 2]
    assert loadgen.event_payload(ev, a, nnz=4, num_features=256) == \
        jloadgen.event_payload(b.events[len(b.events) // 2], b, nnz=4,
                               num_features=256)


def test_summarize_tap_matches_the_reference(tmp_path):
    from fm_spark_tpu_torch.utils.logging import EventLog

    tap = str(tmp_path / "tap.jsonl")
    log = EventLog(tap)
    for i, (out, lat) in enumerate([("ok", 3.0), ("shed", 1.0), ("ok", 7.5),
                                    ("error", 2.0), ("ok", 1.25)]):
        log.emit("attempt", req_id=f"r{i % 4}", attempt=1,
                 cls=("interactive", "batch")[i % 2], outcome=out,
                 latency_ms=lat)
    log.close()
    assert loadgen.summarize_tap(tap) == jloadgen.summarize_tap(tap)


def _ticks():
    seq, shed, acc, rows, pad = [], 0, 0, 0, 0
    for i in range(40):
        if i < 12:
            shed, acc = shed + 10 * (i % 3), acc + 10
        elif i < 28:
            rows, pad, acc = rows + 2, pad + 98, acc + 5
        else:
            shed, acc, rows, pad = shed + 20, acc + 20, rows + 50, pad + 50
        seq.append(dict(shed_total=shed, accepted_total=acc, rows_total=rows,
                        padded_rows_total=pad, n_ready=2 + (i % 3),
                        n_live=2 + (i % 3)))
    return seq


@pytest.mark.parametrize("kw", [dict(), dict(sustain_ticks=1,
                                             cooldown_ticks=0),
                                dict(max_replicas=3, sustain_ticks=2,
                                     cooldown_ticks=3)])
def test_autoscaler_decides_as_the_reference(kw):
    out = []
    for mod in (jautoscale, autoscale):
        j = []

        class J:
            def emit(self, event, **f):
                j.append({"event": event, **f})
        a = mod.Autoscaler(journal=J(), **kw)
        out.append(([a.tick(**t) for t in _ticks()], j, a.summary()))
    assert out[1] == out[0]
    with pytest.raises(ValueError):
        autoscale.Autoscaler(min_replicas=0)


def test_render_fleet_metrics_matches_the_reference():
    rollup = {"replicas": {
        0: {"pid": 1, "snapshot": {"counters": {"serve.rows_total": 10,
                                                "a.b": 2.5},
                                   "gauges": {"serve/generation_step": 4}},
            "buckets": {"serve/request_ms": {"bounds": [1.0, 5.0],
                                             "counts": [3, 1, 0],
                                             "count": 4, "sum": 6.5}}},
        1: {"pid": 2, "snapshot": {"counters": {"serve.rows_total": 7}},
            "buckets": {"serve/request_ms": {"bounds": [1.0, 5.0],
                                             "counts": [1, 1, 1],
                                             "count": 3, "sum": 12.0}}},
        2: "torn"}}
    text = export.render_fleet_metrics(rollup)
    assert text == jexport.render_fleet_metrics(rollup)
    assert 'fm_spark_fleet_serve_rows_total{replica="1"} 7' in text
    assert export.render_fleet_metrics(None) == ""
