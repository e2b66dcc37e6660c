"""The port's flight recorder (``obs/flight.py``), metrics exports
(``obs/metrics.py``) and live endpoint (``obs/export.py``) held against
the JAX package's, clocks patched to the same fake:

- the ring, the spool, its compaction at 2N lines, a recorder reopened
  over its spool, and a dump are equal record for record; a torn spool
  tail is skipped as the reference skips it;
- for one registry's instruments, ``snapshot``, ``prometheus_text`` (run
  id label, histogram buckets, exemplars), ``bucket_snapshot`` and a
  JSONL export are equal;
- the ``/metrics`` and ``/healthz`` bodies the two endpoints serve are
  equal byte for byte; an unknown path is a 404; ``obs.shutdown`` stops
  the server's thread; the sentinel's verdict reaches ``/healthz``.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import pytest

from fm_spark_tpu import obs as robs
from fm_spark_tpu.obs import export as rexport
from fm_spark_tpu.obs import flight as rflight
from fm_spark_tpu.obs import metrics as rmetrics
from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.obs import export as pexport
from fm_spark_tpu_torch.obs import flight as pflight
from fm_spark_tpu_torch.obs import metrics as pmetrics


class _Clock:
    def __init__(self):
        self.t = 1.7e9

    def time(self):
        self.t += 0.5
        return self.t


@pytest.fixture()
def clocks(monkeypatch):
    for mods in ((pflight, pmetrics, pexport), (rflight, rmetrics, rexport)):
        clock = _Clock()
        for m in mods:
            monkeypatch.setattr(m, "time", clock)
    # The last sentinel verdict, the run and the capture engine are
    # process state: earlier tests in the process may have set them.
    monkeypatch.setattr(pexport, "_status", {})
    monkeypatch.setattr(rexport, "_status", {})
    obs.shutdown()
    robs.shutdown()
    yield
    pexport.stop_metrics_server()
    rexport.stop_metrics_server()
    obs.shutdown()
    rmetrics.registry().reset()


def _fill(reg):
    reg.reset()
    reg.counter("train.samples_total").add(1024)
    reg.counter("serve.requests_total").add(7)
    reg.gauge("serve/generation_step").set(12)
    reg.gauge("serve/staleness_steps").set(0)
    reg.gauge("online/auc").set(0.78125)
    reg.gauge("never/set")
    h = reg.histogram("serve/request_ms")
    for i, v in enumerate((0.3, 0.7, 1.5, 4.0, 9.0, 70.0, 900.0)):
        h.observe(v, exemplar=f"trace{i}" if i % 2 else None)
    reg.histogram("empty_ms")
    return reg


def _record(mod, path):
    rec = mod.FlightRecorder(3, spool_path=path)
    for i in range(8):
        rec.record("step", i=i, ts=None if i % 3 else 77.0)
    ring = rec.events()
    rec.close()
    reopened = mod.FlightRecorder(3, spool_path=path)
    reopened.record("after_restart")
    dump = reopened.dump("drill", extra={"why": "test"})
    reopened.close()
    with open(dump) as f:
        doc = json.load(f)
    with open(path) as f:
        spool = f.read()
    return ring, reopened.events(), doc, spool


def test_the_recorder_equals_the_references(tmp_path, clocks):
    pmetrics.registry().reset()
    rmetrics.registry().reset()
    os.makedirs(tmp_path / "p")
    os.makedirs(tmp_path / "r")
    got = _record(pflight, str(tmp_path / "p" / "flight.jsonl"))
    want = _record(rflight, str(tmp_path / "r" / "flight.jsonl"))
    assert got == want
    ring, reopened, doc, spool = got
    assert [e["i"] for e in ring] == [5, 6, 7]
    assert [e["seq"] for e in reopened] == [6, 7, 8]   # seeded from the spool
    assert doc["reason"] == "drill" and doc["why"] == "test"
    assert len(spool.splitlines()) < 6                 # compacted at 2N


def test_a_torn_spool_tail_is_skipped_as_the_reference(tmp_path):
    path = tmp_path / "flight.jsonl"
    path.write_text('{"seq": 0, "kind": "a"}\n[1]\n\n{"seq": 1, "kind": '
                    '"b"}\n{"seq": 2, "ki')
    assert pflight.read_spool(str(path)) == rflight.read_spool(str(path))
    assert [r["kind"] for r in pflight.read_spool(str(path))] == ["a", "b"]
    assert pflight.read_spool(str(tmp_path / "missing")) == []


def test_registry_exports_equal_the_references(tmp_path, clocks):
    p = _fill(pmetrics.registry())
    r = _fill(rmetrics.registry())
    assert p.snapshot() == r.snapshot()
    for labels in (None, {"run_id": "run-1"}, {"a": 'q"\\\n'}):
        assert p.prometheus_text(labels=labels) == \
            r.prometheus_text(labels=labels)
    assert p.bucket_snapshot() == r.bucket_snapshot()
    assert p.peek("online/auc") == r.peek("online/auc") == 0.78125
    p.export_jsonl(str(tmp_path / "p.jsonl"))
    r.export_jsonl(str(tmp_path / "r.jsonl"))
    assert (tmp_path / "p.jsonl").read_text() == \
        (tmp_path / "r.jsonl").read_text()
    assert p.peek("serve/request_ms") is None and p.peek("nope") is None
    assert "nope" not in p.snapshot()["gauges"]
    text = p.prometheus_text(labels={"run_id": "run-1"})
    assert 'fm_spark_serve_request_ms_bucket{run_id="run-1",le="+Inf"} 7' \
        in text and '# {trace_id="trace5"}' in text


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=10) as resp:
            return resp.status, resp.headers["Content-Type"], resp.read()
    except urllib.error.HTTPError as e:
        return e.code, None, b""


def test_the_endpoints_serve_the_references_bodies(clocks):
    _fill(pmetrics.registry())
    _fill(rmetrics.registry())
    ps = pexport.start_metrics_server(0)
    rs = rexport.start_metrics_server(0)
    for path in ("/metrics", "/healthz", "/healthz?x=1"):
        got, want = _get(ps.url + path), _get(rs.url + path)
        assert got == want and got[0] == 200
    health = json.loads(_get(ps.url + "/healthz")[2])
    assert health["generation_step"] == 12 and health["run_id"] is None
    assert health["captures"] == 0 and health["online_auc"] == 0.78125
    assert _get(ps.url + "/nope")[0] == 404
    names = {t.name for t in threading.enumerate()}
    assert "fm-spark-metrics-endpoint" in names


def test_the_run_id_label_and_shutdown_stop_the_endpoint(tmp_path):
    obs.configure(str(tmp_path / "run"), run_id="run-7")
    srv = pexport.start_metrics_server(0)
    obs.counter("train.samples_total").add(3)
    body = _get(srv.url + "/metrics")[2].decode()
    assert 'fm_spark_train_samples_total{run_id="run-7"} 3' in body
    health = json.loads(_get(srv.url + "/healthz")[2])
    assert health["run_id"] == "run-7"
    assert health["obs_dir"] == str(tmp_path / "run")
    thread = srv._thread
    obs.shutdown()
    assert not thread.is_alive() and pexport._server is None


def test_the_sentinel_verdict_reaches_healthz(tmp_path):
    from fm_spark_tpu_torch.obs.ledger import (PerfLedger,
                                               measurement_fingerprint)
    from fm_spark_tpu_torch.obs.sentinel import Sentinel

    sent = Sentinel(PerfLedger(str(tmp_path / "ledger.jsonl")))
    rec = {"kind": "quality_eval", "leg": "online/x", "run_id": "r",
           "value": 1.0,
           "fingerprint": measurement_fingerprint(variant="online/x")}
    block = sent.observe(rec)
    last = pexport.status()["last_sentinel"]
    assert last["leg"] == "online/x" and last["verdict"] == block["verdict"]
