"""The serving fleet (``fm_spark_tpu_torch/serve/fleet.py``) on ``--device
cpu``, mirroring ``tests/test_fleet.py``'s drills and
``tests/test_netfaults.py``'s transport cases.

- The network fault plane at the fleet's transport seam
  (``_http_json`` over a ``ConnectionPool`` of ``FaultyHTTPConnection``):
  a send fault on a reused socket retries once on a fresh dial; a recv
  fault after response bytes arrived is never replayed; a fresh dial's
  failure propagates; a blackhole window heals; the actions emulate the
  reference's socket errors.
- The kill-mid-burst drill: a ``replica_kill`` exit inside a replica
  mid-burst loses no request (every one answered exactly once, the
  in-flight one by the retry), the dead replica is respawned and
  re-admitted, and a parent-side ``fleet_dispatch`` fault is absorbed by
  the same retry. The replicas' values equal one engine's bit for bit;
  the door's trace rides ``X-FM-Trace`` into each replica's own run dir;
  the door's ``/metrics`` carries the fleet's per-replica rollup.
- ``fmtorch serve --fleet`` end to end, its summary naming each
  replica's ``fresh_compiles`` (0) and kernel runs.
"""

import http.server
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from fm_spark_tpu.resilience import faults as jfaults
from fm_spark_tpu.resilience import netfaults as jnet
from fm_spark_tpu_torch import models, obs
from fm_spark_tpu_torch.resilience import faults, netfaults
from fm_spark_tpu_torch.resilience.netfaults import TransportFailure
from fm_spark_tpu_torch.serve import (AdmissionController, FrontDoor,
                                      PredictEngine, loadgen)
from fm_spark_tpu_torch.serve import fleet as fleet_mod
from fm_spark_tpu_torch.serve.fleet import Fleet
from fm_spark_tpu_torch.utils.logging import EventLog, read_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for mod in (faults, jfaults):
        monkeypatch.delenv(mod.ENV_PLAN, raising=False)
        monkeypatch.delenv(mod.ENV_STATE, raising=False)
        mod.clear()
    yield
    faults.clear()
    jfaults.clear()
    obs.shutdown()


# --------------------------------------------------- the transport seam


@pytest.mark.parametrize("plan,call", [
    ("net_connect@1=refuse", ("on_connect",)),
    ("net_send@1=refuse", ("on_send",)),
    ("net_send@1=reset", ("on_send",)),
    ("net_send@1=truncate_after:7", ("on_send",)),
    ("net_recv@1=truncate_after:7", ("on_recv",)),
    ("net_recv@1=slow_ms:5", ("on_recv",)),
    ("net_connect@1=blackhole", ("on_connect", 0.05)),
    ("net_send@1=error", ("on_send",)),
])
def test_net_actions_emulate_the_references_errors(plan, call):
    out = []
    for mod, fmod in ((jnet, jfaults), (netfaults, faults)):
        fmod.activate(plan)
        fn = getattr(mod, call[0])
        try:
            out.append(("ok", fn(None, *call[1:])))
        except Exception as e:  # noqa: BLE001 — compared by type
            out.append((type(e).__name__, None))
    assert out[1] == out[0]


class _ReplicaStub(http.server.BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def do_POST(self):
        self.rfile.read(int(self.headers.get("Content-Length") or 0))
        with self.server.count_lock:
            self.server.handled += 1
            n = self.server.handled
        body = json.dumps({"ok": True, "n": n}).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


@pytest.fixture()
def stub():
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0), _ReplicaStub)
    srv.handled = 0
    srv.count_lock = threading.Lock()
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srv, srv.server_address[1]
    srv.shutdown()
    srv.server_close()


def _dispatch(port, pool=None, timeout_s=10.0):
    return fleet_mod._http_json("127.0.0.1", port, "POST", "/predict",
                                body={"x": 1}, timeout_s=timeout_s,
                                pool=pool, peer="replica-0")


@pytest.mark.parametrize("case", ["send", "recv", "fresh", "blackhole"])
def test_the_transport_keeps_exactly_once(stub, case):
    """A send fault struck before the request left: one more request
    reaches the replica, on the retry dial. A recv fault after response
    bytes arrived: the replica executed it, so it is never replayed
    (the poisoned socket is closed, not parked). A fresh dial's failure
    is real and propagates. A ranged blackhole is a bounded partition
    that heals."""
    srv, port = stub
    pool = fleet_mod.ConnectionPool("127.0.0.1", port, peer="replica-0")
    try:
        if case in ("send", "recv"):
            assert _dispatch(port, pool)[0] == 200 and srv.handled == 1
        if case == "send":
            faults.activate("net_send@1=reset")
            st, doc = _dispatch(port, pool)
            assert st == 200 and doc["ok"] and srv.handled == 2
        elif case == "recv":
            faults.activate("net_recv@1=truncate_after:2")
            with pytest.raises(TransportFailure) as ei:
                _dispatch(port, pool)
            assert ei.value.phase == "recv" and not ei.value.retry_safe
            assert srv.handled == 2 and pool._idle == []
            assert _dispatch(port, pool)[0] == 200 and srv.handled == 3
        elif case == "fresh":
            faults.activate("net_connect@1=refuse")
            with pytest.raises(TransportFailure) as ei:
                _dispatch(port, pool)
            assert ei.value.phase == "connect" and ei.value.retry_safe
            assert srv.handled == 0
        else:
            faults.activate("net_connect@1-2=blackhole")
            for _ in range(2):
                t0 = time.monotonic()
                with pytest.raises(TransportFailure):
                    _dispatch(port, timeout_s=0.1)
                assert time.monotonic() - t0 < 2.0
            assert _dispatch(port, timeout_s=5.0)[0] == 200
            assert srv.handled == 1
    finally:
        pool.close()


def test_faulty_connection_dials_through_the_plan(stub):
    _, port = stub
    faults.activate("net_connect.replica-1@1=refuse")
    conn = netfaults.FaultyHTTPConnection("127.0.0.1", port, peer="replica-1")
    with pytest.raises(ConnectionRefusedError):
        conn.connect()
    other = netfaults.FaultyHTTPConnection("127.0.0.1", port,
                                           peer="replica-0", timeout=5)
    other.connect()           # another peer's link is not partitioned
    other.close()


# ------------------------------------------------------ the fleet drill


def _spec():
    return models.FieldFMSpec(num_features=4 * 64, rank=4, num_fields=4,
                              bucket=64, init_std=0.1)


def _post(port, doc):
    return loadgen._post_predict("127.0.0.1", port,
                                 json.dumps(doc).encode(), timeout_s=60)


def _wait_ready(fleet, want, timeout_s=240.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        reps = fleet.healthz()["replicas"]
        if sum(r["state"] == "ready" for r in reps) >= want:
            return
        time.sleep(0.1)
    raise AssertionError(f"fleet not ready: {fleet.healthz()['replicas']}")


def test_fleet_kill_drill_loses_nothing_and_readmits(tmp_path, monkeypatch):
    """The reference's acceptance drill on the port: the 4th scored
    request across the fleet kills its replica (``os._exit(9)``)
    mid-burst; every request is answered exactly once, the death is
    journaled and the replica re-admitted; then a ``fleet_dispatch``
    fault is absorbed by the retry. Served values equal one engine's bit
    for bit, the door's trace reaches a replica's own run dir, and the
    door's /metrics carries the per-replica rollup."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    spec = _spec()
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    model_dir = str(tmp_path / "model")
    models.save_model(model_dir, spec, params)
    obs_root = str(tmp_path / "obs")
    obs.configure(os.path.join(obs_root, "door"))
    health = str(tmp_path / "fleet_health.jsonl")
    journal = EventLog(health)
    fleet = Fleet(model_dir, n_replicas=2, work_dir=str(tmp_path / "work"),
                  journal=journal, buckets="1,4", device="cpu",
                  compile_cache_dir=str(tmp_path / "cache"),
                  obs_root=obs_root, spawn_timeout_s=240.0,
                  replica_env={faults.ENV_PLAN: "replica_kill@4=exit:9",
                               faults.ENV_STATE: str(tmp_path / "fs.json")})
    fleet.start()
    door = FrontDoor(fleet, admission=AdmissionController(
        "interactive:32:8000,batch:16:8000,background:8:9000",
        service_est_ms=2.0), journal=journal).start()
    try:
        before = door.stats()
        sched = loadgen.make_schedule("flash_crowd", 5, duration_s=0.6,
                                      base_rps=30.0, rows=2,
                                      deadline_ms=8000.0)
        tap = str(tmp_path / "tap.jsonl")
        summary = loadgen.run_loadgen("127.0.0.1", door.port, sched, tap,
                                      nnz=4, num_features=64, threads=6,
                                      attempt_timeout_s=60.0)
        after = door.stats()
        assert summary["by_outcome"] == {"ok": sched.n_requests}
        assert after["answered"] - before["answered"] == sched.n_requests
        assert after["retries"] - before["retries"] >= 1
        per_req = {}
        for a in read_events(tap):
            per_req.setdefault(a["req_id"], []).append(a["status"])
        assert all(v == [200] for v in per_req.values())
        downs = [e for e in read_events(health)
                 if e["event"] == "replica_down"]
        assert [e["rc"] for e in downs] == [9]
        _wait_ready(fleet, 2)
        # The replicas' values against one engine on the same rows.
        eng = PredictEngine(spec, params, buckets=(1, 4), device="cpu")
        eng.warmup()
        served = set()
        for ev in sched.events[:12]:
            ids, vals = loadgen.event_payload(ev, sched, nnz=4,
                                              num_features=64)
            st, doc = _post(door.port, {"id": ev.req_id, "ids": ids,
                                        "vals": vals})
            assert st == 200
            served.add(doc["replica"])
            np.testing.assert_array_equal(
                np.float32(doc["scores"]),
                eng.predict(np.asarray(ids, np.int32),
                            np.asarray(vals, np.float32)))
        eng.close()
        assert served == {0, 1}
        # A parent-side dispatch fault: the retry answers it.
        before = door.stats()
        faults.activate("fleet_dispatch@1=error")
        st, doc = _post(door.port, {"ids": ids, "vals": vals})
        assert st == 200
        d = door.stats()
        assert d["retries"] - before["retries"] >= 1
        assert d["answered"] - before["answered"] == 1
        faults.clear()
        # The door's /metrics: the fleet's rollup with replica labels
        # (each replica's registry as the health loop last scraped it).
        want = [f'fm_spark_fleet_serve_rows_total{{replica="{i}"}}'
                for i in (0, 1)]
        t0 = time.monotonic()
        while True:
            with urllib.request.urlopen(f"{door.url}/metrics") as resp:
                metrics = resp.read().decode()
            if all(w in metrics for w in want):
                break
            assert time.monotonic() - t0 < 30, metrics[-3000:]
            time.sleep(0.25)
        trace = doc["trace"]
    finally:
        faults.clear()
        door.stop()
    obs.shutdown()
    hops = set()
    for run in os.listdir(obs_root):
        path = os.path.join(obs_root, run, "trace.jsonl")
        if os.path.exists(path):
            hops |= {s["name"] for s in read_events(path)
                     if s.get("trace") == trace}
    assert {"frontdoor/request", "fleet/dispatch", "replica/handle",
            "serve/coalesce"} <= hops


def test_serve_fleet_cli_end_to_end(tmp_path, monkeypatch):
    """``fmtorch serve --fleet 2 --frontdoor-port 0 --classes ...
    --serve-seconds --compile-cache`` on the CPU: the door's URL first,
    then answers, then a summary naming each replica's fresh_compiles
    (0) and graph replays."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    spec = _spec()
    model_dir = str(tmp_path / "model")
    models.save_model(model_dir, spec, spec.init(
        torch.Generator().manual_seed(1), device="cpu"))
    env = dict(os.environ, PYTHONPATH=REPO, FM_SPARK_OBS_DIR="none")
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen(
        [sys.executable, "-m", "fm_spark_tpu_torch", "serve", "--model",
         model_dir, "--fleet", "2", "--device", "cpu", "--frontdoor-port",
         "0", "--classes", "interactive:16:4000", "--serve-seconds", "600",
         "--trace-sample", "0.5", "--compile-cache", str(tmp_path / "c"),
         "--buckets", "1,4"], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        line = proc.stdout.readline()
        door = json.loads(line)["frontdoor"]
        assert door["replicas"] == 2 and [c["name"] for c in
                                          door["classes"]] == ["interactive"]
        port = int(door["url"].rsplit(":", 1)[1])
        for i in range(6):
            st, doc = _post(port, {"id": f"q{i}", "ids": [[1, 2, 3, 4]],
                                   "vals": [[1.0, 0.5, 0.25, 1.0]]})
            assert st == 200 and len(doc["scores"]) == 1
        time.sleep(0.6)                   # a health poll of the counts
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    assert proc.returncode == 0, err[-2000:]
    summary = next(json.loads(x)["serve_summary"] for x in out.splitlines()
                   if x.startswith('{"serve_summary"'))
    assert summary["frontdoor"]["answered"] == 6
    reps = summary["replicas"]
    assert [r["fresh_compiles"] for r in reps] == [0, 0]
    assert sum(r["graph_replays"] for r in reps) == 0    # the CPU: eager

