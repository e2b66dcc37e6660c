"""The port's deep-capture engine (``obs/introspect.py``) held against the
JAX package's, and its triggers wired through the port:

- with the clocks patched to the same fake, a sequence of fires (the
  rate limits by count and by interval, an unknown trigger) gives the
  same bundles, manifests (``capture.json``), suppressed counts and
  ``list_captures``; the spike detector and the step cost model give the
  same values;
- the bounded ``torch.profiler`` trace: armed on the main thread only,
  stopped at the first step boundary past ``trace_s`` (``tick``) and by
  ``clear``: never left open; a fire off the main thread, or a
  bundle that fires beside another profiler session (``fmtorch train
  --profile``) or during a CUDA graph capture records a skip;
- the triggers: a watchdog near miss (capture and flight dump), a
  sentinel ``regressed`` verdict, a serve SLO overrun on the engine's
  replay path (the batch fails with ``HangDetected``), a step-time spike
  in ``FMTrainer``'s loop.
"""

import json
import os
import time

import numpy as np
import pytest
import torch

from fm_spark_tpu import obs as robs
from fm_spark_tpu.obs import introspect as rintro
from fm_spark_tpu_torch import graphs, obs
from fm_spark_tpu_torch.obs import introspect
from fm_spark_tpu_torch.resilience import watchdog


@pytest.fixture(autouse=True)
def _clean():
    introspect.clear()
    watchdog.clear()
    yield
    introspect.clear()
    watchdog.clear()
    obs.shutdown()
    robs.shutdown()
    robs.registry().reset()


class _Mono:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


class _Wall:
    def __init__(self):
        self.t = 1.7e9

    def time(self):
        self.t += 1.0
        return self.t


def _fires(pkg_obs, mod, root, monkeypatch):
    monkeypatch.setattr(mod, "time", _Wall())
    pkg_obs.configure(root, run_id="cap")
    mono = _Mono()
    eng = mod.CaptureEngine(root, run_id="cap", profile=False,
                            max_per_trigger=2, min_interval_s=10.0,
                            _monotonic=mono)
    out = []
    for dt, trig in [(0, "step_time_spike"), (1, "step_time_spike"),
                     (20, "step_time_spike"), (40, "step_time_spike"),
                     (0, "watchdog_near_miss"), (0, "sentinel_regressed"),
                     (5, "serve_slo_overrun")]:
        mono.t += dt
        b = eng.fire(trig, step_ms=12.5, traces=["t1"])
        out.append(None if b is None else os.path.basename(b))
    with pytest.raises(ValueError, match="unknown introspection trigger"):
        eng.fire("nope")
    caps = mod.list_captures(root)
    pkg_obs.shutdown()
    for c in caps:
        c.pop("dir")
    return out, eng.suppressed, caps


def test_fires_and_manifests_equal_the_references(tmp_path, monkeypatch):
    got = _fires(obs, introspect, str(tmp_path / "p"), monkeypatch)
    want = _fires(robs, rintro, str(tmp_path / "r"), monkeypatch)
    assert got == want
    out, suppressed, caps = got
    assert out == ["step_time_spike_001", None, "step_time_spike_002", None,
                   "watchdog_near_miss_001", "sentinel_regressed_001",
                   "serve_slo_overrun_001"]
    assert suppressed == 2
    assert caps[0]["files"] == ["flight.json", "metrics.json"]
    assert caps[0]["profiler"] == {"status": "disabled"}
    assert caps[0]["trace_ids"] == ["t1"]
    assert introspect.TRIGGERS == rintro.TRIGGERS
    assert introspect.NEAR_MISS_FRACTION == rintro.NEAR_MISS_FRACTION


def test_list_captures_skips_a_torn_bundle_as_the_reference(tmp_path):
    root = tmp_path / "run"
    for name, body in (("a_001", '{"trigger": "a", "seq": 1}'),
                       ("b_001", '{"trigger": "b"'), ("c_002", None)):
        os.makedirs(root / "captures" / name)
        if body is not None:
            (root / "captures" / name / "capture.json").write_text(body)
    assert introspect.list_captures(str(root)) == \
        rintro.list_captures(str(root))
    assert [m["trigger"] for m in introspect.list_captures(str(root))] == \
        ["a"]


def test_spike_detector_equals_the_references():
    rng = np.random.default_rng(3)
    series = list(rng.gamma(4.0, 2.0, 200)) + [90.0, 8.0, 120.0] * 3
    for kw in ({}, {"window": 16, "factor": 2.0, "min_history": 4}):
        a = introspect.StepSpikeDetector(**kw)
        b = rintro.StepSpikeDetector(**kw)
        assert [a.observe(v) for v in series] == \
            [b.observe(v) for v in series]
        assert a.last_p99 == b.last_p99


@pytest.mark.parametrize("model,batch,rank,kw", [
    ("fm", 131072, 64, {"cap": 12288, "param_bytes": 2}),
    ("ffm", 8192, 16, {}), ("deepfm", 16384, 16, {"fields": 39}),
    ("fm_kaggle", 16384, 32, {"compute_bytes": 2}),
])
def test_step_cost_model_equals_the_references(model, batch, rank, kw):
    assert introspect.step_cost_model(model, batch, rank, **kw) == \
        rintro.step_cost_model(model, batch, rank, **kw)


def _busy(n=20):
    a = torch.randn(64, 64)
    for _ in range(n):
        a = torch.tanh(a @ a * 1e-2)
    return a


def test_the_bounded_trace_stops_and_exports(tmp_path):
    eng = introspect.configure(str(tmp_path), run_id="t", trace_s=0.05,
                               min_interval_s=0.0)
    bundle = introspect.fire("step_time_spike", step_ms=3.0)
    with open(os.path.join(bundle, "capture.json")) as f:
        prof = json.load(f)["profiler"]
    assert prof["status"] == "armed" and prof["trace_s"] == 0.05
    # A second trigger inside the window records the overlap.
    second = introspect.fire("watchdog_near_miss", phase="x")
    with open(os.path.join(second, "capture.json")) as f:
        assert json.load(f)["profiler"]["status"] == \
            "skipped: trace already active"
    give_up = time.monotonic() + 30
    while eng._session is not None:
        _busy()
        introspect.tick()               # the step boundary
        assert time.monotonic() < give_up, "the trace stayed open"
        time.sleep(0.01)
    assert not torch.autograd._profiler_enabled()
    [done] = eng.traces
    assert done["result"].endswith("trace.json")
    with open(done["result"]) as f:
        assert "traceEvents" in json.load(f)


def test_a_fire_off_the_main_thread_begins_no_trace(tmp_path):
    import threading

    eng = introspect.configure(str(tmp_path), trace_s=0.0)
    out = {}
    worker = threading.Thread(target=lambda: out.setdefault(
        "b", introspect.fire("watchdog_near_miss", phase="w")))
    worker.start()
    worker.join()
    assert eng._session is None and not torch.autograd._profiler_enabled()
    with open(os.path.join(out["b"], "capture.json")) as f:
        assert json.load(f)["profiler"]["status"] == \
            "skipped: fired off the main thread"


def test_clear_stops_a_running_trace(tmp_path):
    eng = introspect.configure(str(tmp_path), trace_s=3600.0)
    assert introspect.fire("step_time_spike") is not None
    assert eng._session is not None and torch.autograd._profiler_enabled()
    introspect.clear()
    assert eng._session is None and not torch.autograd._profiler_enabled()


def test_a_capture_beside_another_profiler_or_a_capture_records_a_skip(
        tmp_path):
    introspect.configure(str(tmp_path), min_interval_s=0.0,
                         max_per_trigger=5)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        b = introspect.fire("step_time_spike")
    with open(os.path.join(b, "capture.json")) as f:
        assert json.load(f)["profiler"]["status"] == \
            "skipped: another profiler session is active"
    with graphs.capturing():
        assert graphs.capture_underway()
        b = introspect.fire("step_time_spike")
    assert not graphs.capture_underway()
    with open(os.path.join(b, "capture.json")) as f:
        assert json.load(f)["profiler"]["status"] == \
            "skipped: CUDA graph capture underway"


def test_a_watchdog_near_miss_fires_a_capture_and_a_flight_dump(tmp_path):
    run = str(tmp_path / "run")
    obs.configure(run, run_id="nm")
    introspect.configure(run, run_id="nm", profile=False, min_interval_s=0.0)
    table = watchdog.configure({"ckpt_commit": 1.0}, action="raise")
    with watchdog.phase("ckpt_commit"):
        time.sleep(0.84)                 # 84 % of the deadline
    assert table.near_misses == 1 and table.hangs_detected == 0
    [cap] = introspect.list_captures(run)
    assert cap["trigger"] == "watchdog_near_miss"
    assert 0.8 < cap["context"]["frac"] <= 1.0
    with open(os.path.join(run, "flight_dump.json")) as f:
        assert json.load(f)["reason"] == "watchdog_near_miss"
    with pytest.raises(watchdog.HangDetected):
        with watchdog.phase("ckpt_commit"):
            time.sleep(1.1)
    with open(os.path.join(run, "flight_dump.json")) as f:
        assert json.load(f)["reason"] == "hang_detected"
    assert [e["kind"] for e in obs.fault_timeline()] == [
        "capture_fired", "watchdog_near_miss", "hang_detected"]


def test_a_sentinel_regression_fires_a_capture(tmp_path):
    from fm_spark_tpu_torch.obs.ledger import (PerfLedger,
                                               measurement_fingerprint)
    from fm_spark_tpu_torch.obs.sentinel import Sentinel

    run = str(tmp_path / "run")
    obs.configure(run)
    introspect.configure(run, profile=False)
    sent = Sentinel(PerfLedger(str(tmp_path / "ledger.jsonl")))
    fp = measurement_fingerprint(variant="leg")
    for i, v in enumerate([100.0, 101.0, 99.0, 100.5, 99.5, 100.0, 30.0]):
        block = sent.observe({"kind": "bench", "leg": "leg", "run_id": "r",
                              "value": v, "fingerprint": fp})
    assert block["verdict"] == "regressed"
    [cap] = introspect.list_captures(run)
    assert cap["trigger"] == "sentinel_regressed"
    assert cap["context"]["value"] == 30.0


def test_a_serve_slo_overrun_fails_the_batch_and_fires_a_capture(tmp_path):
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.serve import PredictEngine

    spec = models.FieldFMSpec(num_features=4 * 16, rank=4, num_fields=4,
                              bucket=16)
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    run = str(tmp_path / "run")
    obs.configure(run)
    introspect.configure(run, profile=False)
    eng = PredictEngine(spec, params, nnz=4, buckets=(1, 4),
                        latency_budget_ms=0.0, device="cpu")
    eng.warmup()
    ids = np.zeros((2, 4), np.int32)
    vals = np.ones((2, 4), np.float32)
    ok = eng.predict(ids, vals)
    watchdog.configure({"serve_request": 1e-9}, action="raise")
    with pytest.raises(watchdog.HangDetected):
        eng.predict(ids, vals)
    watchdog.clear()
    assert np.array_equal(eng.predict(ids, vals), ok)
    eng.close()
    assert obs.counter("serve.slo_overruns_total").value == 1
    [cap] = introspect.list_captures(run)
    assert cap["trigger"] == "serve_slo_overrun"
    assert cap["context"]["phase"] == "serve_request"
    kinds = [e["kind"] for e in obs.fault_timeline()]
    assert "serve_slo_overrun" in kinds and "serve_batch_failed" in kinds


def test_a_step_time_spike_in_the_trainer_fires_a_capture(tmp_path,
                                                          monkeypatch):
    from fm_spark_tpu_torch import data, models
    from fm_spark_tpu_torch.train import FMTrainer, TrainConfig

    run = str(tmp_path / "run")
    obs.configure(run)
    introspect.configure(run, profile=False, spike_min_history=4,
                         spike_factor=3.0, min_interval_s=0.0,
                         max_per_trigger=20)
    spec = models.FMSpec(num_features=64, rank=4)
    ids, vals, labels = data.synthetic_ctr(512, 64, 4, seed=0)
    trainer = FMTrainer(spec, TrainConfig(num_steps=12, batch_size=32,
                                          log_every=1), device="cpu")
    trainer.logger._stream = open(os.devnull, "w")
    slow = {"at": 10}
    inner = trainer._train_step

    def step(*a):
        if trainer.step_count + 1 == slow["at"]:
            time.sleep(0.5)            # one step far past the trailing p99
        return inner(*a)

    monkeypatch.setattr(trainer, "_train_step", step)
    trainer.fit(data.Batches(ids, vals, labels, 32, seed=0))
    trainer.logger._stream.close()
    caps = introspect.list_captures(run)
    assert {c["trigger"] for c in caps} == {"step_time_spike"}
    assert any(c["context"]["step_ms"] >= 400 for c in caps)
    assert obs.histogram("step_time_ms").summary()["count"] == 11
