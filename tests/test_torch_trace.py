"""The port's span tracing (``obs/trace.py``) and the obs facade's run
directory (``obs/__init__.py``) held against the JAX package's, with the
clocks patched to the same fake in both, so the records are equal field
for field:

- a :class:`Tracer`'s spans (nested, with attributes, an exception, a
  retroactive ``emit_span``, the decorator) write the same sink lines and
  flight records;
- ``obs.configure(dir)`` → spans, events, a flight dump → ``shutdown``
  leaves the same ``trace.jsonl``, ``flight.jsonl``, ``flight_dump.json``
  and ``metrics.jsonl`` in the run dir;
- ``TraceContext`` parses and renders headers as the reference does;
- the disabled plane is the shared no-op span, writes no registry entry
  and mints no trace (checked by structure, not by a timing ratio).
"""

import itertools
import json
import os
import threading

import pytest

from fm_spark_tpu import obs as robs
from fm_spark_tpu.obs import flight as rflight
from fm_spark_tpu.obs import metrics as rmetrics
from fm_spark_tpu.obs import trace as rtrace
from fm_spark_tpu.utils import logging as rlogging
from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.obs import flight as pflight
from fm_spark_tpu_torch.obs import metrics as pmetrics
from fm_spark_tpu_torch.obs import trace as ptrace
from fm_spark_tpu_torch.utils import logging as plogging


class _Clock:
    """A deterministic stand-in for the ``time`` module."""

    def __init__(self):
        self.t, self.p = 1.7e9, 100.0

    def time(self):
        self.t += 0.25
        return self.t

    def perf_counter(self):
        self.p += 0.0125
        return self.p

    def monotonic(self):
        return self.perf_counter()

    def strftime(self, *a):
        return "19700101-000000"

    def gmtime(self, *a):
        return None

    def sleep(self, s):
        pass


@pytest.fixture()
def clocks(monkeypatch):
    """The same fake clock in each package's trace, flight, metrics and
    logging module, and the span counters restarted."""
    for mods in ((ptrace, pflight, pmetrics, plogging),
                 (rtrace, rflight, rmetrics, rlogging)):
        clock = _Clock()
        for m in mods:
            monkeypatch.setattr(m, "time", clock)
    monkeypatch.setattr(ptrace, "_SEQ", itertools.count(1))
    monkeypatch.setattr(rtrace, "_SEQ", itertools.count(1))
    yield
    obs.shutdown()
    robs.shutdown()
    rmetrics.registry().reset()


def _lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def _drive(tracer_mod, logging_mod, flight_mod, root):
    os.makedirs(root, exist_ok=True)
    sink = logging_mod.EventLog(os.path.join(root, "trace.jsonl"))
    flight = flight_mod.FlightRecorder(
        8, spool_path=os.path.join(root, "flight.jsonl"))
    tr = tracer_mod.Tracer(sink=sink, flight=flight)
    with tr.span("outer", step=3) as sp:
        with tr.span("inner", shard=1):
            pass
        sp.set(loss=0.5, rows=128)
    with pytest.raises(KeyError):
        with tr.span("fails"):
            raise KeyError("x")
    tr.emit_span("train/steps", 1234.5, 0.75, steps=4, step=8)

    @tr.traced("decorated")
    def work(x):
        return x + 1

    assert work(1) == 2
    off = tracer_mod.Tracer(sink=sink, enabled=False)
    assert off.span("never") is tracer_mod.NOOP_SPAN
    sink.close()
    flight.close()
    return (_lines(os.path.join(root, "trace.jsonl")),
            _lines(os.path.join(root, "flight.jsonl")))


def test_tracer_records_equal_the_references(tmp_path, clocks):
    got = _drive(ptrace, plogging, pflight, str(tmp_path / "port"))
    want = _drive(rtrace, rlogging, rflight, str(tmp_path / "ref"))
    assert got == want
    names = [r["name"] for r in got[0]]
    assert names == ["inner", "outer", "fails", "train/steps", "decorated"]
    inner, outer = got[0][0], got[0][1]
    assert inner["parent_id"] == outer["span_id"] and outer["loss"] == 0.5
    assert got[0][2]["error"] == "KeyError"


def _run_dir(mod, root):
    mod.registry().reset()
    mod.configure(root, run_id="run-1")
    with mod.span("checkpoint/save", step=2):
        mod.event("quality_eval", day=1, auc=0.75)
    mod.counter("train.samples_total").add(256)
    mod.histogram("step_time_ms").observe(4.5)
    mod.emit_span("train/steps", 10.0, 0.5, steps=2)
    assert mod.flight_dump("drill", note="x").endswith("flight_dump.json")
    mod.shutdown("run_end")
    return {f: (_lines(os.path.join(root, f)) if f.endswith("jsonl")
                else json.load(open(os.path.join(root, f))))
            for f in sorted(os.listdir(root))}


def test_run_dirs_equal_the_references(tmp_path, clocks):
    got = _run_dir(obs, str(tmp_path / "port"))
    want = _run_dir(robs, str(tmp_path / "ref"))
    assert sorted(got) == ["flight.jsonl", "flight_dump.json",
                           "metrics.jsonl", "trace.jsonl"]
    assert got == want
    assert got["flight_dump.json"]["reason"] == "run_end"
    assert [e["kind"] for e in got["flight.jsonl"]][:2] == ["run_start",
                                                            "quality_eval"]


@pytest.mark.parametrize("value", [
    "abc123;def456", "abc123;", "abc123", "", None, ";x", "bad id;x",
    "a" * 65 + ";b", "trace-1;parent_2", "t;p;q", 42])
def test_trace_context_headers_as_the_reference(value):
    got = ptrace.TraceContext.from_header(value)
    want = rtrace.TraceContext.from_header(value)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.trace_id, got.parent_span_id) == (want.trace_id,
                                                      want.parent_span_id)
        assert got.to_header() == want.to_header()
        assert got.child("s1").to_header() == want.child("s1").to_header()
        assert repr(got) == repr(want)
    assert ptrace.TRACE_HEADER == rtrace.TRACE_HEADER


def test_the_disabled_plane_is_the_shared_noop(tmp_path):
    obs.shutdown()
    assert not obs.enabled() and obs.run_dir() is None
    before = json.dumps(obs.registry().snapshot(), sort_keys=True,
                        default=str)
    spans = [obs.span("train/eval", step=i) for i in range(3)]
    assert all(s is obs.NOOP_SPAN for s in spans)
    with obs.span("x") as sp:
        assert sp.set(a=1) is obs.NOOP_SPAN
    obs.event("quality_eval", day=1)
    obs.emit_span("train/steps", 0.0, 1.0)
    assert obs.flight_dump("x") is None and obs.fault_timeline() == []
    assert obs.mint_trace() is None and obs.export_snapshot() is None
    assert obs.introspect.fire("step_time_spike") is None
    assert obs.introspect.observe_step_time(1e9) is None

    @obs.traced("decorated")
    def f():
        return 7

    assert f() == 7
    snap = json.loads(before)
    after = json.loads(json.dumps(obs.registry().snapshot(), sort_keys=True,
                                  default=str))
    snap.pop("ts"), after.pop("ts")
    assert after == snap          # no registry write from a span or event
    assert not os.listdir(tmp_path)


def test_spans_nest_per_thread(tmp_path):
    obs.configure(str(tmp_path / "run"))
    seen = {}

    def worker():
        with obs.span("worker") as sp:
            seen["worker"] = sp.parent_id

    with obs.span("main") as sp:
        t = threading.Thread(target=worker)
        t.start()
        t.join()
        with obs.span("child") as c:
            seen["child"] = c.parent_id
        seen["main"] = sp.span_id
    obs.shutdown()
    assert seen["worker"] is None and seen["child"] == seen["main"]
