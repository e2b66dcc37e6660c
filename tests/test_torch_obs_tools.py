"""The port's run readers (``fm_spark_tpu_torch/tools/{obs_report,
trace_report,run_doctor}.py``) against the reference's
(``tools/{obs_report,trace_report,run_doctor}.py``) over the same run dirs,
written by the port on the CPU:

- ``fmtorch train --device cpu --obs-dir --profile`` of a narrow config 3
  with a checkpoint chain, and the run's ``fmlint.json``;
- ``fmtorch serve`` of that chain (``serve_health.jsonl`` ends with the
  run's ``serve_summary``);
- ``fmtorch serve --fleet 2 --frontdoor-port 0`` with a replica killed by
  ``replica_kill@4=exit:9`` under a traced loadgen burst (the client,
  the door and fleet parent, each replica: one obs root);
- a chaos campaign's ``chaos_verdict.json``.

The two give the same section numbers, hop tables and findings: the
reports' texts are equal once the tools' own names are mapped (the
title, the command that renders a trace, the port ledger's empty
``bench_leg`` note). The port's ledger file (``ledger_torch.jsonl``) is
handed to the reference's doctor by ``--ledger``.
"""

import contextlib
import importlib.util
import io
import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest
import torch

from fm_spark_tpu_torch import cli, models, obs
from fm_spark_tpu_torch.resilience import chaos, faults
from fm_spark_tpu_torch.serve import loadgen
from fm_spark_tpu_torch.tools import (chaos_drill, fmlint, obs_report,
                                      run_doctor, trace_report)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG3 = ["--config", "criteo1tb_fm_r64", "--bucket", "64", "--synthetic",
        "2000", "--batch-size", "256", "--device", "cpu"]


def _load_ref(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


R_OBS = _load_ref("obs_report")
R_TRACE = _load_ref("trace_report")
R_DOC = _load_ref("run_doctor")


def _quiet(fn, *a):
    with contextlib.redirect_stdout(io.StringIO()), \
            contextlib.redirect_stderr(io.StringIO()):
        return fn(*a)


def _only_dir(root):
    [name] = os.listdir(root)
    return os.path.join(root, name)


def _fleet_obs(base, env):
    """``fmtorch serve --fleet 2`` under a traced loadgen burst; the 4th
    scored request kills its replica. Returns the obs root."""
    spec = models.FieldFMSpec(num_features=4 * 64, rank=4, num_fields=4,
                              bucket=64, init_std=0.1)
    model = os.path.join(base, "fleet_model")
    models.save_model(model, spec, spec.init(
        torch.Generator().manual_seed(1), device="cpu"))
    root = os.path.join(base, "fleet_obs")
    env = dict(env, **{faults.ENV_PLAN: "replica_kill@4=exit:9",
                       faults.ENV_STATE: os.path.join(base, "fs.json")})
    proc = subprocess.Popen(
        [sys.executable, "-m", "fm_spark_tpu_torch", "serve", "--model",
         model, "--fleet", "2", "--device", "cpu", "--frontdoor-port", "0",
         "--classes", "interactive:32:8000,batch:16:8000,background:8:9000",
         "--serve-seconds", "600",
         "--obs-dir", root, "--buckets", "1,4"], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        door = None
        while door is None:              # the run id line comes first
            line = proc.stdout.readline()
            assert line, proc.stderr.read()[-3000:]
            door = json.loads(line).get("frontdoor")
        port = int(door["url"].rsplit(":", 1)[1])
        sched = loadgen.make_schedule("flash_crowd", 5, duration_s=0.6,
                                      base_rps=20.0, rows=2,
                                      deadline_ms=8000.0)
        obs.configure(os.path.join(root, "client"))
        try:
            summary = loadgen.run_loadgen(
                "127.0.0.1", port, sched, os.path.join(base, "tap.jsonl"),
                nnz=4, num_features=64, threads=4, attempt_timeout_s=60.0)
        finally:
            obs.shutdown()
        assert summary["by_outcome"] == {"ok": sched.n_requests}
        t0 = time.monotonic()                 # the killed replica back
        while True:
            with urllib.request.urlopen(door["url"] + "/healthz") as resp:
                reps = json.loads(resp.read())["replicas"]
            if sum(r["state"] == "ready" for r in reps) == 2:
                break
            assert time.monotonic() - t0 < 120, reps
            time.sleep(0.2)
        time.sleep(0.6)                       # a health poll of the counts
    finally:
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=120)
    assert proc.returncode == 0, err[-3000:]
    return root


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("obs_tools"))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO,
               FM_SPARK_OBS_DIR="none")
    env.pop("JAX_PLATFORMS", None)
    env.pop(faults.ENV_PLAN, None)
    torch.set_num_threads(1)
    root = os.path.join(base, "obs")
    prof, ck = os.path.join(base, "prof"), os.path.join(base, "ck")
    assert _quiet(cli.main, [
        "train", *CFG3, "--steps", "3", "--obs-dir",
        os.path.join(root, "train"), "--profile", prof, "--checkpoint-dir",
        ck, "--checkpoint-every", "3", "--test-fraction", "0"]) == 0
    train = _only_dir(os.path.join(root, "train"))
    assert _quiet(fmlint.main, ["--run-id", os.path.basename(train),
                                "--out", train]) == 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert cli.main(["serve", "--config", "criteo1tb_fm_r64", "--bucket",
                         "64", "--checkpoint-dir", ck, "--synthetic", "256",
                         "--batch-size", "16", "--buckets", "1,8,16",
                         "--device", "cpu", "--obs-dir",
                         os.path.join(root, "serve"), "--repeat", "3"]) == 0
    serve_summary = next(json.loads(x)["serve_summary"] for x in
                         out.getvalue().splitlines()
                         if x.startswith('{"serve_summary"'))
    serve = _only_dir(os.path.join(root, "serve"))
    verdict = chaos.run_campaign([0, 1], cfg=chaos.DrillConfig(),
                                 base_dir=os.path.join(base, "drills"),
                                 minimize_failures=False, device="cpu")
    verdict["mode"] = "bounded"
    chaos_dir = os.path.dirname(chaos_drill.write_verdict(
        verdict, os.path.join(root, "chaos")))
    fleet_root = _fleet_obs(base, env)
    door = next(os.path.join(fleet_root, d) for d in os.listdir(fleet_root)
                if os.path.exists(os.path.join(fleet_root, d,
                                               "fleet_health.jsonl")))
    return {"base": base, "train": train, "serve": serve, "prof": prof,
            "serve_summary": serve_summary, "chaos": chaos_dir,
            "fleet_root": fleet_root, "door": door}


def _jsonl(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


_DIRS = ("train", "serve", "door", "chaos")


def _norm(text: str) -> str:
    """The port's text with the tools' own names mapped to the
    reference's."""
    for a, b in (
            ("fm_spark_tpu_torch run report", "fm_spark_tpu run report"),
            ("fm_spark_tpu_torch run doctor", "fm_spark_tpu run doctor"),
            ("python -m fm_spark_tpu_torch.tools.trace_report <obs root>",
             "tools/trace_report.py <obs root>"),
            ("python -m fm_spark_tpu_torch.tools.trace_report <root> "
             "--trace <id>", "tools/trace_report.py --trace <id>"),
            ("python -m fm_spark_tpu_torch.tools.trace_report ",
             "python tools/trace_report.py "),
            ("python -m fm_spark_tpu_torch.tools.fmlint --write-baseline",
             "tools/fmlint.py --write-baseline"),
            ("(no bench_leg ledger records for this run — the port's "
             "ledger carries none until its benchmark writes them, or a "
             "train-only run)", "(no ledger records for this run — "
             "pre-ledger run, or a train-only run)")):
        text = text.replace(a, b)
    return text


# ------------------------------------------------------------ obs_report

@pytest.mark.parametrize("which", _DIRS)
def test_obs_report_matches_reference(runs, which):
    d = runs[which]
    got, want = obs_report.load_run(d), R_OBS.load_run(d)
    for k in ("dir", "run_id", "spans", "snapshot", "timeline",
              "flight_events", "dead", "kernel_pricing"):
        assert got[k] == want[k], k
    assert len(got["captures"]) == len(want["captures"])
    assert _norm(obs_report.render(got)) == R_OBS.render(want)
    assert obs_report.serve_timeline(got["flight_events"]) == \
        R_OBS.serve_timeline(want["flight_events"])
    assert obs_report.online_timeline(got["flight_events"]) == \
        R_OBS.online_timeline(want["flight_events"])


@pytest.mark.parametrize("which", ("train", "serve", "door"))
def test_obs_report_counts_every_span(runs, which, capsys):
    d = runs[which]
    n = sum(1 for r in _jsonl(os.path.join(d, "trace.jsonl"))
            if r.get("event") == "span")
    assert n > 0
    assert obs_report.main([d]) == 0
    assert f"## Phase breakdown ({n} spans)" in capsys.readouterr().out


def test_obs_report_selectors(runs, capsys):
    root = os.path.dirname(runs["train"])
    rid = os.path.basename(runs["train"])
    assert obs_report.main(["--run-id", rid, root]) == 0
    assert rid in capsys.readouterr().out
    assert obs_report.main(["--latest", root]) == 0
    assert obs_report.main(["--run-id", "nope", root]) == 1
    assert obs_report.main([]) == 2


# ---------------------------------------------------------- trace_report

def test_trace_report_matches_reference(runs):
    root = runs["fleet_root"]
    got, want = trace_report.merge(root), R_TRACE.merge(root)
    assert sorted(got) == sorted(want) and got
    for tid in want:
        for k in ("spans", "pids", "hops", "total_ms", "missing",
                  "error_hops", "incomplete"):
            assert got[tid][k] == want[tid][k], (tid, k)
        assert trace_report.breakdown(got[tid]) == \
            R_TRACE.breakdown(want[tid])
    spans = trace_report.collect(root)
    assert trace_report.estimate_skew(spans) == R_TRACE.estimate_skew(spans)
    assert trace_report.tail_exemplar(root) == R_TRACE.tail_exemplar(root)
    assert trace_report.render(got, root=root) == \
        R_TRACE.render(want, root=root)
    tid = sorted(got)[0]
    assert trace_report.render_trace(got[tid]) == \
        R_TRACE.render_trace(want[tid])


def test_trace_report_stitches_the_fleet(runs, capsys):
    """At least one complete trace through the door, the parent and a
    replica; its hops fit inside the client's round trip; the killed
    replica's torn trace is counted, not fatal; the per-(parent, replica)
    clock offsets of processes on one host are near zero."""
    root = runs["fleet_root"]
    merged = trace_report.merge(root)
    complete = [t for t in merged.values() if not t["incomplete"]]
    assert complete
    for t in complete:
        names = set(t["by_name"])
        assert {"frontdoor/request", "fleet/dispatch", "replica/handle",
                "serve/coalesce"} <= names
        assert len(t["pids"]) >= 2
        bd = trace_report.breakdown(t)
        if bd["client"] is not None:
            assert bd["frontdoor"] + bd["dispatch"] <= bd["client"] + 1.0
        assert bd["dispatch"] >= bd["transport"] >= -1.0
    assert sum(t["incomplete"] for t in merged.values()) >= 1
    skew = trace_report.estimate_skew(trace_report.collect(root))
    assert skew and all(abs(v) < 0.5 for v in skew.values()), skew
    assert trace_report.main([root, "--top", "3"]) == 0
    out = capsys.readouterr().out
    assert f"# Request traces ({len(merged)} merged)" in out
    assert "incomplete" in out
    tid = complete[0]["trace_id"]
    assert trace_report.main([root, "--trace", tid]) == 0
    assert trace_report.main([root, "--trace", "no-such"]) == 1
    assert trace_report.main([os.path.join(root, "nope")]) == 2


def test_trace_report_skips_torn_lines(tmp_path):
    d = tmp_path / "run"
    d.mkdir()
    good = {"event": "span", "name": "frontdoor/request", "trace": "t1",
            "span_id": "1f-1", "t_start": 1.0, "dur_ms": 2.0}
    (d / "trace.jsonl").write_text(json.dumps(good) + "\n{torn\n[1]\n")
    assert trace_report.collect(str(tmp_path)) == \
        R_TRACE.collect(str(tmp_path)) == [good]
    assert trace_report.span_pid("1f-1") == 31
    assert trace_report.span_pid("zz") is None


# ------------------------------------------------------------ run_doctor

def _doctor(mod, d, capsys, *extra):
    assert mod.main([d, *extra]) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize("which", _DIRS)
def test_run_doctor_matches_reference(runs, which, capsys):
    d = runs[which]
    ledger = os.path.join(os.path.dirname(d), "ledger_torch.jsonl")
    got = _doctor(run_doctor, d, capsys)
    want = _doctor(R_DOC, d, capsys, "--ledger", ledger)
    assert _norm(got) == want
    run, rrun = obs_report.load_run(d), R_OBS.load_run(d)
    ev = obs_report._read_jsonl(os.path.join(d, "flight.jsonl"))
    assert run_doctor.diagnose(run, [], ev) == R_DOC.diagnose(rrun, [], ev)
    assert run_doctor.serve_diagnose(
        run, obs_report.serve_timeline(ev), []) == R_DOC.serve_diagnose(
        rrun, R_OBS.serve_timeline(ev), [])
    fl = obs_report._read_jsonl(os.path.join(d, "fleet_health.jsonl"))
    assert run_doctor.fleet_diagnose(run, fl) == R_DOC.fleet_diagnose(
        rrun, fl)
    assert run_doctor.storage_diagnose(run, ev) == \
        R_DOC.storage_diagnose(rrun, ev)
    assert run_doctor.tracing_diagnose(d) == R_DOC.tracing_diagnose(d)


def test_run_doctor_train_sections(runs, capsys):
    """Span shares, the fmlint section, and the ``--profile`` trace as a
    capture bundle; the port's ledger has no bench_leg records yet and
    the doctor says so and exits 0."""
    out = _doctor(run_doctor, runs["train"], capsys, "--profile",
                  runs["prof"])
    assert "## Where the time went" in out and "execute" in out
    assert "## Static analysis (fmlint — " in out and "OK)" in out
    # The shipped tree has no baselined finding left to burn down.
    assert "fmlint: clean — zero findings beyond reasoned suppressions" in out
    assert "no bench_leg ledger records" in out
    assert "## Deep captures (1 bundle(s))" in out
    assert "## Device profile (" in out
    assert f"-> {runs['prof']}" in out
    assert run_doctor.main([runs["train"], "--profile",
                            os.path.join(runs["base"], "nope")]) == 1
    assert run_doctor.main([runs["train"], "--ledger"]) == 2


def test_run_doctor_serving_equals_the_journal(runs, capsys):
    """The doctor's request p50/p99 are the run's: the
    ``serve_summary`` journaled in ``serve_health.jsonl`` and printed."""
    d = runs["serve"]
    [summ] = [e for e in _jsonl(os.path.join(d, "serve_health.jsonl"))
              if e.get("event") == "serve_summary"]
    assert summ["request_ms"] == runs["serve_summary"]["request_ms"]
    run = obs_report.load_run(d)
    ev = obs_report._read_jsonl(os.path.join(d, "flight.jsonl"))
    serve = run_doctor.serve_diagnose(run, obs_report.serve_timeline(ev), [])
    hist = serve["histograms"]["serve/request_ms"]
    assert (hist["p50"], hist["p99"]) == (summ["request_ms"]["p50"],
                                          summ["request_ms"]["p99"])
    out = _doctor(run_doctor, d, capsys)
    assert "## Serving" in out and "serving clean" in out
    assert serve["violations"] == []


def test_run_doctor_fleet_and_tracing_sections(runs, capsys):
    out = _doctor(run_doctor, runs["door"], capsys)
    assert "## Serving fleet" in out
    assert "[crash: respawned]" in out and "(rc=9)" in out
    assert "## Request tracing (" in out
    fleet = run_doctor.fleet_diagnose(
        obs_report.load_run(runs["door"]), obs_report._read_jsonl(
            os.path.join(runs["door"], "fleet_health.jsonl")))
    assert [r["rc"] for r in fleet["recoveries"]] == [9]
    c = fleet["counters"]
    assert c["accepted"] == c["answered"] + c["timeout"] + c["failed"]


def test_run_doctor_chaos_verdict(runs, capsys):
    out = _doctor(run_doctor, runs["chaos"], capsys)
    assert "## Chaos verdict (bounded campaign, 2 schedule(s))" in out
    assert "chaos campaign green: 2 seeded schedule(s)" in out


def test_doctor_findings_match_on_synthetic_inputs():
    """The findings functions on inputs no CPU run produces: a failed and
    budget-cut chaos verdict, a red fmlint report, regressed ledger legs,
    a drifting online loop, a thrashing embedding tier and a degraded
    disk."""
    chaos_v = {"all_green": False, "budget_exhausted": True, "n_skipped": 2,
               "failures": [{"seed": 3, "scenario": "commit_loss",
                             "violations": [{"invariant": "no_loss",
                                             "detail": "x"}],
                             "minimized_plan": "train_step@2=device_loss"}]}
    rep = {"new": [{"rule": "bare-print", "path": "p.py", "line": 3,
                    "message": "m"}], "burned_down": [{"rule": "r"}],
           "rules": {"a": "b"}, "counts": {"bare-print": {"p.py": 1}},
           "ok": False, "total_findings": 1}
    legs = [{"variant": "v", "value": 10.0, "fingerprint": {
        "degraded": True, "fused_fallback": True},
        "sentinel": {"verdict": "regressed", "reason": "slow"}}]
    online = {"rollbacks": 1, "demotions": 2, "quarantined": 0, "days": 3,
              "auc": 0.7, "quality_rows": [{"value": 0.6, "day": 2,
                                            "sentinel": {
                                                "verdict": "regressed",
                                                "reason": "r"}}]}
    embed = {"hit_rate": 0.2, "stall_ms": 3.0, "rows": [
        {"leg": "l", "parity_ok": False, "sentinel": {
            "verdict": "regressed"}}]}
    storage = {"io_errors": [{"path": "p", "errno": 28}], "degraded": 1,
               "degraded_window": {"n": 2}, "emergency_gcs": 1,
               "gc_rows": [{"steps": [4]}], "retries": 2}
    diag = {"wall_s": 10.0, "phases": {"compile+warmup": 5.0,
                                       "execute": 1.0,
                                       "faults/backoff": 2.0, "eval": 0.0,
                                       "other": 2.0},
            "ingest_busy_s": 4.0, "fresh_compiles": 2,
            "fault_kinds": {"circuit_open": 1, "failure": 2},
            "backoff_s": 2.0}
    for name, args in (("chaos_findings", (chaos_v,)),
                       ("fmlint_findings", (rep,)),
                       ("render_fmlint", (rep,)),
                       ("online_findings", (online,)),
                       ("embed_findings", (embed,)),
                       ("storage_findings", (storage,)),
                       ("findings", (diag, legs))):
        got = getattr(run_doctor, name)(*args)
        want = getattr(R_DOC, name)(*args)
        assert [_norm(x).replace("fresh compiles", "fresh XLA compiles")
                .replace("(library path measured)", "(XLA path measured)")
                .replace("the in-memory trajectory", "the in-HBM trajectory")
                for x in got] == want, name


def test_profile_bundle_counts_kernels_by_symbol(tmp_path):
    trace = {"traceEvents": [
        {"cat": "kernel", "name": "void bwd_first_pass<64>(...)",
         "dur": 1500.0},
        {"cat": "kernel", "name": "void bwd_first_pass<64>(...)",
         "dur": 500.0},
        {"cat": "kernel", "name": "sr_bits_kernel", "dur": 250.0},
        {"cat": "cpu_op", "name": "aten::add", "dur": 9e9}]}
    (tmp_path / "trace.json").write_text(json.dumps(trace))
    b = run_doctor.profile_bundle(str(tmp_path))
    assert b["kernels"] == [
        {"name": "void bwd_first_pass<64>(...)", "runs": 2,
         "device_ms": 2.0},
        {"name": "sr_bits_kernel", "runs": 1, "device_ms": 0.25}]
    assert b["context"] == {"kernels": 2, "kernel_runs": 3,
                            "device_ms": 2.25}
    assert b["profiler"]["status"] == "ok"
    text = "\n".join(run_doctor.render_profile(b))
    assert "bwd_first_pass" in text and "sr_bits_kernel" in text
    assert run_doctor.profile_bundle(str(tmp_path / "none")) is None


def test_doctor_loads_the_ports_auditor_by_path():
    assert run_doctor.CHAOS_AUDIT_PATH == os.path.join(
        REPO, "fm_spark_tpu_torch", "resilience", "chaos_audit.py")
    assert os.path.isfile(run_doctor.CHAOS_AUDIT_PATH)
