"""The planes wired into ``fmtorch train`` and ``fmtorch serve`` on the
CPU (the kernels' plain versions), against the JAX package where the two
meet:

- ``train --obs-dir D --metrics F --profile P --metrics-port 0`` of a
  small config 3: the run id is the first JSON line; the run dir holds
  ``trace.jsonl`` (the window, checkpoint save and verify spans), the
  flight spool and dump, and the final metrics snapshot; ``F`` holds the
  printed loss lines, one per ``--log-every``; ``P`` a Chrome trace;
- a planted ``train_step@2=device_loss`` ends the run with the
  reference's device-loss class (``is_device_loss`` of both packages) and
  a flight dump that names it;
- SIGTERM under ``--checkpoint-dir`` with the plane on: the checkpoint's
  guard and the plane's dump both run (preempted, and the signal is on
  the flight timeline);
- ``TrainConfig(metrics_path=...)`` writes its file, in ``FMTrainer``
  (configs 1–2, the flat dense step, with the ``train/steps`` and
  ``train/eval`` spans) and in ``fit_field_sparse``;
- ``--obs-dir none`` switches the plane off: no run dir, no run id line;
- ``--data-policy quarantine`` without ``--quarantine-dir`` writes its
  dead letters under the run dir;
- ``serve --obs-dir --slo-ms --metrics-port``: ``serve_health.jsonl``,
  the ``serve/warmup`` and ``serve/batch`` spans, and ``/metrics`` and
  ``/healthz`` scraped while a subprocess serves.
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.request

import pytest

from fm_spark_tpu.resilience import faults as rfaults
from fm_spark_tpu_torch import cli, obs
from fm_spark_tpu_torch.resilience import faults

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG3 = ["--config", "criteo1tb_fm_r64", "--bucket", "64", "--synthetic",
        "2000", "--batch-size", "256", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    faults.clear()
    yield
    faults.clear()
    obs.shutdown()


def _json_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.startswith("{")]


def _run_dir(root):
    [name] = os.listdir(root)
    return os.path.join(root, name)


def _records(path):
    with open(path) as f:
        return [json.loads(x) for x in f if x.strip()]


def test_train_writes_the_run_dir_metrics_and_profile(tmp_path, capsys):
    root, mfile, prof = (str(tmp_path / "obs"), str(tmp_path / "m.jsonl"),
                         str(tmp_path / "prof"))
    assert cli.main(["train", *CFG3, "--steps", "5", "--log-every", "2",
                     "--obs-dir", root, "--metrics", mfile, "--profile",
                     prof, "--metrics-port", "0", "--checkpoint-dir",
                     str(tmp_path / "ck"), "--checkpoint-every", "2"]) == 0
    out = _json_lines(capsys.readouterr().out)
    run = _run_dir(root)
    assert out[0] == {"run_id": os.path.basename(run), "obs_dir": run}
    assert "metrics_port" in out[1]
    printed = [x for x in out if "loss" in x]
    assert [x["step"] for x in printed] == [2, 4, 5]
    assert _records(mfile) == printed
    assert sorted(os.listdir(run)) == ["flight.jsonl", "flight_dump.json",
                                       "metrics.jsonl", "trace.jsonl"]
    spans = [r["name"] for r in _records(os.path.join(run, "trace.jsonl"))]
    assert spans.count("train/steps") == 3
    assert {"checkpoint/save", "checkpoint/verify"} <= set(spans)
    with open(os.path.join(run, "flight_dump.json")) as f:
        dump = json.load(f)
    assert dump["reason"] == "run_end"
    snap = _records(os.path.join(run, "metrics.jsonl"))[-1]
    assert snap["counters"]["train.samples_total"] == 5 * 256
    assert snap["histograms"]["step_time_ms"]["count"] == 3
    with open(os.path.join(prof, "trace.json")) as f:
        assert json.load(f)["traceEvents"]
    assert not obs.enabled()


def test_a_planted_device_loss_ends_the_run_with_the_references_class(
        tmp_path, monkeypatch, capsys):
    monkeypatch.setenv(faults.ENV_PLAN, "train_step@2=device_loss")
    root = str(tmp_path / "obs")
    with pytest.raises(faults.InjectedDeviceLoss) as ei:
        cli.main(["train", *CFG3, "--steps", "4", "--obs-dir", root])
    e = ei.value
    assert faults.is_device_loss(e) and rfaults.is_device_loss(e)
    assert type(e).__name__ == rfaults.InjectedDeviceLoss.__name__
    assert str(e) == str(rfaults.InjectedDeviceLoss("train_step", 2))
    out = _json_lines(capsys.readouterr().out)
    assert [x["step"] for x in out if "loss" in x] == [1]
    with open(os.path.join(_run_dir(root), "flight_dump.json")) as f:
        dump = json.load(f)
    assert dump["reason"] == "run_failed"
    [failed] = [x for x in dump["events"]
                if x["kind"] == "run_failed" and "error" in x]
    assert failed["device_loss"] is True
    assert "InjectedDeviceLoss" in failed["error"]


def test_sigterm_runs_the_checkpoint_guard_and_the_plane_dump(tmp_path):
    root = str(tmp_path / "obs")
    argv = [sys.executable, "-m", "fm_spark_tpu_torch", "train", *CFG3,
            "--steps", "100000", "--log-every", "1", "--obs-dir", root,
            "--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "1000000"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True,
                            cwd=REPO, env=env, stderr=subprocess.DEVNULL)
    try:
        while True:
            line = proc.stdout.readline()
            assert line, "the run ended before its first loss line"
            if '"loss"' in line:
                break
        proc.send_signal(signal.SIGTERM)
        rest, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    assert proc.returncode == 0
    preempted = [x["preempted"] for x in _json_lines(rest)
                 if "preempted" in x]
    assert preempted and preempted[0] >= 1
    kinds = [e["kind"] for e in obs.read_spool(
        os.path.join(_run_dir(root), "flight.jsonl"))]
    assert "signal" in kinds and kinds[-1] == "run_end"


def test_train_config_metrics_path_writes_its_file(tmp_path, capsys):
    import torch

    from fm_spark_tpu_torch import data, models
    from fm_spark_tpu_torch.train import (FMTrainer, TrainConfig,
                                          fit_field_sparse)

    obs.configure(str(tmp_path / "run"))
    ids, vals, labels = data.synthetic_ctr(512, 64, 4, seed=0)
    path = str(tmp_path / "fm.jsonl")
    trainer = FMTrainer(models.FMSpec(num_features=64, rank=4),
                        TrainConfig(num_steps=6, batch_size=64, log_every=2,
                                    eval_every=3, metrics_path=path),
                        device="cpu")
    te = data.iterate_once(ids[:128], vals[:128], labels[:128], 64)
    trainer.fit(data.Batches(ids, vals, labels, 64, seed=0),
                eval_batches=lambda: te)
    lines = _records(path)
    assert [x["step"] for x in lines if "loss" in x] == [2, 4, 6]
    assert [x["step"] for x in lines if "eval_auc" in x] == [3, 6]
    obs.shutdown()
    spans = [r["name"] for r in _records(str(tmp_path / "run" /
                                             "trace.jsonl"))]
    assert spans.count("train/steps") == 3 and spans.count("train/eval") == 2
    spec = models.FieldFMSpec(num_features=4 * 16, rank=4, num_fields=4,
                              bucket=16)
    fids, fvals, flabels = data.synthetic_ctr(256, 64, 4, seed=1)
    fpath = str(tmp_path / "field.jsonl")
    fit_field_sparse(spec, TrainConfig(num_steps=3, batch_size=64,
                                       log_every=1, metrics_path=fpath),
                     data.Batches(data.field_local(fids, 16), fvals, flabels,
                                  64, seed=0), device="cpu", prefetch=0)
    assert [x["step"] for x in _records(fpath)] == [1, 2, 3]
    assert torch.isfinite(torch.tensor([x["loss"]
                                        for x in _records(fpath)])).all()
    capsys.readouterr()


def test_obs_dir_none_switches_the_plane_off(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    assert cli.main(["train", *CFG3, "--steps", "2", "--obs-dir",
                     "none"]) == 0
    out = _json_lines(capsys.readouterr().out)
    assert "run_id" not in out[0] and "loss" in out[0]
    assert os.listdir(tmp_path) == [] and not obs.enabled()
    assert obs.run_dir() is None


def test_quarantine_without_a_dir_writes_under_the_run_dir(tmp_path, capsys):
    from fm_spark_tpu_torch.data import criteo

    lines = []
    criteo.synthesize_tsv(str(tmp_path / "all.tsv"), 600, seed=3)
    with open(tmp_path / "all.tsv", "rb") as f:
        lines = f.read().splitlines()
    lines[5] = b"garbage"
    paths = []
    for s in range(2):
        p = str(tmp_path / f"s{s}.tsv")
        with open(p, "wb") as f:
            f.write(b"\n".join(lines[s * 300:(s + 1) * 300]) + b"\n")
        paths.append(p)
    argv = ["train", "--config", "criteo1tb_fm_r64", "--bucket", "64",
            "--data", ",".join(paths), "--data-policy", "quarantine",
            "--test-fraction", "0", "--batch-size", "128", "--steps", "2",
            "--device", "cpu"]
    root = str(tmp_path / "obs")
    assert cli.main(argv + ["--obs-dir", root]) == 0
    out = _json_lines(capsys.readouterr().out)
    run = _run_dir(root)
    counts = [x for x in out if "bad_records" in x][-1]
    assert counts["bad_records"] == 1
    assert counts["dead_letter"] == os.path.join(run, "deadletter.jsonl")
    with open(os.path.join(run, "deadletter.jsonl")) as f:
        assert json.loads(f.readline())["event"] == "bad_record"
    kinds = [e["kind"] for e in obs.read_spool(os.path.join(run,
                                                            "flight.jsonl"))]
    assert "bad_record" in kinds        # the journal's flight mirror
    with pytest.raises(SystemExit, match="needs --quarantine-dir or an obs"):
        cli.main(argv + ["--obs-dir", "none"])


@pytest.fixture
def model_dir(tmp_path):
    import torch

    from fm_spark_tpu_torch import models

    spec = models.FieldFMSpec(num_features=4 * 16, rank=4, num_fields=4,
                              bucket=16)
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    models.save_model(str(tmp_path / "m"), spec, params)
    return str(tmp_path / "m")


def test_serve_writes_its_journal_and_spans(tmp_path, model_dir, capsys):
    root = str(tmp_path / "obs")
    assert cli.main(["serve", "--model", model_dir, "--synthetic", "64",
                     "--batch-size", "8", "--buckets", "1,8", "--repeat",
                     "3", "--device", "cpu", "--obs-dir", root,
                     "--slo-ms", "5000", "--metrics-port", "0"]) == 0
    out = _json_lines(capsys.readouterr().out)
    run = _run_dir(root)
    assert out[0]["run_id"] == os.path.basename(run)
    assert "metrics_port" in out[1]
    summary = [x["serve_summary"] for x in out if "serve_summary" in x][0]
    assert summary["served_requests"] == 24
    assert os.path.isfile(os.path.join(run, "serve_health.jsonl"))
    spans = [r["name"] for r in _records(os.path.join(run, "trace.jsonl"))]
    assert spans.count("serve/warmup") == 1
    assert spans.count("serve/batch") == 24
    snap = _records(os.path.join(run, "metrics.jsonl"))[-1]
    assert snap["counters"]["serve.requests_total"] == 24
    from fm_spark_tpu_torch.resilience import watchdog

    assert not watchdog.active()                   # the SLO phase disarmed


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def test_serve_is_scraped_while_it_serves(tmp_path, model_dir):
    argv = [sys.executable, "-m", "fm_spark_tpu_torch", "serve", "--model",
            model_dir, "--synthetic", "64", "--batch-size", "8",
            "--buckets", "1,8", "--repeat", "100000", "--max-requests",
            "4000", "--device", "cpu", "--obs-dir", str(tmp_path / "obs"),
            "--metrics-port", "0", "--slo-ms", "5000"]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True,
                            cwd=REPO, env=env, stderr=subprocess.DEVNULL)
    try:
        port = None
        while True:
            line = proc.stdout.readline()
            assert line, "serve ended before it served"
            if '"metrics_port"' in line:
                port = json.loads(line)["metrics_port"]
            if '"serving"' in line:
                break
        give_up = time.monotonic() + 60
        while True:
            metrics = _get(f"http://127.0.0.1:{port}/metrics")
            if "fm_spark_serve_requests_total" in metrics:
                break
            assert time.monotonic() < give_up
            time.sleep(0.05)
        health = json.loads(_get(f"http://127.0.0.1:{port}/healthz"))
        rest, _ = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert proc.returncode == 0
    assert health["status"] == "ok" and health["run_id"]
    assert health["generation_step"] == 0 and health["degraded"] is False
    assert 'run_id="' in metrics
    assert any("serve_summary" in x for x in _json_lines(rest))
