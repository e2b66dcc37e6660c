"""The port's continuous-learning loop (``fm_spark_tpu_torch.online``):
the cases of ``tests/test_online.py`` on the CPU, then against the JAX
package's loop.

- a planted label-flip drift fires the sentry at the FIRST drifted eval
  day, the day's save is demoted, ``last_good`` republished at the
  pre-drift save, the weights roll back IN PLACE (the trainer keeps its
  tensors) and the step axis moves past the tombstoned frontier;
- the sentry's window is durable and a killed run replays its missed
  eval on resume;
- ``quality_eval`` ledger records land under their own leg namespace;
- ``fmtorch train --online --optimizer ftrl`` runs the protocol end to
  end, and a serving follower on the chain never loads a demoted
  generation;
- from one init and on the same days, the port's run rolls back on the
  same days and demotes the same steps as JAX's, its AUC series within
  1e-4 (the two sum a duplicated id's gradient in another order).

The faults plane's plans are not ported, so the drills patch
``faults.inject``.
"""

import io
import json
import os
import time

import numpy as np
import pytest
import torch

from fm_spark_tpu_torch import models, online
from fm_spark_tpu_torch.checkpoint import Checkpointer
from fm_spark_tpu_torch.data import synthetic_ctr
from fm_spark_tpu_torch.resilience import faults, watchdog
from fm_spark_tpu_torch.resilience.divergence import DivergenceDetected
from fm_spark_tpu_torch.train import FMTrainer, TrainConfig
from fm_spark_tpu_torch.utils.logging import EventLog, read_events


@pytest.fixture(autouse=True)
def _clean_watchdog():
    watchdog.clear()
    yield
    watchdog.clear()


def _days(n_days=8, n=4096, features=256, drift_day=None, seed=3):
    ids, vals, labels = synthetic_ctr(n, features, 4, seed=seed)
    days = online.split_days(ids, vals, labels, n_days)
    if drift_day is not None:
        days = online.flip_labels(days, drift_day)
    return days


def _trainer(features=256, optimizer="ftrl", batch=128):
    spec = models.FMSpec(num_features=features, rank=4, init_std=0.05)
    cfg = TrainConfig(num_steps=0, batch_size=batch, learning_rate=0.1,
                      lr_schedule="constant", optimizer=optimizer,
                      log_every=10_000)
    tr = FMTrainer(spec, cfg, device="cpu")
    tr.logger._stream = io.StringIO()
    return tr


def _ck(tmp_path, journal=None):
    return Checkpointer(str(tmp_path / "ck"), save_every=10**9,
                        journal=journal)


def _at(point, n, action):
    """``faults.inject`` doing ``action`` at the ``n``-th call of
    ``point``."""
    seen = [0]

    def inject(p):
        if p == point:
            seen[0] += 1
            if seen[0] == n:
                action()
    return inject


def _raise():
    raise faults.FaultInjected("injected fault at online_eval")


def test_split_days_is_temporal_and_validates():
    ids, vals, labels = synthetic_ctr(100, 64, 4, seed=0)
    days = online.split_days(ids, vals, labels, 4)
    assert sum(len(d[2]) for d in days) == 100
    assert np.array_equal(np.concatenate([d[0] for d in days]), ids)
    with pytest.raises(ValueError, match=">= 2 days"):
        online.split_days(ids, vals, labels, 1)
    flipped = online.flip_labels(days, 2)
    assert np.array_equal(flipped[1][2], days[1][2])
    assert np.array_equal(flipped[3][2], 1.0 - days[3][2])


def test_drift_guard_requires_max_mode(tmp_path):
    from fm_spark_tpu_torch.resilience.divergence import DivergenceGuard

    ck = _ck(tmp_path)
    with pytest.raises(ValueError, match="max"):
        online.run_online(_trainer(), _days(), ck,
                          sentry=DivergenceGuard(mode="min"))
    ck.close()


def test_label_flip_drift_demotes_and_rolls_back_in_place(tmp_path):
    journal = EventLog(str(tmp_path / "health.jsonl"))
    tr = _trainer()
    tensors = {k: t for k, t in tr.params.items()}
    ck = _ck(tmp_path, journal)
    summary = online.run_online(
        tr, _days(drift_day=5), ck, sentry=online.drift_guard(
            journal=journal), journal=journal)
    assert summary["rollbacks"] == 1
    assert summary["demoted_steps"]
    rolled = [d for d in summary["days"] if d["rolled_back"]]
    assert rolled and rolled[0]["eval_day"] == 5  # first drifted day
    stones = ck.tombstoned_steps()
    assert set(summary["demoted_steps"]) <= stones
    assert summary["last_good"] not in stones
    assert summary["final_step"] > max(stones) == ck.tombstone_frontier()
    # The rollback copied into the trainer's own tensors.
    assert all(tr.params[k] is t for k, t in tensors.items())
    evs = [e.get("event") for e in read_events(
        str(tmp_path / "health.jsonl"))]
    for wanted in ("divergence_detected", "generation_demoted",
                   "last_good_republished", "online_rollback",
                   "quality_eval"):
        assert wanted in evs
    ck.close()
    journal.close()


def test_no_drift_means_no_rollback(tmp_path):
    ck = _ck(tmp_path)
    summary = online.run_online(_trainer(), _days(n_days=5), ck,
                                sentry=online.drift_guard())
    assert summary["rollbacks"] == 0
    assert ck.tombstoned_steps() == set() and ck.tombstone_frontier() == 0
    assert summary["last_good"] == summary["final_step"]
    ck.close()


def test_kill_between_save_and_eval_replays_the_drift_check(
        tmp_path, monkeypatch):
    """The run dies AFTER the drifted day's save commits, BEFORE its eval:
    the resumed run replays the eval from the checkpoint's durable sentry
    state and still fires — with the uninterrupted run's AUC series and
    final params, bit for bit."""
    days = _days(drift_day=5)
    full_tr = _trainer()
    full_ck = Checkpointer(str(tmp_path / "full"), save_every=10**9)
    full = online.run_online(full_tr, days, full_ck,
                             sentry=online.drift_guard())
    full_ck.close()

    journal = EventLog(str(tmp_path / "health.jsonl"))
    monkeypatch.setattr(faults, "inject", _at("online_eval", 5, _raise))
    ck = _ck(tmp_path, journal)
    with pytest.raises(faults.FaultInjected):
        online.run_online(_trainer(), days, ck,
                          sentry=online.drift_guard(journal=journal),
                          journal=journal)
    ck.close()
    monkeypatch.undo()

    tr2 = _trainer()
    ck2 = _ck(tmp_path, journal)
    summary = online.run_online(
        tr2, days, ck2, sentry=online.drift_guard(journal=journal),
        journal=journal)
    assert summary["rollbacks"] == 1
    rolled = [d for d in summary["days"] if d["rolled_back"]]
    assert rolled and rolled[0]["eval_day"] == 5
    assert set(summary["demoted_steps"]) <= ck2.tombstoned_steps()
    assert summary["demoted_steps"] == full["demoted_steps"]
    by_day = {d["eval_day"]: d["auc"] for d in full["days"]}
    assert all(by_day[d["eval_day"]] == d["auc"] for d in summary["days"])
    for k in ("w0", "w", "v"):
        assert torch.equal(tr2.params[k], full_tr.params[k]), k
    ck2.close()
    journal.close()


def test_online_eval_watchdog_phase_bounds_a_hang(tmp_path, monkeypatch):
    monkeypatch.setattr(faults, "inject",
                        _at("online_eval", 1, lambda: time.sleep(0.3)))
    watchdog.configure({"online_eval": 0.05}, action="raise")
    ck = _ck(tmp_path)
    with pytest.raises(watchdog.HangDetected, match="online_eval"):
        online.run_online(_trainer(), _days(n_days=4), ck,
                          sentry=online.drift_guard())
    ck.close()


def test_rollback_budget_exhaustion_propagates(tmp_path):
    ck = _ck(tmp_path)
    with pytest.raises(DivergenceDetected):
        online.run_online(_trainer(), _days(drift_day=4, n_days=8), ck,
                          sentry=online.drift_guard(max_rollbacks=0))
    assert ck.tombstoned_steps()
    ck.close()


def test_quality_eval_ledger_records_and_cohorts(tmp_path):
    from fm_spark_tpu_torch.obs.ledger import (PerfLedger,
                                               measurement_fingerprint)

    ledger = PerfLedger(str(tmp_path / "ledger.jsonl"))
    fp = measurement_fingerprint(variant="quality/test/ftrl",
                                 model="fm", batch=128, n_chips=1)
    ck = _ck(tmp_path)
    summary = online.run_online(
        _trainer(), _days(n_days=5), ck, sentry=online.drift_guard(),
        ledger=ledger, leg="quality/test/ftrl", fingerprint=fp,
        run_id="r-test")
    recs = ledger.records(kind="quality_eval")
    assert len(recs) == summary["days_trained"]
    assert all(r["leg"] == "quality/test/ftrl" for r in recs)
    assert all(isinstance(r.get("value"), float) for r in recs)
    assert all("sentinel" in r for r in recs)
    assert ledger.records(kind="bench_leg") == []
    ck.close()


def test_online_requires_provenance_fields(tmp_path):
    from fm_spark_tpu_torch.obs.ledger import PerfLedger

    ck = _ck(tmp_path)
    with pytest.raises(ValueError, match="provenance"):
        online.run_online(_trainer(), _days(n_days=4), ck,
                          ledger=PerfLedger(str(tmp_path / "l.jsonl")))
    ck.close()


def _cli_online(tmp_path, *extra):
    from fm_spark_tpu_torch import cli

    return cli.main([
        "train", "--config", "movielens_fm_r8", "--synthetic", "4096",
        "--online", "--online-days", "8", "--optimizer", "ftrl",
        "--batch-size", "128", "--lr", "0.1", "--steps", "0",
        "--checkpoint-dir", str(tmp_path / "ck"), "--log-every", "10000",
        "--test-fraction", "0", "--device", "cpu", *extra])


def test_cli_online_end_to_end_with_serving_follower(tmp_path, capsys):
    """``fmtorch train --online --optimizer ftrl`` with a planted drift:
    quality_eval records in the ledger, the sentry fires, the bad
    generation is demoted — and a serving follower on the same chain
    skips every demoted generation and serves the good tip."""
    from fm_spark_tpu_torch.serve import PredictEngine, ReloadFollower

    ck_dir = tmp_path / "ck"
    ledger_path = tmp_path / "ledger.jsonl"
    assert _cli_online(tmp_path, "--drift-inject", "5", "--quality-ledger",
                       str(ledger_path)) == 0
    out = capsys.readouterr().out
    summary = json.loads(
        [ln for ln in out.splitlines() if '"online"' in ln][-1])["online"]
    assert summary["rollbacks"] >= 1 and summary["demoted_steps"]
    recs = [json.loads(ln) for ln in open(ledger_path)]
    assert {r["kind"] for r in recs} == {"quality_eval"}
    assert all(r["leg"].startswith("quality/") for r in recs)
    assert os.path.exists(ck_dir / "health.jsonl")

    spec = models.FMSpec(num_features=4096, rank=8, init_std=0.01)
    init = spec.init(torch.Generator().manual_seed(0), device="cpu")
    journal = EventLog()
    eng = PredictEngine(spec, init, nnz=2, buckets=(8,),
                        latency_budget_ms=0.0, device="cpu", journal=journal)
    eng.warmup()
    fol = ReloadFollower(eng, str(ck_dir), poll_s=0.05, journal=journal)
    try:
        assert fol.poll_once() == "swapped"
        ck = Checkpointer(str(ck_dir), save_every=10**9)
        stones = ck.tombstoned_steps()
        ck.close()
        assert stones, "drift run left no tombstones"
        assert eng.generation().step == summary["last_good"]
        assert eng.generation().step not in stones
        swapped = [e["step"] for e in journal.records
                   if e["event"] == "serve_swap"]
        assert swapped and not set(swapped) & stones
        assert fol.poll_once() == "fresh"
    finally:
        fol.stop()
        eng.close()


def test_cli_online_refusals(tmp_path, capsys):
    from fm_spark_tpu_torch import cli

    base = ["train", "--synthetic", "512", "--online", "--steps", "0",
            "--device", "cpu"]
    with pytest.raises(SystemExit, match="--checkpoint-dir"):
        cli.main(base + ["--config", "movielens_fm_r8"])
    with pytest.raises(SystemExit, match="strategy 'single'"):
        cli.main(base + ["--config", "criteo1tb_fm_r64", "--bucket", "64",
                         "--checkpoint-dir", str(tmp_path / "a")])
    with pytest.raises(SystemExit, match="real day shards"):
        cli.main(["train", "--config", "movielens_fm_r8", "--online",
                  "--steps", "0", "--data", "a.txt,b.txt", "--drift-inject",
                  "2", "--checkpoint-dir", str(tmp_path / "b"),
                  "--device", "cpu"])
    with pytest.raises(SystemExit, match="--online needs time-ordered"):
        cli.main(["train", "--config", "movielens_fm_r8", "--online",
                  "--steps", "0", "--data", "a.txt", "--checkpoint-dir",
                  str(tmp_path / "c"), "--device", "cpu"])


def test_cli_online_from_day_shards(tmp_path, capsys):
    """``--data d0,d1,d2,d3``: one Criteo TSV shard per day (config 2 at a
    narrow bucket)."""
    from fm_spark_tpu_torch import cli
    from fm_spark_tpu_torch.data import criteo

    paths = []
    for d in range(4):
        p = str(tmp_path / f"d{d}.tsv")
        criteo.synthesize_tsv(p, 600, seed=d)
        paths.append(p)
    assert cli.main([
        "train", "--config", "criteo_kaggle_fm_r32", "--bucket", "64",
        "--data", ",".join(paths), "--online", "--optimizer", "ftrl",
        "--batch-size", "128", "--steps", "0", "--checkpoint-dir",
        str(tmp_path / "ck"), "--device", "cpu"]) == 0
    summary = json.loads([ln for ln in capsys.readouterr().out.splitlines()
                          if '"online"' in ln][-1])["online"]
    assert summary["days_trained"] == 3 and summary["records_seen"] == 1800
    assert all(0.0 <= d["auc"] <= 1.0 for d in summary["days"])


def test_cli_divergence_guard_needs_a_chain(tmp_path):
    from fm_spark_tpu_torch import cli

    with pytest.raises(SystemExit, match="--divergence-guard requires"):
        cli.main(["train", "--config", "movielens_fm_r8", "--synthetic",
                  "512", "--steps", "2", "--divergence-guard", "--device",
                  "cpu"])


# ------------------------------------------------------ against the JAX loop


def test_run_online_matches_jax(tmp_path):
    import jax

    from fm_spark_tpu import models as jmodels
    from fm_spark_tpu import online as jonline
    from fm_spark_tpu.checkpoint import Checkpointer as JCheckpointer
    from fm_spark_tpu.data import synthetic_ctr as jax_synthetic_ctr
    from fm_spark_tpu.train import FMTrainer as JFMTrainer
    from fm_spark_tpu.train import TrainConfig as JTrainConfig

    days = _days(drift_day=5)
    jdays = jonline.flip_labels(jonline.split_days(
        *jax_synthetic_ctr(4096, 256, 4, seed=3), 8), 5)
    for a, b in zip(days, jdays):
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    kw = dict(num_features=256, rank=4, init_std=0.05)
    cfg = dict(num_steps=0, batch_size=128, learning_rate=0.1,
               lr_schedule="constant", optimizer="ftrl", log_every=10_000)
    jt = JFMTrainer(jmodels.FMSpec(**kw), JTrainConfig(**cfg))
    jt.logger._stream = None
    jck = JCheckpointer(str(tmp_path / "jck"), save_every=10**9,
                        async_save=False)
    want = jonline.run_online(jt, jdays, jck, sentry=jonline.drift_guard())
    jck.close()

    tr = _trainer()
    init = jmodels.FMSpec(**kw).init(jax.random.key(0))
    with torch.no_grad():
        for k, t in tr.params.items():
            t.copy_(torch.from_numpy(np.array(init[k])))
    tr.opt_state = tr.optimizer.init(tr.params)
    ck = _ck(tmp_path)
    got = online.run_online(tr, days, ck, sentry=online.drift_guard())
    ck.close()
    assert got["rollbacks"] == want["rollbacks"] == 1
    assert got["demoted_steps"] == want["demoted_steps"]
    assert got["final_step"] == want["final_step"]
    assert got["last_good"] == want["last_good"]
    assert [d["eval_day"] for d in got["days"] if d["rolled_back"]] == \
        [d["eval_day"] for d in want["days"] if d["rolled_back"]]
    np.testing.assert_allclose([d["auc"] for d in got["days"]],
                               [d["auc"] for d in want["days"]],
                               rtol=0, atol=1e-4)
