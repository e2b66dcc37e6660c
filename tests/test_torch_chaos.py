"""The port's chaos campaign, training half (``fm_spark_tpu_torch/
resilience/chaos.py``), held against the JAX package's on the CPU:

- the schedule generator gives the reference's plan, scenario and audit
  contract seed for seed (0–199), and the pure-Python oracle its taps;
- :func:`chaos.audit` returns the reference's violations on the same
  artifacts (the port's drilled run, both auditors reading its chain
  through the port's checkpointer), clean and with one planted
  violation per invariant;
- a stream-comparable schedule drilled by the port admits the same
  record stream as the reference's drill (record ids do not depend on
  the numerics);
- the acceptance drills of ``tests/test_chaos.py``: the 25-seed tier-1
  soak all green inside the reference's budget with the reference's
  scenario and outcome per seed, the canary caught and minimized to
  <= 2 rules, budget exhaustion reported loudly, the cross-path
  (native <-> Python ingest) compound schedule, and the SIGKILL during
  flight-spool compaction (the worker is a subprocess on the CPU);
- every runner resolves its device first: without a card and without
  ``device="cpu"`` it raises ``DeviceUnavailable`` (the worker too).
"""

import dataclasses
import os
import signal
import subprocess
import sys

import pytest
import torch

from fm_spark_tpu import checkpoint as jcheckpoint
from fm_spark_tpu.resilience import chaos as jchaos
from fm_spark_tpu_torch import DeviceUnavailable
from fm_spark_tpu_torch import checkpoint as pcheckpoint
from fm_spark_tpu_torch.resilience import chaos, faults, watchdog
from fm_spark_tpu_torch.utils.logging import read_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SOAK_SEEDS = tuple(range(25))
SOAK_BUDGET_S = 240.0
SOAK_PER_SCHEDULE_S = 30.0
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    monkeypatch.delenv(faults.ENV_STATE, raising=False)
    monkeypatch.delenv(watchdog.ENV_SPEC, raising=False)
    monkeypatch.delenv(watchdog.ENV_ACTION, raising=False)
    faults.clear()
    watchdog.clear()
    yield
    faults.clear()
    watchdog.clear()


def _contract(s):
    return (s.seed, s.scenario, s.rules, s.plan, s.expects,
            s.stream_comparable, s.oracle_comparable, s.max_bad_frac)


# ------------------------------------------------------------ generator


def test_generator_equals_the_reference_seed_for_seed():
    port = chaos.ScheduleGenerator().sample(range(200))
    ref = jchaos.ScheduleGenerator().sample(range(200))
    assert [_contract(s) for s in port] == [_contract(s) for s in ref]
    # A config changes the drawn parameters the same way in both.
    cfg = chaos.DrillConfig(steps=30, guard_min_records=20)
    jcfg = jchaos.DrillConfig(steps=30, guard_min_records=20)
    assert ([_contract(s) for s in chaos.ScheduleGenerator(cfg).sample(
        range(200))] == [_contract(s) for s in jchaos.ScheduleGenerator(
            jcfg).sample(range(200))])
    assert {s.scenario for s in port} == {
        "commit_loss", "recovery_storm", "corrupt_burst", "truncate_loss",
        "hang", "ingest_abort", "compound"}


@pytest.mark.parametrize("seed", [-1, 9, 13, 41])
def test_oracle_equals_the_reference(seed):
    cfg, jcfg = chaos.DrillConfig(), jchaos.DrillConfig()
    if seed < 0:
        port = chaos.Schedule(seed=-1, scenario="golden", rules=())
        ref = jchaos.Schedule(seed=-1, scenario="golden", rules=())
    else:
        port = chaos.ScheduleGenerator().schedule(seed)
        ref = jchaos.ScheduleGenerator().schedule(seed)
    assert chaos.oracle_tap(port, cfg) == jchaos.oracle_tap(ref, jcfg)


def test_build_shards_equal_the_reference(tmp_path):
    cfg = chaos.DrillConfig()
    a = chaos.build_shards(str(tmp_path / "p"), cfg)
    b = jchaos.build_shards(str(tmp_path / "j"), jchaos.DrillConfig())
    assert [open(x).read() for x in a] == [open(x).read() for x in b]


# -------------------------------------------------------------- auditor


class _PortCheckpointer(pcheckpoint.Checkpointer):
    """The port's checkpointer behind the reference's call shape, so the
    reference's ``_audit_chain`` reads the port's chain."""

    def __init__(self, directory, save_every=1000, max_to_keep=3,
                 async_save=True, journal=None):
        super().__init__(directory, save_every, max_to_keep, journal)

    def restore(self, params=None, opt_state=None, step=None):
        return super().restore(None, step)


@pytest.fixture(scope="module")
def drilled(tmp_path_factory):
    """A golden run and a drilled recovery (seed 1: a commit-window loss
    and a mid-step loss) of the port, on the CPU."""
    base = tmp_path_factory.mktemp("drilled")
    cfg = chaos.DrillConfig()
    shards = chaos.build_shards(str(base / "shards"), cfg)
    golden = chaos.golden_run(cfg, str(base / "golden"), shard_paths=shards,
                              device=CPU)
    sched = chaos.ScheduleGenerator().schedule(1)
    result = chaos.run_schedule(sched, cfg, str(base / "s1"),
                                shard_paths=shards, device=CPU)
    return cfg, golden, sched, result


def _both(monkeypatch, sched, result, golden, cfg):
    port = chaos.audit(sched, result, golden, cfg)
    monkeypatch.setattr(jcheckpoint, "Checkpointer", _PortCheckpointer)
    jsched = jchaos.Schedule(**dataclasses.asdict(sched))
    ref = jchaos.audit(jsched, jchaos.DrillResult(**dataclasses.asdict(
        result)), jchaos.DrillResult(**dataclasses.asdict(golden)),
        jchaos.DrillConfig(**dataclasses.asdict(cfg)))
    return port, ref


def _copy_result(result, tmp_path, **changes):
    """A copy of ``result`` whose journal and dead letters live under
    ``tmp_path`` (so a planted line does not touch the shared run)."""
    import shutil

    os.makedirs(tmp_path, exist_ok=True)
    health = str(tmp_path / "health.jsonl")
    dead = str(tmp_path / "deadletter.jsonl")
    shutil.copy(result.health_path, health)
    if os.path.exists(result.deadletter_path):
        shutil.copy(result.deadletter_path, dead)
    return dataclasses.replace(result, health_path=health,
                               deadletter_path=dead, **changes)


def _plants(result, cfg):
    """One planted violation per invariant the artifacts can carry."""
    tap = list(result.tap)
    tap[3] = tap[4]
    sums = dict(result.params_sums)
    sums["['v']"] = "<f4:(128, 4):00000000"
    return {
        "completion_outcome": dict(outcome="circuit_open",
                                   error="CircuitOpen: x"),
        "completion_steps": dict(steps_done=cfg.steps - 1),
        "completion_nan": dict(loss_history=result.loss_history[:-1]
                               + [float("nan")]),
        "exactly_once_stream": dict(tap=tap),
        "exactly_once_short": dict(tap=tap[:-2]),
        "loss_continuity": dict(loss_history=[x + 1.0 for x in
                                              result.loss_history]),
        "state_identity_params": dict(params_sums=sums),
        "state_identity_cursor": dict(cursor=dict(result.cursor,
                                                  offset=-1)),
        "quarantine_counters": dict(counters={"ok": 1, "bad": 3}),
        "quarantine_cursor": dict(cursor=dict(result.cursor, ok=-5)),
    }


def test_audit_clean_equals_the_reference(drilled, monkeypatch):
    cfg, golden, sched, result = drilled
    assert result.outcome == "completed"
    port, ref = _both(monkeypatch, sched, result, golden, cfg)
    assert port == ref == []


@pytest.mark.parametrize("plant", [
    "completion_outcome", "completion_steps", "completion_nan",
    "exactly_once_stream", "exactly_once_short", "loss_continuity",
    "state_identity_params", "state_identity_cursor",
    "quarantine_counters", "quarantine_cursor"])
def test_audit_planted_violation_equals_the_reference(
        drilled, monkeypatch, tmp_path, plant):
    cfg, golden, sched, result = drilled
    bad = _copy_result(result, tmp_path,
                       **_plants(result, cfg)[plant])
    port, ref = _both(monkeypatch, sched, bad, golden, cfg)
    assert port and port == ref


def test_audit_oracle_hang_and_abort_plants_equal_the_reference(
        drilled, monkeypatch, tmp_path):
    cfg, golden, _, result = drilled
    cases = []
    # exactly_once_oracle: a quarantine-only schedule whose tap is off.
    burst = chaos.ScheduleGenerator().schedule(9)
    assert burst.scenario == "corrupt_burst"
    cases.append((burst, _copy_result(result, tmp_path / "o",
                                      counters={}, cursor=None)))
    # hang_detection / abort_detection: the verdict with no journal event.
    for seed in (19, 0):
        sched = chaos.ScheduleGenerator().schedule(seed)
        assert sched.expects in ("hang_detected", "ingest_aborted")
        cases.append((sched, _copy_result(
            result, tmp_path / sched.scenario, outcome=sched.expects,
            cursor=None, counters={})))
    for sched, res in cases:
        port, ref = _both(monkeypatch, sched, res, golden, cfg)
        assert port and port == ref


def test_audit_journal_and_chain_plants_equal_the_reference(
        drilled, monkeypatch, tmp_path):
    cfg, golden, sched, result = drilled
    # journal_monotonic: an unparseable line and a timestamp going back.
    res = _copy_result(result, tmp_path)
    with open(res.health_path, "a") as f:
        f.write("{torn\n")
        f.write('{"event": "late", "ts": 1.0}\n')
    port, ref = _both(monkeypatch, sched, res, golden, cfg)
    assert {v["invariant"] for v in port} == {"journal_monotonic"}
    assert len(port) == 2 and port == ref
    # chain_integrity: every step's bytes corrupt (the golden chain's,
    # all manifested: the drilled chain keeps its first step, torn
    # before any manifest existed, which a walk-back trusts), so the
    # walk-back fails.
    import shutil

    ck = str(tmp_path / "ck")
    shutil.copytree(golden.ckpt_dir, ck)
    for step in os.listdir(ck):
        if step.isdigit():
            path = os.path.join(ck, step, "v.npy")
            with open(path, "r+b") as f:
                f.seek(-4, 2)
                f.write(b"\x01\x02\x03\x04")
    res = _copy_result(result, tmp_path / "c", ckpt_dir=ck)
    port, ref = _both(monkeypatch, sched, res, golden, cfg)
    assert [v["invariant"] for v in port] == ["chain_integrity"]
    assert port == ref


# ------------------------------------------------- the port vs reference


def test_drilled_tap_equals_the_reference_drilled_tap(tmp_path):
    """Seed 3 (a recovery storm: two consecutive losses and a probe
    fault) through both packages: the same admitted record stream, the
    same cursor and quarantine counters (the record ids do not depend
    on the numerics), both audited green against their own golden."""
    sched = chaos.ScheduleGenerator().schedule(3)
    assert sched.scenario == "recovery_storm" and sched.stream_comparable
    port = chaos.run_schedule(sched, chaos.DrillConfig(),
                              str(tmp_path / "p"), device=CPU)
    jsched = jchaos.ScheduleGenerator().schedule(3)
    ref = jchaos.run_schedule(jsched, jchaos.DrillConfig(),
                              str(tmp_path / "j"))
    assert port.outcome == ref.outcome == "completed"
    assert port.tap == ref.tap and len(port.tap) == 18
    assert port.cursor == ref.cursor and port.counters == ref.counters
    assert port.steps_done == ref.steps_done
    assert sorted(port.params_sums) == sorted(ref.params_sums)
    kinds = [e["event"] for e in read_events(port.health_path)]
    jkinds = [e["event"] for e in read_events(ref.health_path)]
    assert kinds.count("failure") == jkinds.count("failure") == 2


# ------------------------------------------------- tier-1 bounded soak


def test_tier1_chaos_soak_25_schedules_all_invariants_green(tmp_path):
    """The bounded tier-1 soak: 25 seeded multi-fault schedules on the
    port inside the reference's budget, every invariant green, each seed
    with the reference's scenario and outcome (the reference's soak is
    all green, so its outcome is each schedule's ``expects``)."""
    verdict = chaos.run_campaign(
        SOAK_SEEDS, base_dir=str(tmp_path), time_budget_s=SOAK_BUDGET_S,
        per_schedule_timeout_s=SOAK_PER_SCHEDULE_S,
        minimize_failures=False, device=CPU)
    failing = [(e["seed"], e["scenario"], e["plan"], e["violations"])
               for e in verdict["schedules"] if e["verdict"] != "green"]
    assert verdict["n_schedules"] == 25
    assert not verdict["budget_exhausted"], verdict["total_s"]
    assert verdict["all_green"], failing
    ref = jchaos.ScheduleGenerator().sample(SOAK_SEEDS)
    assert [(e["seed"], e["scenario"], e["plan"], e["outcome"])
            for e in verdict["schedules"]] == [
        (s.seed, s.scenario, s.plan, s.expects) for s in ref]
    assert {"completed", "hang_detected", "ingest_aborted"} <= {
        e["outcome"] for e in verdict["schedules"]}
    assert set(verdict) == {
        "engine", "seeds", "config", "n_schedules", "n_green", "n_failed",
        "n_skipped", "all_green", "budget_s", "budget_exhausted",
        "total_s", "schedules", "failures"}


def test_canary_broken_recovery_is_caught_and_minimized(tmp_path):
    cfg = dataclasses.replace(chaos.DrillConfig(), break_restore=True)
    sched = chaos.ScheduleGenerator(cfg).schedule(3)
    assert sched.scenario == "recovery_storm" and len(sched.rules) >= 2
    verdict = chaos.run_campaign([3], cfg=cfg, base_dir=str(tmp_path),
                                 minimize_failures=True, device=CPU)
    assert not verdict["all_green"]
    (failure,) = verdict["failures"]
    violated = {v["invariant"] for v in failure["violations"]}
    assert {"exactly_once_stream", "loss_continuity"} <= violated
    assert failure["minimized_rules"] <= 2
    minimized = failure["minimized_plan"]
    assert minimized and "device_loss" in minimized
    faults.FaultPlan.from_spec(minimized)


def test_campaign_budget_exhaustion_is_loud(tmp_path):
    verdict = chaos.run_campaign([1, 2, 3], base_dir=str(tmp_path),
                                 time_budget_s=0.0,
                                 minimize_failures=False, device=CPU)
    assert verdict["n_skipped"] == 3
    assert verdict["budget_exhausted"]
    assert not verdict["all_green"]


def test_a_commit_window_loss_found_during_recovery_is_recovered(tmp_path):
    """The port's save writes in the background, so seed 1's commit-
    window loss at step 6 surfaces while the trainer recovers from the
    step-9 loss: the recovery joins the writer, recovers from its loss
    too (two failures journaled), and ends where the clean run does."""
    cfg = chaos.DrillConfig()
    golden = chaos.golden_run(cfg, str(tmp_path / "g"), device=CPU)
    sched = chaos.Schedule(1, "commit_loss", (
        "ckpt_commit@1=device_loss", "train_step@9=device_loss"))
    r = chaos.run_schedule(sched, cfg, str(tmp_path / "r"), device=CPU)
    assert r.outcome == "completed", r.error
    assert chaos.audit(sched, r, golden, cfg) == []
    kinds = [e["event"] for e in read_events(r.health_path)]
    assert kinds.count("failure") == 2


# -------------------------------- cross-path recovery (compound faults)


@pytest.mark.parametrize("first_native", [True, False])
def test_cross_path_recovery_under_compound_faults(tmp_path, first_native):
    """A run surviving an ``ingest_truncate`` device loss and a mid-step
    loss on one ingest path checkpoints, then resumes on the OTHER path
    (native <-> Python): the combined stream, loss curve and final
    params are the clean run's bit for bit."""
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.data.native_stream import (
        make_stream_batches, native_stream_supported)
    from fm_spark_tpu_torch.data.stream import RecordGuard, ShardReader
    from fm_spark_tpu_torch.resilience.supervisor import (BackoffPolicy,
                                                          Supervisor)
    from fm_spark_tpu_torch.train import FMTrainer, TrainConfig

    assert native_stream_supported("libsvm", 3)
    cfg = chaos.DrillConfig()
    shards = chaos.build_shards(str(tmp_path / "shards"), cfg)
    golden = chaos.golden_run(cfg, str(tmp_path / "golden"),
                              shard_paths=shards, device=CPU)
    spec = models.FMSpec(num_features=cfg.num_features, rank=cfg.rank,
                         init_std=0.05)
    ck_dir = str(tmp_path / "ck")

    def leg(native: bool, steps: int, plan: str):
        guard = RecordGuard("quarantine",
                            quarantine_dir=str(tmp_path / f"q{int(native)}"))
        source = chaos._TapSource(make_stream_batches(
            ShardReader(shards, chunk_bytes=cfg.chunk_bytes), "libsvm",
            cfg.batch_size, cfg.max_nnz, guard=guard,
            num_features=cfg.num_features, native_ingest=bool(native)))
        config = TrainConfig(num_steps=steps, batch_size=cfg.batch_size,
                             learning_rate=cfg.learning_rate,
                             lr_schedule="constant", log_every=1,
                             seed=cfg.seed)
        ck = Checkpointer(ck_dir, save_every=cfg.save_every)
        sup = Supervisor(policy=BackoffPolicy(initial=0.01, jitter=0.0),
                         probe=lambda: True, breaker_threshold=8,
                         sleep=lambda s: None)
        trainer = FMTrainer(spec, config, device=CPU)
        trainer.logger._stream = None
        faults.clear()
        if plan:
            faults.activate(plan)
        try:
            trainer.fit(source, checkpointer=ck, supervisor=sup)
        finally:
            faults.clear()
            ck.close()
        return trainer, source

    t1, s1 = leg(first_native, 12, "ingest_truncate@3=device_loss;"
                 "train_step@7=device_loss")
    assert t1.step_count == 12
    t2, s2 = leg(not first_native, cfg.steps, "")
    assert t2.step_count == cfg.steps
    assert s1.lines[:12] + s2.lines == golden.tap
    assert t2.loss_history == golden.loss_history
    assert chaos._params_sums(t2.params) == golden.params_sums
    final = {k: v for k, v in s2.state().items() if k != "tap_len"}
    want = {k: v for k, v in golden.cursor.items() if k != "tap_len"}
    assert final == want


# ------------------- SIGKILL during flight-spool compaction (subprocess)


def test_sigkill_during_spool_compaction_is_exactly_once(tmp_path):
    """The engine SIGKILLs the worker (a CPU subprocess) mid-run with the
    flight ring sized so its spool is compacting, respawns it, and the
    stitched stream, losses and final params are the clean run's; the
    spool survives the kill with a monotonic, duplicate-free, compacted
    seq; the chain restores through last_good. The kill lands after
    step 13's loss line (the reference's lands after step 9): the port's
    save writes in the background and is joined by the next save, so
    step 6 is committed by step 13 and the respawn resumes from a step,
    not from scratch, whatever the host's speed."""
    from fm_spark_tpu_torch.obs import read_spool

    cfg = chaos.DrillConfig(flight_capacity=4)
    golden = chaos.golden_run(cfg, str(tmp_path / "golden"), device=CPU)
    result = chaos.run_schedule_subproc("", cfg, str(tmp_path / "kill"),
                                        kill_at_step=13, device=CPU)
    assert result.outcome == "completed", (result.error, result.rcs)
    assert result.rcs[0] == -signal.SIGKILL
    assert result.rcs[-1] == 0
    assert result.resumed_at[0] == 0 and result.resumed_at[1] in (6, 12)
    assert chaos.stitch_taps(result) == golden.tap
    assert result.loss_history == golden.loss_history
    assert result.params_sums == golden.params_sums
    spool = read_spool(os.path.join(str(tmp_path / "kill"), "obs",
                                    "flight.jsonl"))
    seqs = [e["seq"] for e in spool]
    assert seqs and seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    assert len(seqs) <= 2 * cfg.flight_capacity
    assert max(seqs) >= len(seqs)
    assert chaos._audit_chain(result, cfg) == []


def test_stitch_taps_equals_the_reference():
    texts = ["0:1,2\n1:3,4\n2:5", "1:3,4\n2:5,6\n3:7,8\n4:9"]
    r = chaos.DrillResult("completed", None, 0, [], None, texts, None, {},
                          0.0, "", "", "", "")
    jr = jchaos.DrillResult(**dataclasses.asdict(r))
    assert chaos.stitch_taps(r) == jchaos.stitch_taps(jr)
    bad = dataclasses.replace(r, tap=["0:1\n2:3"])
    with pytest.raises(ValueError, match="contiguous"):
        chaos.stitch_taps(bad)


# ------------------------------------------------------------- devices


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_every_training_runner_raises_without_a_card(tmp_path):
    cfg = chaos.DrillConfig()
    sched = chaos.ScheduleGenerator().schedule(1)
    for call in (
            lambda: chaos.run_schedule(sched, cfg, str(tmp_path / "a")),
            lambda: chaos.golden_run(cfg, str(tmp_path / "b")),
            lambda: chaos.run_campaign([1], base_dir=str(tmp_path / "c")),
            lambda: chaos.run_schedule_subproc("", cfg,
                                               str(tmp_path / "d"))):
        with pytest.raises(DeviceUnavailable):
            call()
    assert not os.path.exists(tmp_path / "d" / "chaos_worker.py")


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_the_worker_asked_for_the_card_raises_device_unavailable(tmp_path):
    """The worker resolves its device in the init window: asked for the
    card where there is none, it exits with DeviceUnavailable, having
    trained nothing."""
    cfg = chaos.DrillConfig()
    chaos.build_shards(str(tmp_path / "shards"), cfg)
    worker = chaos.write_worker(str(tmp_path))
    env = dict(os.environ, FM_SPARK_OBS_DIR="none", PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, worker, str(tmp_path), "18", "16", "6", "256",
         "1.0", "7", "0", "cuda"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "DeviceUnavailable" in proc.stderr
    assert not os.path.exists(tmp_path / "tap_0.txt")
