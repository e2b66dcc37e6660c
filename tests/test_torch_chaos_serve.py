"""The port's chaos campaign, serving half (``fm_spark_tpu_torch/
resilience/chaos.py`` and ``chaos_audit.py``), held against the JAX
package's on the CPU:

- the serve, drift, fleet and partition generators give the
  reference's schedules seed for seed (0–199), and the drift drill's
  day shards are the reference's byte for byte;
- :func:`chaos.audit_serve_events`, :func:`chaos.audit_fleet` and
  :func:`chaos.audit_drift` return the reference's violations on the
  same artifacts (the drift auditors both read the port's chain),
  clean and with one planted violation per invariant;
- the acceptance drills of ``tests/test_serve.py``, ``test_chaos.py``,
  ``test_fleet.py``, ``test_netfaults.py`` and
  ``test_checkpoint_chain.py``: the seeded serving drill campaign over
  the port's engine, follower and chain, the drift campaign, the
  SIGKILL-mid-demotion drill, the fleet campaign and the partition
  campaign (replica processes on the CPU), each green.
"""

import dataclasses
import os
import time

import numpy as np
import pytest
import torch

from fm_spark_tpu import checkpoint as jcheckpoint
from fm_spark_tpu.resilience import chaos as jchaos
from fm_spark_tpu_torch import models, obs
from fm_spark_tpu_torch import checkpoint as pcheckpoint
from fm_spark_tpu_torch.checkpoint import Checkpointer
from fm_spark_tpu_torch.resilience import chaos, faults, watchdog
from fm_spark_tpu_torch.serve import PredictEngine, ReloadFollower
from fm_spark_tpu_torch.utils.logging import EventLog, read_events

CPU = "cpu"
SEEDS = range(200)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    monkeypatch.delenv(faults.ENV_STATE, raising=False)
    monkeypatch.delenv(watchdog.ENV_SPEC, raising=False)
    faults.clear()
    watchdog.clear()
    yield
    faults.clear()
    watchdog.clear()


# ------------------------------------------------------------ generators


def test_serve_and_drift_schedules_equal_the_reference():
    for make, jmake in ((chaos.serve_schedule, jchaos.serve_schedule),
                        (chaos.drift_schedule, jchaos.drift_schedule)):
        port = [dataclasses.asdict(make(s)) for s in SEEDS]
        assert port == [dataclasses.asdict(jmake(s)) for s in SEEDS]
    assert {chaos.serve_schedule(s).scenario for s in SEEDS} == {
        "serve_reload_fail", "serve_commit_fault", "serve_reload_storm",
        "serve_compound"}
    assert {chaos.drift_schedule(s).scenario
            for s in chaos.DRIFT_TIER1_SEEDS} == {
        "drift_clean_drift", "drift_eval_fault", "drift_commit_fault",
        "drift_demote_fault", "drift_rollback_corruption"}
    assert chaos.DRIFT_TIER1_SEEDS == jchaos.DRIFT_TIER1_SEEDS


@pytest.mark.parametrize("n_replicas", [2, 3])
def test_fleet_and_partition_schedules_equal_the_reference(n_replicas):
    assert ([dataclasses.asdict(chaos.fleet_schedule(s)) for s in SEEDS]
            == [dataclasses.asdict(jchaos.fleet_schedule(s))
                for s in SEEDS])
    assert ([dataclasses.asdict(chaos.partition_schedule(s, n_replicas))
             for s in SEEDS]
            == [dataclasses.asdict(jchaos.partition_schedule(s, n_replicas))
                for s in SEEDS])
    assert {chaos.fleet_schedule(s).scenario for s in range(5)} == {
        f"fleet_{s}" for s in chaos._FLEET_SCENARIOS}
    assert {chaos.partition_schedule(s).scenario for s in range(4)} == set(
        chaos._PARTITION_SCENARIOS)
    assert (chaos.FLEET_TIER1_SEEDS, chaos.FLEET_SOAK_SEEDS,
            chaos.PARTITION_TIER1_SEEDS) == (
        jchaos.FLEET_TIER1_SEEDS, jchaos.FLEET_SOAK_SEEDS,
        jchaos.PARTITION_TIER1_SEEDS)
    assert (dataclasses.asdict(jchaos.FleetDrillConfig())
            == {k: v for k, v in dataclasses.asdict(
                chaos.FleetDrillConfig()).items() if k != "param_dtype"})


def test_drift_days_equal_the_reference(tmp_path):
    _, a = chaos.build_drift_days(chaos.DriftDrillConfig(),
                                  str(tmp_path / "p"))
    _, b = jchaos.build_drift_days(jchaos.DriftDrillConfig(),
                                   str(tmp_path / "j"))
    assert [open(x).read() for x in a] == [open(x).read() for x in b]


# ---------------------------------------------------- serve/fleet audits


def _swap(step, gid, frm=None):
    return {"event": "serve_swap", "step": step, "gen_id": gid,
            "from_step": frm}


SERVE_CASES = {
    "clean": ([_swap(1, 1), _swap(2, 2, 1), _swap(2, 2, 1),
               {"kind": "serve_swap", "step": 3, "gen_id": 3,
                "from_step": 2},
               {"event": "reload_failed", "served_step": 3}],
              dict(final_staleness=0, rc=0)),
    "no_torn_swap_missing_step": ([{"event": "serve_swap", "gen_id": 1}],
                                  {}),
    "no_torn_swap_regressed": ([_swap(5, 1), _swap(4, 2, 5)], {}),
    "no_torn_swap_gen_jump": ([_swap(1, 1), _swap(2, 3, 1)], {}),
    "no_tombstoned_generation": ([_swap(1, 1), _swap(9, 2, 1)],
                                 dict(tombstoned_steps={9})),
    "degraded_journaled": ([{"event": "reload_failed", "error": "x"}], {}),
    "degraded_poll_loop": ([{"event": "reload_failed",
                             "error": "poll loop died"}], {}),
    "staleness_bounded": ([], dict(final_staleness=4, staleness_bound=1)),
    "rc_discipline": ([], dict(rc=1, allowed_rcs=(0, 87))),
}


@pytest.mark.parametrize("case", sorted(SERVE_CASES))
def test_audit_serve_events_equals_the_reference(case):
    events, kw = SERVE_CASES[case]
    port = chaos.audit_serve_events(events, **kw)
    assert port == jchaos.audit_serve_events(events, **kw)
    assert (port == []) == (case in ("clean", "degraded_poll_loop"))


def _attempt(rid, att, out, gen=1):
    return {"event": "attempt", "req_id": rid, "attempt": att,
            "outcome": out, "gen_step": gen}


_BOOKS = {"accepted": 3, "answered": 3, "timeout": 0, "failed": 0,
          "shed": 1, "shed_queue": 1, "shed_deadline": 0}
_TAP = [_attempt(0, 0, "ok"), _attempt(1, 0, "error"), _attempt(1, 1, "ok"),
        _attempt(2, 0, "shed"), _attempt(2, 1, "ok")]
_REPLICA = {0: [{"event": "replica_start"}, _swap(1, 1),
                {"event": "replica_state", "staleness_steps": 0},
                {"event": "replica_start"}, _swap(1, 1)]}
_PART = [{"event": "replica_suspect", "replica": 1},
         {"event": "replica_drained", "replica": 1},
         {"event": "replica_ready", "replica": 1},
         {"event": "autoscale_decision", "action": "grow"}]

FLEET_CASES = {
    "clean": (_TAP, _BOOKS, dict(expected_requests=3,
                                 replica_events=_REPLICA,
                                 fleet_events=_PART, partition_victim=1,
                                 max_autoscale_decisions=3)),
    "exactly_once_twice": (_TAP + [_attempt(0, 0, "ok")], _BOOKS, {}),
    "exactly_once_double_ok": (_TAP + [_attempt(0, 1, "ok")], _BOOKS, {}),
    "exactly_once_dropped": (_TAP, _BOOKS, dict(expected_requests=4)),
    "accepted_accounting": (_TAP, dict(_BOOKS, answered=2), {}),
    "shed_split": (_TAP, dict(_BOOKS, shed_queue=0), {}),
    "shed_observed": (_TAP, dict(_BOOKS, shed=2, shed_queue=2), {}),
    "no_tombstoned_generation": (_TAP, _BOOKS, dict(tombstoned_steps={1})),
    "replica_torn_swap": (_TAP, _BOOKS, dict(replica_events={
        0: [_swap(2, 1), _swap(1, 2, 2),
            {"event": "replica_state", "staleness_steps": 3}]})),
    "partition_never_drained": (_TAP, _BOOKS, dict(
        fleet_events=_PART[:1], partition_victim=1)),
    "partition_never_readmitted": (_TAP, _BOOKS, dict(
        fleet_events=_PART[:2], partition_victim=1)),
    "partition_respawned": (_TAP, _BOOKS, dict(fleet_events=[
        _PART[1], {"event": "replica_spawn", "replica": 1}, _PART[2]],
        partition_victim=1)),
    "autoscale_bound": (_TAP, _BOOKS, dict(fleet_events=_PART * 4,
                                           max_autoscale_decisions=3)),
    "autoscale_flapping": (_TAP, _BOOKS, dict(fleet_events=[
        {"event": "autoscale_decision", "action": a}
        for a in ("grow", "park", "grow")], max_autoscale_decisions=9)),
}


@pytest.mark.parametrize("case", sorted(FLEET_CASES))
def test_audit_fleet_equals_the_reference(case):
    tap, books, kw = FLEET_CASES[case]
    port = chaos.audit_fleet(tap, books, **kw)
    assert port == jchaos.audit_fleet(tap, books, **kw)
    assert (port == []) == (case == "clean")


# ------------------------------------------------------------ drift audit


class _PortFollower(pcheckpoint.ChainFollower):
    """The port's follower behind the reference's call shape, so the
    reference's ``audit_drift`` reads the port's chain."""

    def restore(self, params=None, opt_state=None):
        return super().restore(None)


@pytest.fixture(scope="module")
def drift_runs(tmp_path_factory):
    """The port's drift golden and seed 3 (a crash between the demotion's
    tombstone and its pointer republish), on the CPU."""
    base = tmp_path_factory.mktemp("drift")
    cfg = chaos.DriftDrillConfig()
    state = chaos.build_drift_days(cfg, str(base / "shards"))
    golden = chaos.run_drift_schedule(
        chaos.Schedule(seed=-1, scenario="drift_golden", rules=()), cfg,
        str(base / "golden"), shard_state=state, device=CPU)
    sched = chaos.drift_schedule(3)
    result = chaos.run_drift_schedule(sched, cfg, str(base / "d3"),
                                      shard_state=state, device=CPU)
    return cfg, golden, sched, result


def _drift_both(monkeypatch, sched, result, golden, cfg):
    port = chaos.audit_drift(sched, result, golden, cfg)
    monkeypatch.setattr(jcheckpoint, "ChainFollower", _PortFollower)
    ref = jchaos.audit_drift(
        jchaos.Schedule(**dataclasses.asdict(sched)),
        jchaos.DriftResult(**dataclasses.asdict(result)),
        jchaos.DriftResult(**dataclasses.asdict(golden)),
        jchaos.DriftDrillConfig(**dataclasses.asdict(cfg)))
    return port, ref


def _journal(tmp_path, events):
    os.makedirs(tmp_path, exist_ok=True)
    path = str(tmp_path / "health.jsonl")
    log = EventLog(path)
    for e in events:
        log.emit(e.pop("event"), **e)
    log.close()
    return path


def test_audit_drift_clean_equals_the_reference(drift_runs, monkeypatch):
    cfg, golden, sched, result = drift_runs
    assert result.outcome == "completed" and result.attempts == 2
    port, ref = _drift_both(monkeypatch, sched, result, golden, cfg)
    assert port == ref == []


def _drift_plants(result, tmp_path):
    taps = {d: list(v) for d, v in result.taps.items()}
    taps[2][0] = taps[2][1]
    summary = dict(result.summary)
    no_evals = _journal(tmp_path / "a", [{"event": "quality_eval",
                                          "eval_day": 1}])
    late = _journal(tmp_path / "b", [{"event": "online_rollback",
                                      "day": 1}])
    return {
        "completion": dict(outcome="circuit_open", error="x"),
        "eval_days": dict(health_path=no_evals,
                          summary=dict(summary, days=[])),
        "rollback_missing": dict(health_path=no_evals,
                                 summary=dict(summary, days=[],
                                              rollbacks=0)),
        "rollback_day": dict(health_path=late),
        "exactly_once_stream": dict(taps=taps),
        "state_identity": dict(params_sums={"['v']": "x"}),
        "last_good_missing": dict(last_good=None),
        "last_good_tombstoned": dict(last_good=result.tombstones[0]),
        "demoted_without_stone": dict(summary=dict(
            summary, demoted_steps=list(summary["demoted_steps"]) + [999])),
    }


@pytest.mark.parametrize("plant", [
    "completion", "eval_days", "rollback_missing", "rollback_day",
    "exactly_once_stream", "state_identity", "last_good_missing",
    "last_good_tombstoned", "demoted_without_stone"])
def test_audit_drift_planted_violation_equals_the_reference(
        drift_runs, monkeypatch, tmp_path, plant):
    cfg, golden, sched, result = drift_runs
    bad = dataclasses.replace(result,
                              **_drift_plants(result, tmp_path)[plant])
    port, ref = _drift_both(monkeypatch, sched, bad, golden, cfg)
    assert port and port == ref


def test_audit_drift_quarantine_plants_equal_the_reference(
        drift_runs, monkeypatch):
    cfg, golden, _, result = drift_runs
    sched = chaos.drift_schedule(4)
    assert sched.scenario == "drift_rollback_corruption"
    for counters in ({"ok": 10, "bad": 0}, {"ok": 10, "bad": 7}):
        bad = dataclasses.replace(result, counters=counters)
        port, ref = _drift_both(monkeypatch, sched, bad, golden, cfg)
        assert [v["invariant"] for v in port] == ["quarantine_accounting"]
        assert port == ref


# ------------------------------------------------------ acceptance drills


def test_tier1_drift_campaign_all_invariants_green(tmp_path):
    """The five seeded drift/rollback schedules through the port's
    online loop (label-flip drift, streaming day shards, FTRL, the
    crash-consistent chain) audited green: the sentry fires at the first
    drifted day, demotions are tombstoned, the per-day stream is exactly
    once and the final params the clean run's."""
    entries = chaos.run_drift_campaign(base_dir=str(tmp_path), device=CPU)
    failing = [(e["seed"], e["scenario"], e["violations"])
               for e in entries if e["verdict"] != "green"]
    assert len(entries) == 5
    assert not failing, failing
    assert all(e["rollbacks"] >= 1 for e in entries)
    assert all(e["demoted"] for e in entries)


def test_sigkill_mid_demotion_drill_recovers(tmp_path):
    """A subprocess demotes the chain's newest saves and exits inside
    the demotion window (tombstone durable, pointer stale): every reader
    lands on the pre-drift save and the re-run repairs the pointer."""
    res = chaos.run_demote_kill_drill(str(tmp_path), exit_rc=23)
    assert res["rcs"] == [23, 0]
    assert res["violations"] == [], res["violations"]


def _serve_params(spec, scale):
    p = spec.init(torch.Generator().manual_seed(0), device=CPU)
    return {"w0": p["w0"] * scale, "vw": [t * scale for t in p["vw"]]}


def test_seeded_serve_drill_campaign_green(tmp_path):
    """Seeded serving schedules (commit faults, reload faults) against
    the port's engine, follower and chain: every response under load is
    generation-uniform and the run ends green under
    :func:`chaos.audit_serve_events` — converged, no torn swap."""
    spec = models.FieldFMSpec(num_features=4 * 64, rank=4, num_fields=4,
                              bucket=64, init_std=0.1)
    rng = np.random.default_rng(0)
    ids = np.repeat(rng.integers(0, 64, (1, 4)).astype(np.int32), 4, 0)
    vals = np.ones((4, 4), np.float32)
    for seed in (1, 2, 5, 9):
        sched = chaos.serve_schedule(seed)
        work = tmp_path / f"s{seed}"
        work.mkdir()
        journal_path = str(work / "serve_health.jsonl")
        ck = Checkpointer(str(work / "chain"), save_every=1)
        ck.save(1, _serve_params(spec, 2.0), {}, None, force=True)
        ck.wait()
        journal = EventLog(journal_path)
        eng = PredictEngine(spec, _serve_params(spec, 1.0), buckets=(4,),
                            latency_budget_ms=0.0, device=CPU,
                            journal=journal)
        eng.warmup()
        fol = ReloadFollower(eng, str(work / "chain"), poll_s=0.01,
                             journal=journal)
        torn = 0
        try:
            assert fol.poll_once() == "swapped"
            faults.activate(sched.plan)
            for k in range(2, 5):          # the trainer keeps publishing
                try:
                    ck.save(k, _serve_params(spec, float(k + 1)), {},
                            None, force=True)
                    ck.wait()
                except faults.FaultInjected:
                    pass            # the trainer's problem; serving rides on
                for _ in range(3):
                    out = np.asarray(eng.predict(ids, vals))
                    torn += int(not np.all(out == out[0]))
                fol.poll_once()
            faults.clear()
            ck.save(6, _serve_params(spec, 9.0), {}, None, force=True)
            ck.wait()
            deadline = time.monotonic() + 10
            while (fol.poll_once() != "fresh"
                   and time.monotonic() < deadline):
                time.sleep(0.01)
        finally:
            faults.clear()
            fol.stop()
            eng.close()
            ck.close()
            journal.close()
        assert torn == 0, f"seed {seed}: mixed-generation response"
        staleness = int(obs.registry().gauge(
            "serve/staleness_steps").value or 0)
        events = read_events(journal_path)
        assert any(e["event"] == "serve_swap" for e in events)
        assert chaos.audit_serve_events(events, final_staleness=staleness,
                                        staleness_bound=0, rc=0) == []
        assert eng.generation().step == 6


def test_fleet_chaos_campaign_green(tmp_path):
    """The three tier-1 fleet schedules (kill mid-flash-crowd, retry
    storm + demote race, slow clients) against one shared two-replica
    fleet of CPU processes: completed and audited green, with a measured
    recovery for the kill and the demoted step never served."""
    entries = chaos.run_fleet_campaign(base_dir=str(tmp_path), device=CPU)
    assert [e["seed"] for e in entries] == list(chaos.FLEET_TIER1_SEEDS)
    for e in entries:
        assert e["outcome"] == "completed"
        assert e["verdict"] == "green", e["violations"]
        assert e["traffic"]["requests"] > 0
    kill, storm = entries[0], entries[1]
    assert kill["scenario"] == "fleet_kill_flash_crowd"
    assert kill["killed_replica"] is not None
    assert kill["recovery_s"] is not None and kill["recovery_s"] > 0
    assert storm["scenario"] == "fleet_retry_storm_demote"
    assert storm["demoted_step"] is not None
    assert set(kill) == {
        "seed", "scenario", "plan", "expects", "outcome", "verdict",
        "violations", "duration_s", "traffic", "killed_replica",
        "demoted_step", "recovery_s", "counters"}


def test_partition_campaign_all_tier1_seeds_green(tmp_path):
    """The partition half (autoscaler armed): seed 0 severs one
    replica's link as a flash crowd lands — drained, readmitted, never
    respawned; seed 1 publishes through a slow link; seed 2 truncates
    responses under a retry storm. Every entry green."""
    entries = chaos.run_partition_campaign(base_dir=str(tmp_path),
                                           device=CPU)
    assert [e["seed"] for e in entries] == list(chaos.PARTITION_TIER1_SEEDS)
    for e in entries:
        assert e["outcome"] == "completed"
        assert e["verdict"] == "green", (e["seed"], e["violations"])
        assert e["traffic"]["requests"] > 0
    flash = entries[0]
    assert flash["scenario"] == "partition_flash_crowd"
    assert flash["victim"] == chaos.partition_schedule(0).victim
    assert flash["healed_s"] is not None
    assert entries[1]["published_step"] is not None
    events = read_events(str(tmp_path / "fleet_health.jsonl"))
    vic = [e["event"] for e in events
           if e.get("replica") == flash["victim"] and "event" in e]
    assert "replica_drained" in vic
    assert "replica_ready" in vic[vic.index("replica_drained"):]
    assert "replica_down" not in vic
