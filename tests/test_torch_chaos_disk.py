"""The port's chaos campaign, storage half and drill runner
(``fm_spark_tpu_torch/resilience/chaos.py``, ``chaos_audit.py`` and
``fm_spark_tpu_torch/tools/chaos_drill.py``), held against the JAX
package's on the CPU:

- the disk generator gives the reference's schedules seed for seed
  (0–199), and the disk drill's golden params the reference's crc32s
  (both step the same numpy arrays);
- :func:`chaos.audit_disk` returns the reference's violations, clean
  and with one planted violation per invariant;
- the acceptance drills of ``tests/test_iofaults.py``: the obs-degraded
  run byte-identical to golden, the tier-1 disk campaign green, the
  SIGKILL-during-emergency-GC drill;
- the drill runner writes its verdict (``<obs_root>/<run_id>/
  chaos_verdict.json``), proves the canary, keeps the reference's
  constants and rendering, and without a card raises DeviceUnavailable
  unless run with ``--device cpu``;
- ``chaos_audit`` loads by path without importing the package or torch.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from fm_spark_tpu.resilience import chaos as jchaos
from fm_spark_tpu_torch import DeviceUnavailable, obs
from fm_spark_tpu_torch.resilience import chaos, faults
from fm_spark_tpu_torch.tools import chaos_drill
from fm_spark_tpu_torch.utils import sleeps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = "cpu"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv(faults.ENV_PLAN, raising=False)
    monkeypatch.delenv(faults.ENV_STATE, raising=False)
    faults.clear()
    yield
    faults.clear()


def _reference_tool():
    spec = importlib.util.spec_from_file_location(
        "reference_chaos_drill", os.path.join(REPO, "tools",
                                              "chaos_drill.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ------------------------------------------------------------ generator


def test_disk_schedules_equal_the_reference():
    assert ([dataclasses.asdict(chaos.disk_schedule(s)) for s in range(200)]
            == [dataclasses.asdict(jchaos.disk_schedule(s))
                for s in range(200)])
    assert {chaos.disk_schedule(s).scenario for s in range(5)} == set(
        chaos._DISK_SCENARIOS)
    assert chaos.DISK_TIER1_SEEDS == jchaos.DISK_TIER1_SEEDS


# ---------------------------------------------------------------- audit


DISK_CASES = {
    "clean": dict(committed_steps=[1, 2, 3], tombstoned_steps=[3],
                  last_good_step=2, restored_step=2,
                  expected_surviving={1, 2},
                  io_failures={"best_effort": 2}, degraded_gauge=1.0,
                  params_match=True, spool_seqs=[1, 2, 5]),
    "last_good_missing": dict(committed_steps=[1, 2]),
    "last_good_tombstoned": dict(committed_steps=[1, 2],
                                 tombstoned_steps=[2], last_good_step=2),
    "last_good_uncommitted": dict(committed_steps=[1, 2], last_good_step=3),
    "chain_broken_behind": dict(committed_steps=[1, 2], last_good_step=2,
                                restored_step=1),
    "chain_broken_nothing_good": dict(committed_steps=[2],
                                      tombstoned_steps=[2],
                                      restored_step=2),
    "demotion_wrongly": dict(committed_steps=[1, 2], tombstoned_steps=[2],
                             last_good_step=1, expected_surviving={1, 2}),
    "demotion_standing": dict(committed_steps=[1, 2, 3], last_good_step=3,
                              expected_surviving={1}),
    "degradation_silent": dict(io_failures={"best_effort": 3},
                               degraded_gauge=0.0),
    "obs_leaked": dict(params_match=False),
    "spool_regressed": dict(spool_seqs=[1, 4, 4, 6]),
}


@pytest.mark.parametrize("case", sorted(DISK_CASES))
def test_audit_disk_equals_the_reference(case):
    kw = DISK_CASES[case]
    port = chaos.audit_disk(**kw)
    assert port == jchaos.audit_disk(**kw)
    assert (port == []) == (case == "clean")


# ------------------------------------------------------ acceptance drills


def test_obs_degraded_run_is_byte_identical_to_golden(tmp_path,
                                                      monkeypatch):
    """With every ``io_write.obs`` failing, the final params are the
    golden run's byte for byte (and the reference's: both step the same
    numpy arrays), the failures are counted and the degradation gauge is
    raised."""
    monkeypatch.setenv(sleeps.ENV, "0.0")
    golden = chaos.run_disk_schedule(
        chaos.DiskSchedule(-1, "golden", (), setup_saves=4, final_saves=0),
        str(tmp_path / "golden"), device=CPU)
    assert golden["verdict"] == "green", golden["violations"]
    ref = jchaos.run_disk_schedule(
        jchaos.DiskSchedule(-1, "golden", (), setup_saves=4,
                            final_saves=0), str(tmp_path / "ref"))
    assert golden["params_sums"] == ref["params_sums"]
    assert set(golden) == set(ref)
    sched = chaos.DiskSchedule(
        -2, "readonly_obs_flip", ("io_write.obs@1-512=eio",),
        setup_saves=4, final_saves=0, arm_at_start=True)
    entry = chaos.run_disk_schedule(sched, str(tmp_path / "degraded"),
                                    golden_sums=golden["params_sums"],
                                    device=CPU)
    assert entry["verdict"] == "green", entry["violations"]
    assert entry["params_sums"] == golden["params_sums"]
    assert entry["io_failures"]["obs"] > 0
    assert entry["io_failures"]["best_effort"] > 0
    assert obs.registry().snapshot()["gauges"].get("obs/io_degraded") == 1.0


def test_disk_campaign_tier1_seeds_green(tmp_path, monkeypatch):
    """Golden and every tier-1 disk seed (ENOSPC mid-commit over demoted
    generations, a torn tombstone rename racing a follower, fsync stalls,
    an EIO burst on spool compaction, a read-only obs plane), each graded
    green by ``audit_disk`` from artifacts alone."""
    monkeypatch.setenv(sleeps.ENV, "0.25")
    entries = chaos.run_disk_campaign(base_dir=str(tmp_path),
                                      include_kill_drill=False, device=CPU)
    assert [e["scenario"] for e in entries[:1]] == ["golden"]
    assert [e["seed"] for e in entries[1:]] == list(chaos.DISK_TIER1_SEEDS)
    for e in entries:
        assert e["verdict"] == "green", (e["scenario"], e["violations"])
        assert e["outcome"] == e["expects"]
    assert {"enospc_ckpt_commit", "torn_rename_demote"} <= {
        e["scenario"] for e in entries[1:]}
    torn = next(e for e in entries if e["scenario"] == "torn_rename_demote")
    assert torn["follower_samples"]
    enospc = next(e for e in entries
                  if e["scenario"] == "enospc_ckpt_commit")
    assert enospc["emergency_gcs"] >= 1


def test_gc_kill_drill_recovers_to_loadable_last_good(tmp_path):
    res = chaos.run_gc_kill_drill(str(tmp_path / "gc"), exit_rc=29)
    assert res["rcs"] == [29, 0]
    assert res["violations"] == [], res["violations"]


# ---------------------------------------------------------- drill runner


def test_drill_runner_keeps_the_reference_contract():
    ref = _reference_tool()
    assert (chaos_drill.TIER1_SEEDS, chaos_drill.TIER1_BUDGET_S,
            chaos_drill.TIER1_PER_SCHEDULE_S, chaos_drill.VERDICT_FILE) == (
        ref.TIER1_SEEDS, ref.TIER1_BUDGET_S, ref.TIER1_PER_SCHEDULE_S,
        ref.VERDICT_FILE)
    verdict = {"run_id": "r", "n_schedules": 2, "n_green": 1,
               "n_failed": 1, "n_skipped": 0, "total_s": 1.5,
               "budget_s": 300.0, "all_green": False, "schedules": [
                   {"seed": 3, "scenario": "recovery_storm",
                    "outcome": "completed", "plan": "train_step@3=x",
                    "verdict": "failed", "minimized_plan": "a",
                    "violations": [{"invariant": "i", "detail": "d"}]},
                   {"seed": 4, "scenario": "hang", "outcome": "hang",
                    "plan": "p", "verdict": "green", "violations": []}]}
    assert chaos_drill.render(verdict) == ref.render(verdict)


def test_drill_runner_writes_verdict_and_exits_green(tmp_path, capsys):
    rc = chaos_drill.main(["--schedules", "2", "--no-minimize",
                           "--work-dir", str(tmp_path / "work"),
                           "--out", str(tmp_path / "obs"),
                           "--device", CPU])
    assert rc == 0
    assert "ALL GREEN" in capsys.readouterr().out
    run_dirs = os.listdir(tmp_path / "obs")
    assert len(run_dirs) == 1
    with open(tmp_path / "obs" / run_dirs[0] / "chaos_verdict.json") as f:
        verdict = json.load(f)
    assert verdict["n_schedules"] == 2 and verdict["all_green"]
    assert verdict["run_id"] == run_dirs[0]
    assert verdict["mode"] == "bounded"
    for e in verdict["schedules"]:
        assert e["plan"] and isinstance(e["seed"], int)


def test_drill_runner_canary_is_caught(tmp_path, capsys):
    rc = chaos_drill.main(["--canary", "--seeds", "3",
                           "--work-dir", str(tmp_path / "work"),
                           "--out", str(tmp_path / "obs"),
                           "--device", CPU])
    assert rc == 0
    out = capsys.readouterr().out
    assert "canary CAUGHT and minimized" in out
    assert "device_loss" in out.splitlines()[-1]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_drill_runner_and_campaigns_raise_without_a_card(tmp_path):
    with pytest.raises(DeviceUnavailable):
        chaos_drill.main(["--schedules", "1", "--out", str(tmp_path)])
    assert not os.listdir(tmp_path)
    for call in (
            lambda: chaos.run_drift_campaign(base_dir=str(tmp_path / "a")),
            lambda: chaos.run_fleet_campaign(base_dir=str(tmp_path / "b")),
            lambda: chaos.run_partition_campaign(
                base_dir=str(tmp_path / "c")),
            lambda: chaos.run_disk_campaign(base_dir=str(tmp_path / "d")),
            lambda: chaos.run_disk_schedule(chaos.disk_schedule(0),
                                            str(tmp_path / "e"))):
        with pytest.raises(DeviceUnavailable):
            call()


def test_chaos_audit_loads_by_path_without_the_package():
    path = os.path.join(REPO, "fm_spark_tpu_torch", "resilience",
                        "chaos_audit.py")
    code = (
        "import importlib.util, sys\n"
        f"spec = importlib.util.spec_from_file_location('ca', {path!r})\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(mod)\n"
        "assert mod.audit_disk(committed_steps=[1], last_good_step=1) == []\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('torch', 'numpy', 'jax', 'fm_spark_tpu', 'fm_spark_tpu_torch'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)
    assert proc.returncode == 0, proc.stdout + proc.stderr
