"""Elastic degraded mode: the port's ``resilience/elastic.py`` against the
reference's, and ``fmtorch train --elastic``'s parent over gloo gangs.

- ``normalize_failure``/``classify_failures`` give the reference's
  verdicts, and ``ElasticController`` its shrink sequences, journal
  events, summaries and exhaustion messages.
- The elastic parent (the port's coordinated re-initialize: it launches
  the ranks of a ``--distributed`` gang and relaunches them) on a gloo
  gang of 4 with a permanent injected device loss shrinks 4 → 2 → 1,
  journals the reference's events and ends on a chain that evaluates;
  losses separated by checkpointed progress never shrink it; a rank
  that hangs after its peer failed is killed after the grace; a program
  error propagates.
- The reference's guards of ``--elastic``, one case each, and the
  port's refusal of a gang the user launched.
"""

import json
import os

import pytest

from fm_spark_tpu.resilience import elastic as jel
from fm_spark_tpu_torch import cli
from fm_spark_tpu_torch.parallel import gang
from fm_spark_tpu_torch.resilience import elastic as pel
from fm_spark_tpu_torch.utils.logging import read_events

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Journal:
    def __init__(self):
        self.records = []

    def emit(self, event, **fields):
        self.records.append({"event": event, **fields})


@pytest.mark.parametrize("desc", [
    "HangDetected: phase 'step_window' overran its 126s deadline",
    "child exited rc=3 within 125.5s", "rc=1 at step 12 of 40",
    "InjectedDeviceLoss: device lost (injected fault at train_step#13)"])
def test_normalize_failure_matches_the_reference(desc):
    assert pel.normalize_failure(desc) == jel.normalize_failure(desc)


@pytest.mark.parametrize("failures,threshold", [
    (["a 1", "a 2", "a 3"], 3), (["a 1", "b 2", "a 3"], 3),
    (["rc=1", "rc=3", "rc=3"], 2), (["x"], 1), ([], 3),
    (["rc=3 in 1s", "rc=3 in 2s", "rc=3 in 3s", "rc=3 in 4s"], 3)])
def test_classify_failures_matches_the_reference(failures, threshold):
    assert pel.classify_failures(failures, threshold) == \
        jel.classify_failures(failures, threshold)


@pytest.mark.parametrize("n,max_shrinks,min_devices", [
    (8, 3, 1), (8, 2, 1), (5, 3, 2), (1, 3, 1), (4, 0, 1)])
def test_shrink_sequences_and_journal_match_the_reference(n, max_shrinks,
                                                          min_devices):
    out = []
    for mod in (jel, pel):
        journal = _Journal()
        c = mod.ElasticController(devices=list(range(n)),
                                  max_shrinks=max_shrinks,
                                  min_devices=min_devices, journal=journal)
        seq = []
        for i in range(6):
            verdicts = [c.note_failure("train", RuntimeError(
                f"device lost #{i}.{k}")) for k in range(3)]
            try:
                seq.append((verdicts, c.shrink("train")))
            except mod.ElasticExhausted as e:
                seq.append((verdicts, str(e)))
                break
        c.note_success()
        out.append((seq, journal.records, c.summary(), c.can_shrink()))
    assert out[1] == out[0]


# ------------------------------------------------------- the elastic parent

_TRAIN = ["train", "--config", "criteo1tb_fm_r64", "--bucket", "16",
          "--synthetic", "1200", "--batch-size", "128", "--test-fraction",
          "0", "--sparse-update", "dedup", "--compact-device",
          "--compact-cap", "64", "--compact-overflow", "drop", "--device",
          "cpu", "--obs-dir", "none", "--checkpoint-every", "2",
          "--prefetch", "0", "--log-every", "1"]


@pytest.fixture
def gang_env(monkeypatch, tmp_path):
    """The ranks' environment: the repo importable, one thread each, no
    designed sleeps, the fault counters shared by every rank and launch."""
    monkeypatch.setenv("PYTHONPATH", REPO)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    monkeypatch.setenv("FM_SPARK_TEST_SLEEP_SCALE", "0")
    monkeypatch.setenv("FM_SPARK_FAULTS_STATE", str(tmp_path / "fs.json"))
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    from fm_spark_tpu_torch.resilience import faults

    faults.clear()
    yield monkeypatch
    faults.clear()


def _events(ck):
    return read_events(os.path.join(ck, "health.jsonl"))


def test_gloo_gang_shrinks_4_2_1_and_its_chain_evaluates(tmp_path, gang_env,
                                                         capsys):
    """Steps 1-3 on 4 ranks (occurrences 1-12 of ``train_step``), then
    every rank of the next six launches loses its device (occurrences
    13-30): three identical losses at 4 ranks, a shrink to 2, three at 2,
    a shrink to 1, and the last launch resumes step 2's canonical chain
    and finishes. The chain evaluates, and the journal holds the
    reference's events."""
    gang_env.setenv("FM_SPARK_FAULTS", "train_step@13-30=device_loss")
    ck = str(tmp_path / "ck")
    assert cli.main(_TRAIN + ["--steps", "8", "--checkpoint-dir", ck,
                              "--elastic", "--num-processes", "4",
                              "--max-shrinks", "2"]) == 0
    out, err = capsys.readouterr()
    summary = json.loads(err.strip().splitlines()[-1])
    assert summary["elastic"] == {"degraded": True, "chips": 1,
                                  "shrinks": 2}
    assert [x["world"] for x in summary["launches"]] == [4, 4, 4, 2, 2, 2, 1]
    assert summary["world"] == 1
    events = _events(ck)
    shrinks = [(e["from_chips"], e["to_chips"]) for e in events
               if e["event"] == "mesh_shrink"]
    assert shrinks == [(4, 2), (2, 1)]
    names = [e["event"] for e in events]
    assert names.count("circuit_open") == 2
    assert names.count("supervisor_reset") == 2
    assert names[-1] == "degraded_complete"
    losses = [json.loads(x) for x in out.splitlines() if '"loss"' in x]
    assert losses[-1]["step"] == 8
    assert cli.main(["eval", "--checkpoint-dir", ck, "--config",
                     "criteo1tb_fm_r64", "--bucket", "16", "--synthetic",
                     "256", "--batch-size", "128", "--device", "cpu"]) == 0
    ev = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert ev[0] == {"checkpoint_step": 8} and ev[1]["count"] == 256


def test_progress_between_losses_never_shrinks(tmp_path, gang_env, capsys):
    """Three losses, each after the chain advanced since the one before:
    three flaps, not a permanent fault; the gang keeps its 2 ranks."""
    gang_env.setenv("FM_SPARK_FAULTS", "train_step@7-8=device_loss;"
                    "train_step@15-16=device_loss;"
                    "train_step@23-24=device_loss")
    ck = str(tmp_path / "ck")
    assert cli.main(_TRAIN + ["--steps", "8", "--checkpoint-dir", ck,
                              "--elastic", "--num-processes", "2"]) == 0
    summary = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert summary["elastic"]["shrinks"] == 0
    assert len(summary["launches"]) == 4
    assert "mesh_shrink" not in [e["event"] for e in _events(ck)]


def test_a_rank_left_hanging_is_killed_after_the_grace(tmp_path, gang_env):
    """The first rank to reach step 1 hangs in it (as a rank whose NCCL
    peer died hangs in its collective); the other loses its device. The
    gang ends once the ranks' ``step_window`` watchdog deadline has
    passed, the hung rank killed, and the failure is the device loss."""
    gang_env.setenv("FM_SPARK_FAULTS", "train_step@1=hang:120;"
                    "train_step@2=device_loss")
    gang_env.setenv("FM_SPARK_WATCHDOG", "step_window=3")
    assert gang.grace_seconds() == 3.0
    res = gang.run_gang(_TRAIN + ["--steps", "4", "--checkpoint-dir",
                                  str(tmp_path / "ck")], 2,
                        str(tmp_path / "logs"))
    assert not res.ok and len(res.killed) == 1
    assert res.rcs[res.killed[0]] is None
    assert "device lost" in str(res.failure)
    assert res.seconds < 100


def test_a_program_error_propagates(tmp_path, gang_env):
    gang_env.setenv("FM_SPARK_FAULTS", "train_step@1-2=error")
    with pytest.raises(gang.RankFailure, match="FaultInjected"):
        cli.main(_TRAIN + ["--steps", "4", "--checkpoint-dir",
                           str(tmp_path / "ck"), "--elastic",
                           "--num-processes", "2"])
    assert "failure" not in [e["event"] for e in _events(str(tmp_path
                                                             / "ck"))]


def test_rank_argv_drops_the_parents_flags():
    argv = ["train", "--elastic", "--max-shrinks", "2", "--steps", "4",
            "--num-processes=4", "--metrics-port", "0", "-x"]
    assert cli._rank_argv(argv) == ["train", "--steps", "4", "-x"]


@pytest.mark.parametrize("extra,match", [
    (["--elastic"], "--elastic requires --checkpoint-dir"),
    (["--elastic", "--checkpoint-dir", "CK", "--config",
      "movielens_fm_r8"], "--elastic with strategy 'single' requires "
                          "--supervise"),
    (["--elastic", "--checkpoint-dir", "CK", "--strategy", "row",
      "--force"], "--elastic supports strategies 'single'"),
    (["--elastic", "--checkpoint-dir", "CK", "--ckpt-sharded"],
     "--elastic and --ckpt-sharded are exclusive"),
    (["--elastic", "--checkpoint-dir", "CK", "--row-shards", "2"],
     "--elastic requires --row-shards 1"),
    (["--elastic", "--checkpoint-dir", "CK", "--distributed",
      "--coordinator", "127.0.0.1:1", "--num-processes", "2",
      "--process-id", "0"], "--elastic is single-process: a multi-host "
                            "gang cannot shrink"),
    (["--elastic", "--checkpoint-dir", "CK", "--config",
      "movielens_fm_r8", "--supervise", "--num-processes", "2"],
     "--num-processes with --elastic sizes the gang"),
])
def test_the_reference_guards(tmp_path, extra, match):
    argv = _TRAIN + ["--steps", "2"] + [
        a.replace("CK", str(tmp_path / "ck")) for a in extra]
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


def test_a_torchrun_gang_is_refused(monkeypatch, tmp_path):
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(SystemExit, match="outside torchrun"):
        cli.main(_TRAIN + ["--steps", "2", "--elastic", "--checkpoint-dir",
                           str(tmp_path / "ck")])

