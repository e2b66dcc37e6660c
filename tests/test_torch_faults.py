"""The port's fault plane (``resilience/faults.py``, ``utils/sleeps.py``)
held against the JAX package's on the same inputs:

- every plan of a parametrised list parses to the same rules in both, and
  every bad plan is refused with the same message;
- a scripted sequence of ``inject`` calls fires the same actions at the
  same occurrences, with the same exception classes and texts;
- the ``FM_SPARK_FAULTS_STATE`` counters are shared across processes
  (two port processes, then the reference reading the same file);
- ``is_device_loss`` classifies the same exceptions alike;
- the registries (points, actions, path classes) are the reference's;
- ``sleeps.sleep_scale`` reads the variable as the reference does.

Equality is exact throughout: the modules are pure Python.
"""

import os
import subprocess
import sys

import pytest

from fm_spark_tpu.resilience import faults as rfaults
from fm_spark_tpu.utils import sleeps as rsleeps
from fm_spark_tpu_torch.resilience import faults
from fm_spark_tpu_torch.utils import sleeps

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for mod in (faults, rfaults):
        monkeypatch.delenv(mod.ENV_PLAN, raising=False)
        monkeypatch.delenv(mod.ENV_STATE, raising=False)
        mod.clear()
    yield
    faults.clear()
    rfaults.clear()


def _rules(plan):
    return {k: (r.point, r.occurrence, r.action, r.param)
            for k, r in plan._rules.items()}


GOOD = [
    "train_step@3=device_loss",
    "backend_init@1=hang:300;sweep_leg@2=device_loss",
    "ckpt_commit@1=hang:0.5;ckpt_demote@2=exit:9",
    "serve_reload@1=exit:9;online_eval@2-4=error",
    "embed_prefetch@5=device_loss;embed_evict@1=sigterm",
    "ingest_truncate@1=error; ingest_corrupt@3=error ;",
    "io_write.ckpt@2-4=enospc;io_fsync@1=slow_ms:20;io_read@1=torn_write:8",
    "io_rename.obs@1=readonly;io_write.quarantine@1=eio",
    "net_connect.replica-1@1-8=refuse;net_recv@2=truncate_after:64",
    "net_send@1=slow_ms:5;net_connect@3=blackhole:2",
    "probe@1=sleep:0.25;train_step@1-512=error",
    "",
]

BAD = [
    "train_step",                    # no @ / =
    "train_step@x=error",            # non-numeric occurrence
    "train_step@1=explode",          # unknown action
    "trian_step@1=device_loss",      # unknown point
    "train_step.ckpt@1=eio",         # scope off an io/net point
    "io_write.bogus@1=eio",          # unknown path class
    "io_read.replica-1@1=eio",       # peer-style scope on an io point
    "train_step@1=enospc",           # io action off an io point
    "io_write@1=refuse",             # net action on an io point
    "train_step@1=refuse",           # net action off a net point
    "io_fsync@1=slow_ms",            # missing numeric parameter
    "io_write@1=torn_write:lots",    # non-numeric parameter
    "io_write@9-3=eio",              # inverted range
    "io_write@1-600=eio",            # wider than the range bound
]


@pytest.mark.parametrize("spec", GOOD)
def test_plans_parse_to_the_reference_rules(spec):
    got = faults.FaultPlan.from_spec(spec)
    want = rfaults.FaultPlan.from_spec(spec)
    assert _rules(got) == _rules(want)
    assert got.points == want.points


@pytest.mark.parametrize("spec", BAD)
def test_bad_plans_are_refused_with_the_reference_message(spec):
    with pytest.raises(ValueError) as got:
        faults.FaultPlan.from_spec(spec)
    with pytest.raises(ValueError) as want:
        rfaults.FaultPlan.from_spec(spec)
    assert str(got.value) == str(want.value)


def test_registries_are_the_references():
    assert faults.KNOWN_POINTS == rfaults.KNOWN_POINTS
    assert faults.ACTIONS == rfaults.ACTIONS
    assert faults.IO_PATH_CLASSES == rfaults.IO_PATH_CLASSES
    assert faults.NET_POINTS == rfaults.NET_POINTS
    assert faults.IO_POINTS == rfaults.IO_POINTS
    # The points the port calls before this plane existed keep their names.
    for p in ("ckpt_demote", "ckpt_gc", "serve_reload", "ingest_truncate",
              "ingest_corrupt", "embed_prefetch", "embed_evict",
              "online_eval", "train_step", "ckpt_commit"):
        assert p in faults.KNOWN_POINTS


def _outcome(mod, point):
    try:
        mod.inject(point)
    except mod.FaultInjected as e:
        return type(e).__name__, str(e)
    return None


SCRIPT = ["train_step", "train_step", "ckpt_commit", "train_step",
          "serve_reload", "ingest_corrupt", "ingest_corrupt", "train_step",
          "ckpt_commit", "online_eval", "train_step", "ingest_corrupt"]


@pytest.mark.parametrize("spec", [
    "train_step@2=device_loss;ckpt_commit@2=error",
    "train_step@3-5=error;ingest_corrupt@2=error;serve_reload@1=sleep:0",
    "ingest_corrupt@1-3=device_loss;online_eval@1=error",
])
def test_a_scripted_inject_sequence_fires_as_the_reference(spec):
    faults.activate(spec)
    rfaults.activate(spec)
    got = [_outcome(faults, p) for p in SCRIPT]
    want = [_outcome(rfaults, p) for p in SCRIPT]
    assert got == want
    assert any(x is not None for x in got)
    assert faults._counts == rfaults._counts


def test_no_plan_is_one_check_and_the_env_loads_lazily(monkeypatch):
    assert faults.current_plan() is None
    faults.inject("train_step")             # no plan: nothing happens
    assert faults._counts == {}
    faults.clear()
    monkeypatch.setenv(faults.ENV_PLAN, "train_step@1=error")
    with pytest.raises(faults.FaultInjected, match="train_step#1"):
        faults.inject("train_step")
    faults.clear()
    monkeypatch.setenv(faults.ENV_PLAN, "trian_step@1=error")
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.inject("train_step")


_CHILD = """
import sys
sys.path.insert(0, {repo!r})
from fm_spark_tpu_torch.resilience import faults
try:
    faults.inject("train_step")
except faults.FaultInjected as e:
    print("FIRED", type(e).__name__, e)
else:
    print("QUIET")
"""


def test_state_counters_are_shared_across_processes(tmp_path, monkeypatch):
    state = tmp_path / "state.json"
    env = {**os.environ, faults.ENV_PLAN: "train_step@2=device_loss",
           faults.ENV_STATE: str(state)}
    script = _CHILD.format(repo=REPO)
    outs = [subprocess.run([sys.executable, "-c", script], env=env,
                           capture_output=True, text=True, timeout=120
                           ).stdout.strip() for _ in range(2)]
    assert outs[0] == "QUIET"
    assert outs[1].startswith("FIRED InjectedDeviceLoss")
    assert "train_step#2" in outs[1]
    # The reference reads and advances the same file: its 3rd occurrence.
    monkeypatch.setenv(rfaults.ENV_STATE, str(state))
    assert rfaults._next_count("train_step") == 3
    monkeypatch.setenv(faults.ENV_STATE, str(state))
    assert faults._next_count("train_step") == 4


@pytest.mark.parametrize("exc", [
    RuntimeError("INTERNAL: device lost"),
    RuntimeError("DATA_LOSS: stream broken"),
    OSError("Connection reset by peer"),
    RuntimeError("Failed to enqueue the program"),
    RuntimeError("shape mismatch"),
    ValueError("bad value"),
    KeyboardInterrupt(),
    SystemExit(1),
])
def test_is_device_loss_classifies_as_the_reference(exc):
    assert faults.is_device_loss(exc) == rfaults.is_device_loss(exc)


def test_injected_device_loss_is_the_references_class_and_text():
    got = faults.InjectedDeviceLoss("train_step", 2)
    want = rfaults.InjectedDeviceLoss("train_step", 2)
    assert str(got) == str(want)
    assert faults.is_device_loss(got) and rfaults.is_device_loss(got)
    assert rfaults.is_device_loss(RuntimeError(str(got)))


@pytest.mark.parametrize("value", ["", "0.25", "1", "4", "-1", "junk"])
def test_sleep_scale_reads_the_variable_as_the_reference(value,
                                                         monkeypatch):
    monkeypatch.setenv(sleeps.ENV, value)
    assert sleeps.sleep_scale() == rsleeps.sleep_scale()
    assert sleeps.scaled(2.0) == rsleeps.scaled(2.0)
    assert sleeps.ENV == rsleeps.ENV
