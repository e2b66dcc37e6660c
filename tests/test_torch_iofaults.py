"""The port's storage and network fault planes (``resilience/iofaults.py``,
``resilience/netfaults.py``) and its durable-write seam
(``utils/durable.py``) held against the JAX package's:

- the ``io_*`` and ``net_*`` grammars, scoped and unscoped counters and
  the actions' errnos and byte budgets equal the reference's at each of
  the four disk seams and the three transport phases;
- the tiers: an ``obs``-class failure degrades (counted, flagged,
  swallowed, the same counts as the reference's seam), a ``ckpt``-class
  one fails loud; a torn write never publishes; a torn append leaves a
  line readers skip; a short read is delivered short;
- the port's checkpoint chain takes a transient EIO with bounded retry,
  runs its emergency GC at ENOSPC, raises ``CheckpointIOError`` when the
  retries run out, and an all-failing obs plane leaves the chain's bytes
  unchanged;
- the embed cold store's write-back goes through the seam (``embed``);
- a checkpoint step's directory (its arrays streamed without a copy,
  ``state.json``, its publish) and a sharded step's rank files go through
  the seam under the chain's write policy.

Equality is exact: the modules are pure Python.
"""

import errno
import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from fm_spark_tpu.resilience import faults as rfaults
from fm_spark_tpu.resilience import iofaults as riofaults
from fm_spark_tpu.resilience import netfaults as rnetfaults
from fm_spark_tpu.utils import durable as rdurable
from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.checkpoint import Checkpointer, CheckpointIOError
from fm_spark_tpu_torch.resilience import faults, iofaults, netfaults
from fm_spark_tpu_torch.utils import durable
from fm_spark_tpu_torch.utils.logging import EventLog, read_events


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for mod in (faults, rfaults):
        monkeypatch.delenv(mod.ENV_PLAN, raising=False)
        monkeypatch.delenv(mod.ENV_STATE, raising=False)
        mod.clear()
    monkeypatch.setenv("FM_SPARK_TEST_SLEEP_SCALE", "0.25")
    durable.reset_failure_counts()
    rdurable.reset_failure_counts()
    yield
    faults.clear()
    rfaults.clear()
    obs.shutdown()


def _both(spec):
    faults.activate(spec)
    rfaults.activate(spec)


def _strike(fn, *args):
    """``fn(*args)``'s outcome: its return, or the errno and exception
    class it raised."""
    try:
        return ("ok", fn(*args))
    except OSError as e:
        return ("oserror", type(e).__name__, e.errno)
    except faults.FaultInjected as e:
        return ("fault", type(e).__name__, str(e))
    except rfaults.FaultInjected as e:
        return ("fault", type(e).__name__, str(e))


_SEAMS = {"io_write": "on_write", "io_fsync": "on_fsync",
          "io_rename": "on_rename", "io_read": "on_read"}


@pytest.mark.parametrize("point", sorted(_SEAMS))
@pytest.mark.parametrize("action", ["eio", "enospc", "readonly",
                                    "torn_write:7", "slow_ms:1", "error"])
def test_each_disk_seam_strikes_as_the_reference(point, action):
    _both(f"{point}@1={action};{point}.ckpt@2={action}")
    fn = _SEAMS[point]
    for cls in (None, "obs", "ckpt", "ckpt"):
        got = _strike(getattr(iofaults, fn), cls)
        want = _strike(getattr(riofaults, fn), cls)
        assert got == want, (point, action, cls)


def test_scoped_and_diskwide_counters_advance_as_the_reference():
    spec = "io_write.ckpt@2=enospc;io_write@1=eio;io_write.obs@1-2=readonly"
    _both(spec)
    seq = ["ckpt", "ckpt", "ckpt", "obs", "obs", "obs", None, "embed"]
    got = [getattr(iofaults.check("io_write", c), "action", None)
           for c in seq]
    want = [getattr(riofaults.check("io_write", c), "action", None)
            for c in seq]
    assert got == want and got[:2] == ["eio", "enospc"]
    assert faults._counts == rfaults._counts
    assert iofaults.PATH_CLASSES == riofaults.PATH_CLASSES


@pytest.mark.parametrize("best_effort,path_class", [
    (True, "obs"), (False, "ckpt"), (True, "quarantine"), (False, None)])
def test_the_tiers_degrade_or_fail_loud_as_the_reference(
        tmp_path, best_effort, path_class):
    _both("io_write@1=eio;io_rename@1=enospc")
    got, want = [], []
    for mod, out in ((durable, got), (rdurable, want)):
        for i in range(3):
            path = str(tmp_path / f"{mod.__name__}.{i}.json")
            r = _strike(lambda: mod.atomic_write_json(
                path, {"i": i}, path_class=path_class,
                best_effort=best_effort))
            out.append((r, os.path.exists(path)))
        counts = mod.io_failure_counts()
        out.append(counts)
    assert got == want
    assert got[0][1] is False and got[1][1] is False and got[2][1] is True
    if best_effort:
        assert got[0][0] == ("ok", False)
        assert got[3]["best_effort"] == 2
        assert obs.gauge("obs/io_degraded").value == 1.0
    else:
        assert got[0][0][:2] == ("oserror", "OSError")


def test_a_torn_write_never_publishes_and_a_torn_append_is_skipped(tmp_path):
    path = str(tmp_path / "f.json")
    durable.atomic_write_json(path, {"v": 1})
    faults.activate("io_write@1=torn_write:3")
    with pytest.raises(OSError):
        durable.atomic_write_json(path, {"v": 2})
    assert json.load(open(path)) == {"v": 1}        # the old bytes stand
    log = str(tmp_path / "log.jsonl")
    journal = EventLog(log)
    journal.emit("a", n=1)
    faults.activate("io_write@1=torn_write:5")
    journal.emit("b", n=2)                          # torn, swallowed
    # The torn fragment has no newline: the next line merges into it
    # (both lost), the one after lands whole; readers skip the garble.
    journal.emit("c", n=3)
    journal.emit("d", n=4)
    journal.close()
    assert [r["event"] for r in read_events(log)] == ["a", "d"]
    assert durable.io_failure_counts()["obs"] == 1


def test_reads_deliver_short_or_raise_as_the_reference(tmp_path):
    path = str(tmp_path / "blob")
    with open(path, "wb") as f:
        f.write(b"0123456789")
    _both("io_read@1=torn_write:4;io_read@2=eio")
    got = [_strike(durable.read_bytes, path) for _ in range(3)]
    want = [_strike(rdurable.read_bytes, path) for _ in range(3)]
    assert got == want == [("ok", b"0123"), ("oserror", "OSError",
                                              errno.EIO),
                           ("ok", b"0123456789")]


def _params():
    g = torch.Generator().manual_seed(0)
    return {"w0": torch.randn((), generator=g),
            "vw": [torch.randn(8, 5, generator=g) for _ in range(3)]}


def test_the_chain_retries_a_transient_eio(tmp_path):
    journal = EventLog()
    ck = Checkpointer(str(tmp_path), journal=journal)
    faults.activate("io_write.ckpt@1-2=eio")
    ck.save(1, _params(), force=True)
    ck.wait()
    assert ck.last_good_step() == 1
    retries = [e for e in journal.records if e["event"] == "ckpt_io_retry"]
    assert len(retries) == 2 and retries[0]["errno"] == errno.EIO


def test_enospc_runs_the_emergency_gc_then_commits(tmp_path):
    journal = EventLog()
    ck = Checkpointer(str(tmp_path), max_to_keep=10, journal=journal)
    for s in (1, 2):
        ck.save(s, _params(), force=True)
    ck.wait()
    ck.demote(2, reason="drill")
    faults.activate("io_write.ckpt@1=enospc")
    ck.save(3, _params(), force=True)
    ck.wait()
    events = [e["event"] for e in journal.records]
    assert "ckpt_emergency_gc" in events and ck.last_good_step() == 3
    assert not os.path.isdir(tmp_path / "2")         # the tombstoned step


def test_exhausted_retries_raise_a_checkpoint_io_error(tmp_path):
    ck = Checkpointer(str(tmp_path))
    faults.activate("io_write.ckpt@1-9=eio")
    ck.save(1, _params(), force=True)
    with pytest.raises(CheckpointIOError) as ei:
        ck.wait()
    assert ei.value.errno == errno.EIO
    assert ck.last_good_step() is None


def test_an_all_failing_obs_plane_leaves_the_chain_bytes_unchanged(tmp_path):
    def chain(root, plan):
        faults.clear()
        obs.configure(str(root / "run"))
        if plan:
            faults.activate(plan)
        ck = Checkpointer(str(root / "ck"))
        p = _params()
        for s in (1, 2, 3):
            with obs.span("drill/step", step=s):
                for t in p["vw"]:
                    t.mul_(0.5)
            ck.save(s, p, {"cursor": s}, force=True)
        ck.close()
        obs.shutdown()
        faults.clear()
        return {n: open(root / "ck" / "manifests" / n).read()
                for n in sorted(os.listdir(root / "ck" / "manifests"))}

    golden = chain(tmp_path / "a", None)
    durable.reset_failure_counts()
    degraded = chain(tmp_path / "b", "io_write.obs@1-512=eio")
    strip = {n: {k: v for k, v in json.loads(t).items() if k != "ts"}
             for n, t in golden.items()}
    assert strip == {n: {k: v for k, v in json.loads(t).items() if k != "ts"}
                     for n, t in degraded.items()}
    assert durable.io_failure_counts()["obs"] > 0
    for s in (1, 2, 3):
        for k in ("w0.npy", "vw/0.npy"):
            assert np.array_equal(np.load(tmp_path / "a" / "ck" / str(s) / k),
                                  np.load(tmp_path / "b" / "ck" / str(s) / k))


def test_the_embed_cold_store_writes_through_the_seam(tmp_path):
    from fm_spark_tpu_torch.embed.store import ColdStore

    cold = ColdStore.dense({"table": np.arange(40, dtype=np.float32
                                              ).reshape(8, 5)},
                           bucket_rows=4)
    faults.activate("io_write.embed@1=enospc")
    with pytest.raises(OSError) as ei:
        cold.write_back(str(tmp_path / "c"))
    assert ei.value.errno == errno.ENOSPC
    faults.clear()
    cold.write_back(str(tmp_path / "c"))
    faults.activate("io_read.embed@1=torn_write:16")
    assert ColdStore.read_back(str(tmp_path / "c")) is None   # walk back
    faults.clear()
    back = ColdStore.read_back(str(tmp_path / "c"))
    assert np.array_equal(back.dense_plane("table"),
                          np.arange(40, dtype=np.float32).reshape(8, 5))


# ------------------------------------------- the step directory's seam
#
# A step of ``_params()`` is five files, in this order: w0.npy, vw/0.npy,
# vw/1.npy, vw/2.npy and state.json. Each is one ``io_write.ckpt``
# occurrence and one ``io_fsync.ckpt`` (its fsync); then the fsyncs of the
# ``vw`` dir (6) and the staging dir (7), the publish (``io_rename.ckpt``
# 1) and the chain dir's fsync (8); then the manifest's write.

_STEP_FILES = ["w0.npy", "vw/0.npy", "vw/1.npy", "vw/2.npy", "state.json"]


def _no_staging(root) -> bool:
    return not [n for n in os.listdir(root) if ".tmp" in n]


def _step_retries(journal, name="1"):
    return [e for e in journal.records
            if e["event"] == "ckpt_io_retry" and e["path"] == name]


def test_the_step_directory_goes_through_the_seam_in_order(tmp_path,
                                                           monkeypatch):
    """Every byte, fsync and the publish of a step's directory are seam
    events of class ``ckpt``, in the order the occurrences above count."""
    seq = []
    for point, fn in (("io_write", "on_write"), ("io_fsync", "on_fsync"),
                      ("io_rename", "on_rename")):
        real = getattr(iofaults, fn)

        def spy(path_class=None, _point=point, _real=real):
            seq.append((_point, path_class))
            return _real(path_class)
        monkeypatch.setattr(iofaults, fn, spy)
    real_open, real_fsync_dir = open, durable.fsync_dir

    def spy_open(path, *a, **kw):
        seq.append(("open", os.path.relpath(path, tmp_path)))
        return real_open(path, *a, **kw)

    def spy_fsync_dir(path, path_class=None):
        seq.append(("dir", os.path.relpath(path, tmp_path)))
        return real_fsync_dir(path, path_class)
    monkeypatch.setattr(durable, "open", spy_open, raising=False)
    monkeypatch.setattr(durable, "fsync_dir", spy_fsync_dir)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, _params(), force=True)
    ck.wait()
    tmp = f"1.tmp-{os.getpid()}"
    want = []
    for rel in _STEP_FILES:
        want += [("open", os.path.join(tmp, rel)), ("io_write", "ckpt"),
                 ("io_fsync", "ckpt")]
    want += [("dir", os.path.join(tmp, "vw")), ("io_fsync", "ckpt"),
             ("dir", tmp), ("io_fsync", "ckpt"), ("io_rename", "ckpt"),
             ("dir", "."), ("io_fsync", "ckpt"),
             ("open", os.path.join("manifests", "1.json.tmp")),
             ("io_write", "ckpt")]
    assert seq[:len(want)] == want
    assert sorted(os.path.relpath(os.path.join(d, f), tmp_path / "1")
                  for d, _, fs in os.walk(tmp_path / "1") for f in fs) \
        == sorted(_STEP_FILES)


@pytest.mark.parametrize("rule", [
    "io_write.ckpt@2=eio",           # an array's bytes (vw/0.npy)
    "io_write.ckpt@5=eio",           # state.json's bytes
    "io_fsync.ckpt@2=eio",           # an array's fsync
    "io_fsync.ckpt@5=eio",           # state.json's fsync
    "io_fsync.ckpt@7=eio",           # the staging dir's fsync
    "io_fsync.ckpt@8=eio",           # the chain dir's, after the publish
    "io_rename.ckpt@1=eio",          # the publish
])
def test_each_ckpt_point_strikes_the_step_directory(tmp_path, rule):
    """One strike on the step's directory fails that attempt only: it is
    counted, journaled as a retry of the step (not of its manifest), leaves
    no staging dir and no step behind, and the retry commits."""
    journal = EventLog()
    ck = Checkpointer(str(tmp_path), journal=journal)
    faults.activate(rule)
    ck.save(1, _params(), {"cursor": 1}, force=True)
    ck.wait()
    faults.clear()
    retries = [e for e in journal.records if e["event"] == "ckpt_io_retry"]
    assert [(e["path"], e["errno"]) for e in retries] == [("1", errno.EIO)]
    assert durable.io_failure_counts()["ckpt"] == 1
    assert ck.last_good_step() == 1 and _no_staging(tmp_path)
    got = ck.restore()
    want = _params()
    assert torch.equal(got["params"]["vw/0"], want["vw"][0])
    assert got["pipeline"] == {"cursor": 1}


def test_a_torn_array_is_never_published_and_is_retried(tmp_path,
                                                         monkeypatch):
    """A ``torn_write`` budget cuts the array's FILE across its chunks; the
    torn staging dir is never renamed into place, and the retry writes the
    whole file. Torn every time, nothing is published."""
    journal = EventLog()
    ck = Checkpointer(str(tmp_path), journal=journal)
    published = []
    real_rename = os.rename

    def spy_rename(src, dst):
        published.append(os.path.getsize(os.path.join(src, "vw", "0.npy")))
        return real_rename(src, dst)
    monkeypatch.setattr(os, "rename", spy_rename)
    faults.activate("io_write.ckpt@2=torn_write:100")
    ck.save(1, _params(), force=True)
    ck.wait()
    full = os.path.getsize(tmp_path / "1" / "vw" / "0.npy")
    assert full > 100 and published == [full]
    assert len(_step_retries(journal)) == 1 and _no_staging(tmp_path)
    faults.clear()
    faults.activate("io_write.ckpt@1-99=torn_write:100")
    ck.save(2, _params(), force=True)
    with pytest.raises(CheckpointIOError) as ei:
        ck.wait()
    assert ei.value.errno == errno.EIO and published == [full]
    assert not os.path.exists(tmp_path / "2") and _no_staging(tmp_path)
    assert ck.last_good_step() == 1


def test_enospc_on_an_array_runs_the_gc_once(tmp_path):
    """ENOSPC on a step's array: one journaled emergency GC (the step its
    trigger, the demoted step its victim), then exactly one more attempt,
    which commits; struck again there, the save raises."""
    journal = EventLog()
    ck = Checkpointer(str(tmp_path), max_to_keep=10, journal=journal)
    for s in (1, 2):
        ck.save(s, _params(), force=True)
    ck.wait()
    ck.demote(2, reason="drill")
    faults.activate("io_write.ckpt@2=enospc")
    ck.save(3, _params(), force=True)
    ck.wait()
    gc = [e for e in journal.records if e["event"] == "ckpt_emergency_gc"]
    assert [(e["trigger"], e["steps"]) for e in gc] == [("3", [2])]
    assert not _step_retries(journal, "3")
    assert ck.all_steps() == [1, 3] and ck.last_good_step() == 3
    faults.clear()
    ck.demote(3, reason="drill")
    # The first attempt's vw/0.npy (2), then the second's w0.npy (3).
    faults.activate("io_write.ckpt@2-3=enospc")
    ck.save(4, _params(), force=True)
    with pytest.raises(CheckpointIOError) as ei:
        ck.wait()
    assert ei.value.errno == errno.ENOSPC
    gc = [e for e in journal.records if e["event"] == "ckpt_emergency_gc"]
    assert [(e["trigger"], e["steps"]) for e in gc][1:] == [("4", [3])]
    errors = [e for e in journal.records
              if e["event"] == "checkpoint_io_error"]
    assert [(e["path"], e["errno"]) for e in errors] == [("4", errno.ENOSPC)]
    assert ck.all_steps() == [1] and _no_staging(tmp_path)
    assert ck.last_good_step() == 1


def test_an_occurrence_past_the_step_files_strikes_the_manifest(tmp_path):
    """The step's five files are occurrences 1-5; the 6th ``io_write.ckpt``
    is the manifest's, retried under its own name as before."""
    journal = EventLog()
    ck = Checkpointer(str(tmp_path), journal=journal)
    faults.activate("io_write.ckpt@6=eio")
    ck.save(1, _params(), force=True)
    ck.wait()
    retries = [e for e in journal.records if e["event"] == "ckpt_io_retry"]
    assert [e["path"] for e in retries] == ["1.json"]
    assert ck.last_good_step() == 1


def test_an_array_streams_in_chunks_and_is_never_copied_whole(tmp_path,
                                                              monkeypatch):
    """A 48 MiB array goes into the seam's file object in chunks of at
    most 16 MiB (the header a write of its own), each a view of the
    array's memory: the save allocates under 1 MiB, so neither the array
    nor a chunk of it is copied."""
    import tracemalloc

    sizes = []
    real_write = durable._BudgetedFile.write

    def spy(self, data):
        sizes.append(memoryview(data).nbytes)
        return real_write(self, data)
    monkeypatch.setattr(durable._BudgetedFile, "write", spy)
    big = torch.arange(12 * 2**20, dtype=torch.float32)      # 48 MiB
    params = {"w0": torch.zeros(()), "vw": [big]}
    ck = Checkpointer(str(tmp_path))
    tracemalloc.start()
    try:
        before = tracemalloc.get_traced_memory()[0]
        tracemalloc.reset_peak()
        ck.save(1, params, force=True)
        ck.wait()
        peak = tracemalloc.get_traced_memory()[1] - before
        print('PEAK', peak)
    finally:
        tracemalloc.stop()
    header = os.path.getsize(tmp_path / "1" / "vw" / "0.npy") - big.numel() * 4
    assert max(sizes) <= 16 * 2**20 + header
    assert sum(s > header for s in sizes) >= 3       # vw/0's three chunks
    assert peak < 1 << 20, peak
    assert np.array_equal(np.load(tmp_path / "1" / "vw" / "0.npy"),
                          big.numpy())


# ------------------------------------------- a sharded step's files
#
# ``save_sharded`` at a mesh of one (no process group): the rank's files
# (w0.npy and vw/0.npy-vw/2.npy, ``io_write.ckpt`` 1-4) through
# ``durable.write_staged``, then rank 0's state.json (5) and the publish
# (``io_rename.ckpt`` 1) through ``durable.publish_dir``, each under the
# chain's write policy.


def _sharded_save(ck, step, seed=0):
    from fm_spark_tpu_torch import models, parallel
    from fm_spark_tpu_torch.parallel import field_step

    spec = models.FieldFMSpec(num_features=3 * 8, num_fields=3, bucket=8,
                              rank=4, init_std=0.1)
    params = spec.init(torch.Generator().manual_seed(seed), device="cpu")
    mesh = parallel.make_field_mesh(device="cpu")
    sharded = parallel.shard_field_params(
        parallel.stack_field_params(spec, params, 1), mesh)
    field_step.save_sharded(ck, step, spec, sharded, mesh, {"cursor": step},
                          force=True)
    return params


@pytest.mark.parametrize("rule,retried", [
    ("io_write.ckpt@2=eio", True),        # a rank's array (vw/0.npy)
    ("io_write.ckpt@3=torn_write:40", True),
    ("io_write.ckpt@5=eio", True),        # rank 0's state.json
    ("io_fsync.ckpt@1=eio", True),        # a rank file's fsync
    ("io_rename.ckpt@1=eio", True),       # the publish
    ("io_write.ckpt@6=eio", False),       # past the step: the manifest
])
def test_a_sharded_step_goes_through_the_seam(tmp_path, rule, retried):
    """Each ``ckpt`` point strikes a sharded step's rank files, its
    ``state.json`` or its publish; the policy retries that write under
    the step's name, and the step commits and restores as saved."""
    from fm_spark_tpu_torch.parallel import field_step

    journal = EventLog()
    ck = Checkpointer(str(tmp_path), journal=journal)
    faults.activate(rule)
    params = _sharded_save(ck, 1)
    faults.clear()
    retries = [e["path"] for e in journal.records
               if e["event"] == "ckpt_io_retry"]
    assert retries == (["1"] if retried else ["1.json"])
    assert durable.io_failure_counts()["ckpt"] == 1
    assert ck.last_good_step() == 1 and _no_staging(tmp_path)
    with open(tmp_path / "1" / "state.json") as f:
        assert json.load(f)["layout"] == field_step.SHARDED_LAYOUT
    got = ck.restore()
    assert got["pipeline"] == {"cursor": 1}
    for f in range(3):
        assert torch.equal(got["params"][f"vw/{f}"], params["vw"][f])


def test_a_sharded_step_on_a_full_disk_runs_the_gc_or_raises(tmp_path):
    """ENOSPC on a rank's file runs the emergency GC once and the file is
    written again; EIO on every write raises ``CheckpointIOError`` and
    leaves no step and no staging dir."""
    journal = EventLog()
    ck = Checkpointer(str(tmp_path), max_to_keep=10, journal=journal)
    for s in (1, 2):
        _sharded_save(ck, s)
    ck.demote(2, reason="drill")
    faults.activate("io_write.ckpt@2=enospc")
    _sharded_save(ck, 3)
    faults.clear()
    gc = [e for e in journal.records if e["event"] == "ckpt_emergency_gc"]
    assert [(e["trigger"], e["steps"]) for e in gc] == [("3", [2])]
    assert ck.all_steps() == [1, 3] and ck.last_good_step() == 3
    faults.activate("io_write.ckpt@1-99=eio")
    with pytest.raises(CheckpointIOError) as ei:
        _sharded_save(ck, 4)
    faults.clear()
    assert ei.value.errno == errno.EIO
    assert ck.all_steps() == [1, 3] and ck.last_good_step() == 3
    assert not os.path.exists(tmp_path / "4") and _no_staging(tmp_path)


# ------------------------------------------------------------- network


@pytest.mark.parametrize("spec", [
    "net_connect.replica-1@1-3=refuse;net_connect@2=reset",
    "net_recv@1=truncate_after:7;net_send@1=truncate_after:7",
    "net_send@1=refuse;net_send.replica-2@1=reset",
    "net_recv@1=error;net_connect@1-2=slow_ms:1",
])
def test_transport_phases_strike_as_the_reference(spec):
    _both(spec)
    seq = [("on_connect", "replica-1"), ("on_connect", None),
           ("on_send", "replica-2"), ("on_send", None),
           ("on_recv", None), ("on_connect", "replica-1"),
           ("on_recv", "replica-1")]
    got = [_net(netfaults, fn, peer) for fn, peer in seq]
    want = [_net(rnetfaults, fn, peer) for fn, peer in seq]
    assert got == want
    assert faults._counts == rfaults._counts


def _net(mod, fn, peer):
    try:
        return ("ok", getattr(mod, fn)(peer))
    except OSError as e:
        return ("oserror", type(e).__name__)
    except Exception as e:      # noqa: BLE001 — the injected generic fault
        return ("fault", type(e).__name__, str(e))


def test_blackhole_times_out_and_transport_failure_gates_retries():
    _both("net_connect@1=blackhole")
    for mod in (netfaults, rnetfaults):
        t0 = time.monotonic()
        with pytest.raises(socket.timeout):
            mod.on_connect(None, timeout_s=0.05)
        assert 0.03 <= time.monotonic() - t0 < 2.0
    for phase, nbytes in (("connect", 0), ("send", 0), ("recv", 0),
                          ("recv", 9)):
        got = netfaults.TransportFailure("x", phase=phase,
                                         bytes_received=nbytes)
        want = rnetfaults.TransportFailure("x", phase=phase,
                                           bytes_received=nbytes)
        assert got.retry_safe == want.retry_safe
    assert netfaults.BLACKHOLE_CAP_S == rnetfaults.BLACKHOLE_CAP_S
