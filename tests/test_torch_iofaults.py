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
- the embed cold store's write-back goes through the seam (``embed``).

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
