"""Deterministic storage faults at the durable-write seam (the port's
copy of ``fm_spark_tpu/resilience/iofaults.py``): ENOSPC mid-commit, EIO
on an append, a torn write, a read-only flip, a multi-second fsync,
injected at the single seam :mod:`fm_spark_tpu_torch.utils.durable`
(checkpoint manifests, tombstones and ``last_good``, the obs ledger,
flight spool and EventLog journals, the embed cold store's write-back and
the quarantine dead-letter journal all write through it), with the SAME
plan grammar, environment variables and occurrence counters as
:mod:`fm_spark_tpu_torch.resilience.faults`.

Points and their actions::

    io_write    per durable payload write    eio | enospc | readonly
    io_fsync    per file/dir fsync           | torn_write:K | slow_ms:N
    io_rename   per atomic rename publish
    io_read     per durable read

- ``eio``          OSError(EIO): a failing append, write or read
- ``enospc``       OSError(ENOSPC): disk full at that phase
- ``readonly``     OSError(EROFS): the filesystem flipped read-only
- ``torn_write:K`` write only the first K bytes, then EIO (on
                   ``io_read`` a short read of K bytes; on
                   ``io_rename``/``io_fsync`` it degrades to ``eio``: a
                   torn publish is a failed publish)
- ``slow_ms:N``    N ms of disk latency, then proceed (scaled by
                   ``FM_SPARK_TEST_SLEEP_SCALE``)

Path-class scoping: ``io_write.ckpt@1-8=enospc`` fires only on writes
whose call site declared the ``ckpt`` class (its own occurrence
counter). The classes are a closed set, :data:`PATH_CLASSES` (``ckpt``,
``obs``, ``embed``, ``cache``, ``quarantine``), so
``faults.FaultPlan.from_spec`` rejects an unknown one eagerly.

The tier discipline lives in :mod:`fm_spark_tpu_torch.utils.durable`:
this module decides WHETHER a disk event fails and HOW; the seam decides
what a failure means (observability degrades, a checkpoint commit fails
loud and its caller retries).
"""

from __future__ import annotations

import errno
import threading
import time

from fm_spark_tpu_torch.resilience import faults
from fm_spark_tpu_torch.utils import sleeps

__all__ = [
    "PATH_CLASSES",
    "check",
    "on_fsync",
    "on_read",
    "on_rename",
    "on_write",
]

#: The path-class vocabulary durable call sites declare (scoping keys
#: like ``io_write.ckpt``). Closed set, validated eagerly by
#: ``faults.FaultPlan.from_spec`` — see module docstring.
PATH_CLASSES = faults.IO_PATH_CLASSES

#: Occurrence counting is shared across the checkpoint writer thread,
#: obs emitters, and any drill thread; faults' in-proc counter dict is
#: not locked (its points fire from one thread each), so the storage
#: plane serializes its own counter consumption — same policy as
#: netfaults.
_count_lock = threading.Lock()


def check(point: str, path_class: "str | None" = None):
    """The matching rule for this disk event, or None.

    Consults the ACTIVE faults plan (env or ``faults.activate``).
    A class-scoped rule set (``point.class``) is consulted first with
    its own occurrence counter; the unscoped point counts disk-wide.
    Both counters only advance when the plan names their key — an
    inactive plane is one ``is None`` check, same as ``inject``.
    """
    plan = faults.current_plan()
    if plan is None:
        return None
    scoped = unscoped = None
    with _count_lock:
        # Both counters advance on every event their key is planned
        # for — "this class's Nth write" and "the disk's Nth write"
        # stay independently meaningful; the class-scoped rule wins
        # when both match.
        if path_class is not None:
            key = f"{point}.{path_class}"
            if key in plan.points:
                scoped = plan.rule_for(key, faults._next_count(key))
        if point in plan.points:
            unscoped = plan.rule_for(point, faults._next_count(point))
    return scoped if scoped is not None else unscoped


def _strike(rule, phase: str) -> "int | None":
    """Take a rule's action at a disk phase. Raises the ``OSError`` the
    action emulates, sleeps for latency actions, or returns a byte
    budget for ``torn_write`` on write/read (the caller owns the bytes
    to tear). Non-io actions (``sleep``/``error``/``exit``...) fall
    through to the generic :meth:`faults._Rule.fire`."""
    a = rule.action
    where = f"{rule.point}#{rule.occurrence}"
    if a == "eio":
        raise OSError(errno.EIO,
                      f"[iofault] I/O error during {phase} ({where})")
    if a == "enospc":
        raise OSError(errno.ENOSPC,
                      f"[iofault] no space left during {phase} ({where})")
    if a == "readonly":
        raise OSError(errno.EROFS,
                      f"[iofault] read-only file system at {phase} "
                      f"({where})")
    if a == "slow_ms":
        # Designed sleep: a slow-disk drill proves latency TOLERANCE,
        # not latency itself — FM_SPARK_TEST_SLEEP_SCALE applies
        #.
        time.sleep(sleeps.scaled(float(rule.param) / 1e3))
        return None
    if a == "torn_write":
        if phase in ("write", "read"):
            return int(rule.param)
        # A torn rename/fsync has no partial-byte semantics: the
        # publish simply failed.
        raise OSError(errno.EIO,
                      f"[iofault] {phase} torn ({where})")
    rule.fire(rule.occurrence)
    return None


def on_write(path_class: "str | None" = None) -> "int | None":
    """``io_write`` — fires per durable payload write. Returns a byte
    budget when the rule is ``torn_write:K`` (the caller writes only
    the first K bytes then raises EIO — the crash-consistency
    primitive); raises the emulated ``OSError`` otherwise."""
    rule = check("io_write", path_class)
    if rule is None:
        return None
    return _strike(rule, "write")


def on_fsync(path_class: "str | None" = None) -> None:
    """``io_fsync`` — fires per file/directory fsync (the stall
    point of real disks)."""
    rule = check("io_fsync", path_class)
    if rule is not None:
        _strike(rule, "fsync")


def on_rename(path_class: "str | None" = None) -> None:
    """``io_rename`` — fires per atomic rename publish
    (``os.replace`` of tmp onto final). A failure here strikes AFTER
    the payload is durable but BEFORE it is visible — the exact window
    torn-publish drills need."""
    rule = check("io_rename", path_class)
    if rule is not None:
        _strike(rule, "rename")


def on_read(path_class: "str | None" = None) -> "int | None":
    """``io_read`` — fires per durable read. Returns a byte budget
    when the rule is ``torn_write:K`` (deliver only K bytes — a short
    read the verify-then-walk-back tier must survive); raises the
    emulated ``OSError`` otherwise."""
    rule = check("io_read", path_class)
    if rule is None:
        return None
    return _strike(rule, "read")
