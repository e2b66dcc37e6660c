"""The durable-write seam (the port's copy of
``fm_spark_tpu/utils/durable.py``): every byte the port promises to keep.
Checkpoint manifests, tombstones and ``last_good``, the obs ledger, flight
spool and EventLog journals (the quarantine dead-letter journal among
them), the embed cold store's write-back and the capture bundles write
through these functions, and :mod:`fm_spark_tpu_torch.resilience.iofaults`
injects at exactly four points: ``io_write`` (payload bytes),
``io_fsync`` (file and directory fsync), ``io_rename`` (atomic publish)
and ``io_read`` (durable read), each scoped by the PATH CLASS its call
site declares (``ckpt``, ``obs``, ``embed``, ``cache``, ``quarantine``).

The tiers:

- **best-effort** (``best_effort=True``, the observability tier): a
  failed write is counted (``io.write_failed_total`` and
  ``io.write_failed.<class>_total``, the ``obs/io_degraded`` gauge, an
  ``io_write_failed`` flight event) and swallowed; the function returns
  False. Training and serving bytes are unchanged by any number of these
  failures.
- **fail-loud** (the default, the checkpoint tier): the ``OSError``
  propagates after it is counted; the caller owns retry, emergency GC
  and walk-back (:class:`~fm_spark_tpu_torch.checkpoint.Checkpointer`).
- **reads verify, then walk back**: :func:`read_bytes` honours
  ``io_read`` (EIO and short reads); a restore treats a failed or torn
  read as "this generation is bad, walk back", never as a crash loop.

Failures are also counted in an in-process dict
(:func:`io_failure_counts`), so tests can assert on them without a
configured obs plane.
"""

from __future__ import annotations

import json
import os
import threading

__all__ = [
    "append_line",
    "append_line_path",
    "atomic_write_bytes",
    "atomic_write_json",
    "atomic_write_lines",
    "atomic_write_text",
    "fsync_dir",
    "io_failure_counts",
    "read_bytes",
    "read_json",
    "reset_failure_counts",
]

_lock = threading.Lock()
_failures: dict[str, int] = {}

# Lazy iofaults binding: this module is imported from obs internals
# (metrics, flight, introspect) whose package init must not be forced
# through resilience's package init mid-import (the watchdog imports obs
# back). Resolved once, at the first durable operation: by then every
# package involved has finished importing.
_iofaults = None


def _io():
    global _iofaults
    if _iofaults is None:
        from fm_spark_tpu_torch.resilience import iofaults

        _iofaults = iofaults
    return _iofaults

# Reentrancy guard: noting a failure emits a flight event, which
# appends to the spool THROUGH this module — if that append also fails
# (an obs-wide fault window), the inner failure is counted but must not
# recurse into another event emission.
_tls = threading.local()


def io_failure_counts() -> dict:
    """In-process write-failure counts by path class (plus ``total``).
    The registry-free mirror of the ``io.write_failed*`` counters."""
    with _lock:
        out = dict(_failures)
    out.setdefault("total", 0)
    return out


def reset_failure_counts() -> None:
    """Zero the in-process failure mirror (test isolation)."""
    with _lock:
        _failures.clear()


def _note_failure(path_class: "str | None", phase: str,
                  best_effort: bool) -> None:
    cls = path_class or "unscoped"
    with _lock:
        _failures["total"] = _failures.get("total", 0) + 1
        _failures[cls] = _failures.get(cls, 0) + 1
        if best_effort:
            # Best-effort failures are the DEGRADED-mode count (the
            # swallowed ones); fail-loud failures surface to a caller
            # who owns them. Auditors key the gauge contract on this.
            _failures["best_effort"] = _failures.get(
                "best_effort", 0) + 1
    try:
        from fm_spark_tpu_torch import obs

        obs.counter("io.write_failed_total").add(1)
        obs.counter(f"io.write_failed.{cls}_total").add(1)
        if best_effort:
            # The degraded-observability signal: some telemetry since
            # this run started is missing from disk. Sticky by design —
            # a doctor must see that the record has holes even after
            # the disk heals.
            obs.gauge("obs/io_degraded").set(1.0)
        if not getattr(_tls, "noting", False):
            _tls.noting = True
            try:
                obs.event("io_write_failed", path_class=cls,
                          phase=phase, best_effort=bool(best_effort))
            finally:
                _tls.noting = False
    except Exception:
        pass


def _write_payload(f, data: bytes, path_class: "str | None") -> None:
    """One injectable payload write: ``io_write`` may fail it outright
    or tear it after K bytes (the torn tmp is never published — the
    atomic protocol's whole point)."""
    budget = _io().on_write(path_class)
    if budget is not None and budget < len(data):
        f.write(data[:budget])
        f.flush()
        raise OSError(5, f"[iofault] torn write after {budget} bytes")
    f.write(data)


def atomic_write_bytes(path: str, data: bytes, *,
                       path_class: "str | None" = None,
                       best_effort: bool = False,
                       sync_dir: bool = False) -> bool:
    """Write-tmp-fsync-rename: ``data`` is either fully at ``path`` or
    not there at all, never torn. ``sync_dir=True`` additionally fsyncs
    the parent directory after the publish (the rename itself made
    durable — checkpoint pointer writes use this). Returns True on
    success; False only in ``best_effort`` mode."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            _write_payload(f, data, path_class)
            f.flush()
            _io().on_fsync(path_class)
            os.fsync(f.fileno())
        _io().on_rename(path_class)
        os.replace(tmp, path)
        if sync_dir:
            fsync_dir(os.path.dirname(path) or ".", path_class)
    except OSError:
        _note_failure(path_class, "atomic_write", best_effort)
        if best_effort:
            return False
        raise
    return True


def atomic_write_text(path: str, text: str, **kw) -> bool:
    return atomic_write_bytes(path, text.encode("utf-8"), **kw)


def atomic_write_json(path: str, obj, *, default=None, **kw) -> bool:
    return atomic_write_text(path, json.dumps(obj, default=default),
                             **kw)


def atomic_write_lines(path: str, lines, **kw) -> bool:
    """Atomically publish an entire line file (flight-spool
    compaction). The payload is one write — a torn budget tears the
    TMP, never the published file."""
    body = "".join(line.rstrip("\n") + "\n" for line in lines)
    return atomic_write_text(path, body, **kw)


def append_line(fh, line: str, *,
                path_class: "str | None" = None,
                best_effort: bool = False) -> bool:
    """Guarded append of one line to an open handle: the injectable
    form of ``fh.write(line + "\\n"); fh.flush()``. A ``torn_write:K``
    rule really does leave K bytes of a torn line on disk — readers of
    append-only logs must (and do) skip unparseable lines. Returns
    True on success; False only in ``best_effort`` mode."""
    data = line.rstrip("\n") + "\n"
    try:
        budget = _io().on_write(path_class)
        if budget is not None and budget < len(data):
            fh.write(data[:budget])
            fh.flush()
            raise OSError(
                5, f"[iofault] torn append after {budget} bytes")
        fh.write(data)
        fh.flush()
    except (OSError, ValueError):
        # ValueError: write to a closed handle — the append-log
        # equivalent of a dead disk, same degradation path.
        _note_failure(path_class, "append", best_effort)
        if best_effort:
            return False
        raise
    return True


def append_line_path(path: str, line: str, *,
                     path_class: "str | None" = None,
                     best_effort: bool = False) -> bool:
    """Open-append-close form of :func:`append_line` for writers
    without a persistent handle (the perf ledger). Open failures
    (EROFS, EIO at open) take the same accounting path as write
    failures."""
    try:
        fh = open(path, "a")
    except OSError:
        _note_failure(path_class, "open", best_effort)
        if best_effort:
            return False
        raise
    try:
        return append_line(fh, line, path_class=path_class,
                           best_effort=best_effort)
    finally:
        fh.close()


def fsync_dir(path: str, path_class: "str | None" = None) -> None:
    """fsync a DIRECTORY: makes a completed rename itself durable
    (POSIX renames are not, until the containing dir is synced)."""
    _io().on_fsync(path_class)
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_bytes(path: str, *,
               path_class: "str | None" = None) -> bytes:
    """Durable read with ``io_read`` injection: EIO raises, a
    ``torn_write:K`` budget delivers only the first K bytes (a short
    read). Restore-side callers treat both as "walk back", so the
    injection exercises the verify-then-walk-back tier end to end."""
    budget = _io().on_read(path_class)
    with open(path, "rb") as f:
        data = f.read()
    if budget is not None and budget < len(data):
        return data[:budget]
    return data


def read_json(path: str, *, path_class: "str | None" = None):
    return json.loads(read_bytes(path, path_class=path_class))
