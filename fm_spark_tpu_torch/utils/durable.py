"""The durable-write seam (the port's copy of
``fm_spark_tpu/utils/durable.py``, without its fault-injection hooks):
write-tmp-fsync-rename for every byte the checkpoint chain promises to
keep, and reads that the chain's restore treats as "walk back" when they
fail.

Two tiers:

- **fail-loud** (the default, the checkpoint tier): the ``OSError``
  propagates after it is counted; the caller owns retry and walk-back
  (:class:`~fm_spark_tpu_torch.checkpoint.Checkpointer`).
- **best-effort** (``best_effort=True``): a failed write is counted and
  swallowed, and the function returns False.

Failures are counted by path class in an in-process dict
(:func:`io_failure_counts`) and in the ``io.write_failed_total`` counter
of :mod:`fm_spark_tpu_torch.obs`.
"""

from __future__ import annotations

import json
import os
import threading

__all__ = [
    "append_line_path",
    "atomic_write_bytes",
    "atomic_write_json",
    "atomic_write_text",
    "fsync_dir",
    "io_failure_counts",
    "read_bytes",
    "read_json",
    "reset_failure_counts",
]

_lock = threading.Lock()
_failures: dict[str, int] = {}


def io_failure_counts() -> dict:
    """In-process write-failure counts by path class (plus ``total``)."""
    with _lock:
        out = dict(_failures)
    out.setdefault("total", 0)
    return out


def reset_failure_counts() -> None:
    """Zero the in-process failure counts (test isolation)."""
    with _lock:
        _failures.clear()


def _note_failure(path_class: str | None, best_effort: bool) -> None:
    from fm_spark_tpu_torch import obs

    cls = path_class or "unscoped"
    with _lock:
        _failures["total"] = _failures.get("total", 0) + 1
        _failures[cls] = _failures.get(cls, 0) + 1
        if best_effort:
            _failures["best_effort"] = _failures.get("best_effort", 0) + 1
    obs.counter("io.write_failed_total").add(1)
    obs.counter(f"io.write_failed.{cls}_total").add(1)


def atomic_write_bytes(path: str, data: bytes, *,
                       path_class: str | None = None,
                       best_effort: bool = False,
                       sync_dir: bool = False) -> bool:
    """Write-tmp-fsync-rename: ``data`` is either fully at ``path`` or
    not there at all, never torn. ``sync_dir=True`` also fsyncs the
    parent directory after the publish (the rename itself made durable).
    Returns True on success; False only in ``best_effort`` mode."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        if sync_dir:
            fsync_dir(os.path.dirname(path) or ".")
    except OSError:
        _note_failure(path_class, best_effort)
        if best_effort:
            return False
        raise
    return True


def atomic_write_text(path: str, text: str, **kw) -> bool:
    return atomic_write_bytes(path, text.encode("utf-8"), **kw)


def atomic_write_json(path: str, obj, *, default=None, **kw) -> bool:
    return atomic_write_text(path, json.dumps(obj, default=default), **kw)


def append_line_path(path: str, line: str, *,
                     path_class: str | None = None,
                     best_effort: bool = False) -> bool:
    """Append ``line`` and a newline to ``path`` (opened and closed here;
    the perf ledger's writer), flushed and fsynced. Returns True on
    success; False only in ``best_effort`` mode."""
    try:
        with open(path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
    except OSError:
        _note_failure(path_class, best_effort)
        if best_effort:
            return False
        raise
    return True


def fsync_dir(path: str) -> None:
    """fsync a directory: makes a completed rename in it durable (a POSIX
    rename is not, until its directory is synced)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def read_bytes(path: str) -> bytes:
    """The whole file. Restore-side callers treat an ``OSError`` as "this
    generation is bad, walk back", never as a crash loop."""
    with open(path, "rb") as f:
        return f.read()


def read_json(path: str):
    return json.loads(read_bytes(path))
