"""The kernel build cache: the warm-start fast path of the port (the
counterpart of ``fm_spark_tpu/utils/compile_cache.py``).

The reference caches XLA executables. The port's "compile" is the
``nvcc`` build of each ``csrc/*.cu`` kernel library
(:mod:`fm_spark_tpu_torch.kernels.build`) and the ``g++`` build of the
native host libraries (:mod:`fm_spark_tpu_torch.native`). Both are
already keyed by a hash of their source and flags and published
atomically, so a library built once is loaded, not rebuilt, by every
later process that looks in the same directory. This module is the one
switch that points both builds at a shared cache directory, and the one
place that counts what they did:

- :func:`enable` points the kernel builds at ``<dir>/torch_kernels`` and
  the native builds at ``<dir>/torch_native`` (and writes
  ``cache_meta.json``, which process enabled it, through the durable
  seam's ``cache`` path class);
- :func:`enable_from_env` is the zero-flag wiring:
  ``FM_SPARK_COMPILE_CACHE=<dir>`` (or ``=1`` for the default dir)
  turns it on without touching any call site;
- :func:`cache_stats` counts the libraries this process asked for
  (``requests``), those found built (``hits``) and those it built
  (``misses``, the fresh compiles), with the entries and bytes on disk,
  so a test asserts the warm-start contract, "a warm process builds
  nothing", instead of trusting the wall clock.

Without :func:`enable` the builds go to the repository's ``build/``
directories, which are a cache of the same kind, so the counters run
either way (the reference counts only with its cache on). A CUDA graph
cannot be cached across processes: it holds device pointers of the
process that captured it. So every process captures its graphs anew,
and the serving line counts those as ``captures``, apart from the
``fresh_compiles`` counted here.
"""

from __future__ import annotations

import contextlib
import fcntl
import os
import threading

__all__ = [
    "DEFAULT_ENV",
    "build_lock",
    "cache_stats",
    "default_cache_dir",
    "dir_for",
    "enable",
    "enable_from_env",
    "is_enabled",
    "note",
    "reset_stats",
]

#: Environment switch read by :func:`enable_from_env`: a directory path,
#: or ``1``/``true`` for :func:`default_cache_dir`.
DEFAULT_ENV = "FM_SPARK_COMPILE_CACHE"

# Repo root = two levels above the package (utils/ -> fm_spark_tpu_torch/
# -> repo): repo-local, beside the default build dirs.
_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(_REPO_ROOT, "build", "compile_cache")

#: The build kinds and their subdirectories of the cache.
KINDS = ("torch_kernels", "torch_native")

_lock = threading.Lock()
_state = {"dir": None, "hits": 0, "requests": 0}
_seen: set = set()       # library paths this process has asked for


def default_cache_dir() -> str:
    """The cache directory used when none is given: ``$FM_SPARK_COMPILE_
    CACHE`` if it names a path, else ``<repo>/build/compile_cache``.
    Boolean spellings (on OR off) are switches, never paths."""
    env = os.environ.get(DEFAULT_ENV, "").strip()
    if env and env.lower() not in ("1", "true", "yes", "on",
                                   "0", "false", "no", "off"):
        return env
    return DEFAULT_DIR


def enable(cache_dir: str | None = None) -> str:
    """Point the kernel and native builds at ``cache_dir`` (default:
    :func:`default_cache_dir`). Idempotent; returns the resolved
    absolute path. Libraries this process already loaded stay loaded;
    every later build or load looks in the cache."""
    path = os.path.abspath(cache_dir or default_cache_dir())
    for kind in KINDS:
        os.makedirs(os.path.join(path, kind), exist_ok=True)
    from fm_spark_tpu_torch.utils import durable

    import torch

    durable.atomic_write_json(
        os.path.join(path, "cache_meta.json"),
        {"dir": path, "pid": os.getpid(), "torch_version": torch.__version__,
         "cuda": torch.version.cuda},
        path_class="cache", best_effort=True)
    with _lock:
        _state["dir"] = path
    return path


def enable_from_env() -> str | None:
    """Enable the cache iff ``FM_SPARK_COMPILE_CACHE`` is set (a path, or
    ``1`` for the default dir; ``0/false/no/off`` mean OFF); returns the
    dir or None."""
    val = os.environ.get(DEFAULT_ENV, "").strip()
    if not val or val.lower() in ("0", "false", "no", "off"):
        return None
    return enable()


def is_enabled() -> bool:
    return _state["dir"] is not None


def dir_for(kind: str, default: str) -> str:
    """Where the builds of ``kind`` (one of :data:`KINDS`) go: the
    cache's subdirectory when the cache is on, else ``default``."""
    d = _state["dir"]
    return default if d is None else os.path.join(d, kind)


@contextlib.contextmanager
def build_lock(directory: str):
    """An exclusive lock on ``directory`` across processes (``flock`` of
    its ``.build.lock``): a build holds it from its check for the
    library to the library's publish, so of two processes that need
    the same library one builds it and the other, waiting here, finds
    it built. The kernel is what releases it, so a process that dies
    holding it leaves no stale lock."""
    os.makedirs(directory, exist_ok=True)
    fd = os.open(os.path.join(directory, ".build.lock"),
                 os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)


def note(path: str, hit: bool) -> None:
    """Count one library this process asked for: ``hit`` when it was
    found built at ``path``, else a fresh build. A library counts once
    per process, however often it is looked up."""
    with _lock:
        if path in _seen:
            return
        _seen.add(path)
        _state["requests"] += 1
        _state["hits"] += int(bool(hit))


def reset_stats() -> None:
    """Zero the in-process counters (the entries on disk stay); a
    library asked for again after this counts again."""
    with _lock:
        _state["hits"] = 0
        _state["requests"] = 0
        _seen.clear()


def cache_stats() -> dict:
    """Counters and the footprint on disk::

        {"enabled": bool, "dir": str|None,
         "requests": int, "hits": int, "misses": int,
         "entries": int, "bytes": int}

    ``misses`` = libraries this process built (fresh compiles); the
    warm-start contract is ``misses == 0`` on a populated cache.
    ``entries`` counts the built libraries (``*.so``) in the cache."""
    with _lock:
        d = _state["dir"]
        hits, requests = _state["hits"], _state["requests"]
    entries = nbytes = 0
    if d and os.path.isdir(d):
        for root, _dirs, files in os.walk(d):
            for f in files:
                if not f.endswith(".so"):
                    continue
                entries += 1
                try:
                    nbytes += os.path.getsize(os.path.join(root, f))
                except OSError:
                    pass
    return {"enabled": d is not None, "dir": d, "requests": requests,
            "hits": hits, "misses": max(0, requests - hits),
            "entries": entries, "bytes": nbytes}
