"""The host's native aux builders (``native/aux.cpp``), built with ``g++`` at
first use and bound with ctypes: the port's copy of ``fm_dedup_aux`` and
``fm_compact_aux`` of ``fm_spark_tpu/native/fasthash.cpp``.

The library compiles with ``g++ -O3 -shared -fPIC -pthread`` into
``build/torch_native/`` beside the package, its file name carrying a hash
of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused by every later process. A build or load that
fails raises :class:`NativeBuildError` with the compiler's output; nothing
falls back to another path.

:func:`counting_sort_fits` is the size rule of the reference
(``native._counting_sort_fits``): each worker thread holds an
``O(bucket)`` scratch vector, so above ``2**27`` entries in all the
callers (``ops.scatter.dedup_aux`` and ``compact_aux``) take the numpy
builder instead, which gives the same ints.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

__all__ = ["BUILD_DIR", "NativeBuildError", "compact_aux",
           "counting_sort_fits", "dedup_aux", "load"]

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "aux.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "torch_native")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

#: Aggregate O(bucket) scratch entries (int64) the worker threads may hold.
COUNTING_SORT_MAX_BUCKET = 1 << 27

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_SIGNATURES = {
    # ids, B, F, bucket, order, seg, useg, ord_first
    "fmt_dedup_aux": (None, [_P, _I64, _I32, _I32, _P, _P, _P, _P]),
    # ids, B, F, bucket, cap, useg, segstart, segend, order, inv
    "fmt_compact_aux": (_I32, [_P, _I64, _I32, _I32, _I32, _P, _P, _P, _P,
                               _P]),
}


class NativeBuildError(RuntimeError):
    """The native aux library could not be compiled or loaded."""


_lock = threading.Lock()
_lib = None


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise NativeBuildError("g++ not found on PATH; the native aux "
                               "builder compiles at first use")
    return found


def _lib_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(_SRC, "rb") as fh:
        h.update(fh.read())
    return os.path.join(BUILD_DIR, f"aux.{h.hexdigest()[:16]}.so")


def load() -> ctypes.CDLL:
    """The bound library (built first if needed)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = _lib_path()
        if not os.path.exists(path):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            proc = subprocess.run([_gxx(), *GXX_FLAGS, _SRC, "-o", tmp],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise NativeBuildError(
                    f"native aux build failed: g++ exited {proc.returncode}"
                    f"\n{proc.stdout}{proc.stderr}")
            # Atomic publish: a concurrent process sees no library or a
            # whole one.
            os.replace(tmp, path)
        try:
            lib = ctypes.CDLL(path)
        except OSError as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        for fn, (restype, argtypes) in _SIGNATURES.items():
            cfn = getattr(lib, fn)
            cfn.restype = restype
            cfn.argtypes = argtypes
        _lib = lib
        return _lib


def counting_sort_fits(bucket: int, fields: int) -> bool:
    """Whether the counting sort's scratch, one ``O(bucket)`` vector per
    worker thread (``min(fields, cores)`` of them), stays within
    :data:`COUNTING_SORT_MAX_BUCKET` entries."""
    n_threads = max(1, min(fields, os.cpu_count() or 1))
    return bucket * n_threads <= COUNTING_SORT_MAX_BUCKET


def dedup_aux(ids: np.ndarray, bucket: int):
    """``(order, seg, useg, ord_first)``, int32 ``[F, B]``, of a ``[B, F]``
    batch of ids in ``[0, bucket)`` (``ops.scatter.dedup_aux``'s
    contract; the caller checks the ids)."""
    lib = load()
    ids = np.ascontiguousarray(ids, np.int32)
    b, f = ids.shape
    out = tuple(np.empty((f, b), np.int32) for _ in range(4))
    lib.fmt_dedup_aux(ids.ctypes.data, b, f, int(bucket),
                      *(a.ctypes.data for a in out))
    return out


def compact_aux(ids: np.ndarray, bucket: int, cap: int):
    """``(aux, over)`` for a ``[B, F]`` batch of ids in ``[0, bucket)`` at
    ``cap``: ``aux = (useg, segstart, segend, order, inv)``
    (``ops.scatter.compact_aux``'s contract) and ``over`` the lowest field
    whose unique count exceeds ``cap``, or -1. After an overflow ``aux``
    is not to be used."""
    lib = load()
    ids = np.ascontiguousarray(ids, np.int32)
    b, f = ids.shape
    useg, segstart, segend = (np.empty((f, cap), np.int32) for _ in range(3))
    order, inv = (np.empty((f, b), np.int32) for _ in range(2))
    over = lib.fmt_compact_aux(ids.ctypes.data, b, f, int(bucket), int(cap),
                               useg.ctypes.data, segstart.ctypes.data,
                               segend.ctypes.data, order.ctypes.data,
                               inv.ctypes.data)
    return (useg, segstart, segend, order, inv), int(over)
