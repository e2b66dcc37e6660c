"""The host's native libraries, built with ``g++`` at first use and bound
with ctypes:

- ``aux.cpp``, the aux builders of the sparse-SGD steps: the port's copy
  of ``fm_dedup_aux`` and ``fm_compact_aux`` of
  ``fm_spark_tpu/native/fasthash.cpp``;
- ``fasthash.cpp``, the preprocessing kernels: murmur3 hashing of tokens
  and integer keys, the Criteo text parser, the packed batch's row
  gather and the raw-text stream's chunk-row parsers
  (``fm_parse_{criteo,avazu,libsvm}_rows``, :func:`parse_stream_chunk`;
  the port's copy of the reference's other symbols).

Each library compiles with ``g++ -O3 -shared -fPIC -pthread`` into
``build/torch_native/`` beside the package, its file name carrying a
hash of the source and the flags, so an edited source is rebuilt and an
unchanged one is reused by every later process. A build or load that
fails raises :class:`NativeBuildError` with the compiler's output;
nothing falls back to another path. The numpy versions
(``data/hashing.py``, ``data/criteo.parse_lines``,
``data/packed.PackedDataset.assemble(use_native=False)``) give the same
ints and run only where a caller asks for them.

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

__all__ = ["BUILD_DIR", "CRITEO_FIELDS", "NativeBuildError", "STREAM_FIELDS",
           "STREAM_OK", "STREAM_REPARSE", "STREAM_SKIP", "compact_aux",
           "counting_sort_fits", "dedup_aux", "gather_rows",
           "hash_tokens_batch", "hash_u64_batch", "load", "load_fast",
           "murmur3_32", "parse_criteo_chunk", "parse_stream_chunk",
           "stream_parse_available"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "aux.cpp")
_FAST_SRC = os.path.join(_HERE, "fasthash.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "build", "torch_native")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

#: Aggregate O(bucket) scratch entries (int64) the worker threads may hold.
COUNTING_SORT_MAX_BUCKET = 1 << 27

_P, _I32, _I64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {
    # ids, B, F, bucket, order, seg, useg, ord_first
    "fmt_dedup_aux": (None, [_P, _I64, _I32, _I32, _P, _P, _P, _P]),
    # ids, B, F, bucket, cap, useg, segstart, segend, order, inv
    "fmt_compact_aux": (_I32, [_P, _I64, _I32, _I32, _I32, _P, _P, _P, _P,
                               _P]),
}
_FAST_SIGNATURES = {
    # data, len, seed
    "fm_murmur3_32": (ctypes.c_uint32, [ctypes.c_char_p, _I64,
                                        ctypes.c_uint32]),
    # buf, offsets, n, fields, bucket, per_field, out
    "fm_hash_bytes_batch": (None, [ctypes.c_char_p, _P, _I64, _P, _I32, _INT,
                                   _P]),
    # keys, n, fields, bucket, per_field, out
    "fm_hash_u64_batch": (None, [_P, _I64, _P, _I32, _INT, _P]),
    # buf, len, bucket, per_field, max_rows, ids, labels, consumed, bad_pos
    "fm_parse_criteo": (_I64, [ctypes.c_char_p, _I64, _I32, _INT, _I64, _P,
                               _P, _P, _P]),
    # ids, vals, labels, sel, B, F, bucket, n_threads, out ids/vals/labels
    "fm_gather_rows": (None, [_P, _P, _P, _P, _I64, _I32, _I32, _INT, _P, _P,
                              _P]),
    # buf, len, bucket, per_field, num_features, max_rows, ids, labels,
    # status, rowlen
    "fm_parse_criteo_rows": (_I64, [ctypes.c_char_p, _I64, _I32, _INT, _I64,
                                    _I64, _P, _P, _P, _P]),
    "fm_parse_avazu_rows": (_I64, [ctypes.c_char_p, _I64, _I32, _INT, _I64,
                                   _I64, _P, _P, _P, _P]),
    # buf, len, zero_based, max_nnz, num_features, max_rows, ids, vals,
    # labels, status, rowlen
    "fm_parse_libsvm_rows": (_I64, [ctypes.c_char_p, _I64, _INT, _I64, _I64,
                                    _I64, _P, _P, _P, _P, _P]),
}


class NativeBuildError(RuntimeError):
    """A native library could not be compiled or loaded."""


_lock = threading.Lock()
_lib = None          # aux.cpp
_fast = None         # fasthash.cpp


def _gxx() -> str:
    found = shutil.which("g++")
    if not found:
        raise NativeBuildError("g++ not found on PATH; the native libraries "
                               "compile at first use")
    return found


def _lib_path(src: str) -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(src, "rb") as fh:
        h.update(fh.read())
    stem = os.path.splitext(os.path.basename(src))[0]
    from fm_spark_tpu_torch.utils import compile_cache

    return os.path.join(compile_cache.dir_for("torch_native", BUILD_DIR),
                        f"{stem}.{h.hexdigest()[:16]}.so")


def _build(src: str, path: str) -> None:
    """Compile ``src`` into ``path`` under the build directory's lock (a
    process that waited for another's build finds the library and builds
    nothing), publishing it atomically."""
    from fm_spark_tpu_torch.utils import compile_cache

    with compile_cache.build_lock(os.path.dirname(path)):
        compile_cache.note(path, hit=os.path.exists(path))
        if os.path.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run([_gxx(), *GXX_FLAGS, src, "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise NativeBuildError(
                f"native build of {os.path.basename(src)} failed: g++ exited "
                f"{proc.returncode}\n{proc.stdout}{proc.stderr}")
        # Atomic publish: a concurrent process sees no library or a whole
        # one.
        os.replace(tmp, path)


def _build_and_bind(src: str, signatures: dict) -> ctypes.CDLL:
    from fm_spark_tpu_torch.utils import compile_cache

    path = _lib_path(src)
    if os.path.exists(path):
        compile_cache.note(path, hit=True)
    else:
        _build(src, path)
    try:
        lib = ctypes.CDLL(path)
    except OSError as e:
        raise NativeBuildError(f"cannot load {path}: {e}") from e
    for fn, (restype, argtypes) in signatures.items():
        cfn = getattr(lib, fn)
        cfn.restype = restype
        cfn.argtypes = argtypes
    return lib


def load() -> ctypes.CDLL:
    """The bound aux library (built first if needed)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            _lib = _build_and_bind(_SRC, _SIGNATURES)
        return _lib


def load_fast() -> ctypes.CDLL:
    """The bound preprocessing library (built first if needed)."""
    global _fast
    if _fast is not None:
        return _fast
    with _lock:
        if _fast is None:
            _fast = _build_and_bind(_FAST_SRC, _FAST_SIGNATURES)
        return _fast


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


# ------------------------------------------------------ preprocessing

#: Hashed fields of a Criteo row (13 integer counts, 26 categoricals).
CRITEO_FIELDS = 39


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """MurmurHash3 x86_32 of ``data`` (``hashing.murmur3_32``)."""
    return int(load_fast().fm_murmur3_32(data, len(data), seed))


def hash_tokens_batch(tokens: list[bytes], fields: np.ndarray, bucket: int,
                      per_field: bool = True) -> np.ndarray:
    """``hashing.hash_tokens_batch`` in one native call: int64 ids."""
    lib = load_fast()
    buf = b"".join(tokens)
    offsets = np.zeros(len(tokens) + 1, np.int64)
    np.cumsum([len(t) for t in tokens], out=offsets[1:])
    fields32 = np.ascontiguousarray(fields, np.int32)
    if fields32.shape != (len(tokens),):
        raise ValueError(f"fields {fields32.shape} != ({len(tokens)},)")
    out = np.empty(len(tokens), np.int64)
    lib.fm_hash_bytes_batch(buf, offsets.ctypes.data, len(tokens),
                            fields32.ctypes.data, int(bucket), int(per_field),
                            out.ctypes.data)
    return out


def hash_u64_batch(keys: np.ndarray, fields: np.ndarray, bucket: int,
                   per_field: bool = True) -> np.ndarray:
    """u64 keys hashed per field (``hashing.murmur3_u64`` % bucket, plus
    ``field * bucket`` with ``per_field``): int64 ids."""
    lib = load_fast()
    keys = np.ascontiguousarray(keys, np.uint64)
    fields32 = np.ascontiguousarray(fields, np.int32)
    if keys.ndim != 1 or fields32.shape != keys.shape:
        raise ValueError(f"keys {keys.shape} and fields {fields32.shape} "
                         "must be one matching vector")
    out = np.empty(keys.shape[0], np.int64)
    lib.fm_hash_u64_batch(keys.ctypes.data, keys.shape[0],
                          fields32.ctypes.data, int(bucket), int(per_field),
                          out.ctypes.data)
    return out


def parse_criteo_chunk(chunk: bytes, bucket: int, per_field: bool = True):
    """Parse the complete lines of a Criteo TSV chunk: ``(ids [N, 39]
    int32, labels [N] int8, consumed_bytes)``; the bytes after the last
    newline are not consumed (feed them back with the next chunk). A
    malformed line raises ``ValueError`` with its line number in the
    chunk."""
    lib = load_fast()
    max_rows = chunk.count(b"\n")
    ids = np.empty((max_rows, CRITEO_FIELDS), np.int32)
    labels = np.empty(max_rows, np.int8)
    consumed = ctypes.c_int64(0)
    bad_pos = ctypes.c_int64(-1)
    n = lib.fm_parse_criteo(chunk, len(chunk), int(bucket), int(per_field),
                            max_rows, ids.ctypes.data, labels.ctypes.data,
                            ctypes.byref(consumed), ctypes.byref(bad_pos))
    if bad_pos.value >= 0:
        lineno = chunk[: bad_pos.value].count(b"\n") + 1
        snippet = chunk[bad_pos.value: bad_pos.value + 60]
        raise ValueError(
            f"malformed criteo line (chunk line {lineno}): {snippet!r}")
    return ids[:n], labels[:n], int(consumed.value)


def gather_rows(ids: np.ndarray, vals, labels: np.ndarray, sel: np.ndarray,
                bucket: int = 0, n_threads: int = 0):
    """The packed batch's fused assembly (``fm_gather_rows``): rows
    ``sel`` of the ``[N, F]`` int32 id table (and of the float32 vals
    table, when given), field-local (``id - f * bucket``) when
    ``bucket > 0``, and the int8 labels as float32, in one threaded pass.
    Returns ``(ids, vals, labels)``, ``vals`` None when none was given.
    Raises ``ValueError`` on what the kernel does not take (another
    dtype, a strided table, a row out of range): it checks no bounds."""
    if ids.dtype != np.int32 or labels.dtype != np.int8 or (
            vals is not None and vals.dtype != np.float32):
        raise ValueError("gather_rows takes int32 ids, int8 labels and "
                         "float32 vals")
    if not (ids.flags.c_contiguous and labels.flags.c_contiguous
            and (vals is None or vals.flags.c_contiguous)):
        raise ValueError("gather_rows takes C-contiguous tables")
    sel = np.ascontiguousarray(sel, np.int64)
    b = sel.shape[0]
    f = ids.shape[1]
    if b and (int(sel.min()) < 0 or int(sel.max()) >= ids.shape[0]):
        raise ValueError(f"rows out of range [0, {ids.shape[0]})")
    lib = load_fast()
    out_ids = np.empty((b, f), np.int32)
    out_vals = np.empty((b, f), np.float32) if vals is not None else None
    out_labels = np.empty((b,), np.float32)
    lib.fm_gather_rows(ids.ctypes.data,
                       vals.ctypes.data if vals is not None else None,
                       labels.ctypes.data, sel.ctypes.data, b, f, int(bucket),
                       int(n_threads), out_ids.ctypes.data,
                       out_vals.ctypes.data if out_vals is not None else None,
                       out_labels.ctypes.data)
    return out_ids, out_vals, out_labels


# -------------------------------------------------- streaming chunk parse

#: Per-row status codes of the chunk-row parsers: an OK row equals the
#: per-line Python parse bit for bit and passes the record guard's value
#: contract; a SKIP row carries no record (blank, or a libsvm comment
#: line); a REPARSE row goes back through the per-line Python parser, so
#: every verdict and reason is the Python path's.
STREAM_OK, STREAM_SKIP, STREAM_REPARSE = 0, 1, 2

_STREAM_SYMBOLS = {
    "criteo": "fm_parse_criteo_rows",
    "avazu": "fm_parse_avazu_rows",
    "libsvm": "fm_parse_libsvm_rows",
}

#: Hashed fields per fixed-field dataset (``data/criteo.py`` and
#: ``data/avazu.py``'s ``NUM_FIELDS``; the data layer imports this module).
STREAM_FIELDS = {"criteo": 39, "avazu": 23}


def stream_parse_available(dataset: str) -> bool:
    """Whether ``dataset`` has a chunk-row parser. The library is built
    (or loaded) to answer; a build that fails raises
    :class:`NativeBuildError`."""
    if dataset not in _STREAM_SYMBOLS:
        return False
    load_fast()
    return True


def parse_stream_chunk(dataset: str, chunk: bytes, *, bucket: int = 0,
                       per_field: bool = True, num_features: int = 0,
                       max_nnz: int = 0, zero_based: bool = False):
    """Parse every line of ``chunk`` (which ends on a newline) for the
    raw-text stream (``data/native_stream.py``). Returns ``(ids, vals,
    labels, status, rowlen)``: ``ids`` int32 ``[n_lines, F]`` (``F =
    max_nnz`` for libsvm, the dataset's field count otherwise), ``vals``
    float32 ``[n_lines, max_nnz]`` for libsvm and None for the all-ones
    criteo/avazu rows, ``labels`` float32, ``status`` uint8 per
    :data:`STREAM_OK` / :data:`STREAM_SKIP` / :data:`STREAM_REPARSE`, and
    ``rowlen`` int64, each line's bytes with its newline (what the
    exactly-once cursor advances by)."""
    sym = _STREAM_SYMBOLS.get(dataset)
    if sym is None:
        raise ValueError(f"no chunk-row parser for {dataset!r}")
    lib = load_fast()
    n = chunk.count(b"\n")
    status = np.empty(n, np.uint8)
    rowlen = np.empty(n, np.int64)
    labels = np.empty(n, np.float32)
    if dataset == "libsvm":
        s = int(max_nnz)
        if s < 1:
            raise ValueError(f"max_nnz must be >= 1, got {max_nnz}")
        ids = np.empty((n, s), np.int32)
        vals = np.empty((n, s), np.float32)
        got = lib.fm_parse_libsvm_rows(
            chunk, len(chunk), int(zero_based), s, int(num_features), n,
            ids.ctypes.data, vals.ctypes.data, labels.ctypes.data,
            status.ctypes.data, rowlen.ctypes.data)
    else:
        f = STREAM_FIELDS[dataset]
        if per_field and f * int(bucket) > np.iinfo(np.int32).max:
            raise ValueError(f"id space {f}*{bucket} overflows int32 ids")
        ids = np.empty((n, f), np.int32)
        vals = None
        got = getattr(lib, sym)(
            chunk, len(chunk), int(bucket), int(per_field),
            int(num_features), n, ids.ctypes.data, labels.ctypes.data,
            status.ctypes.data, rowlen.ctypes.data)
    if got != n:
        raise RuntimeError(
            f"native {dataset} chunk parse scanned {got} of {n} lines: the "
            "chunk did not end on a line boundary")
    return ids, vals, labels, status, rowlen
