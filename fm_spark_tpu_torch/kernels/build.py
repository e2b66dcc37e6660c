"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each ``fm_spark_tpu_torch/csrc/<name>.cu`` compiles with ``nvcc`` into a
shared library of its own, with a plain C interface, under
``build/torch_kernels/`` beside the package. The library's file name
carries a hash of its source and the flags, so an edited source is
rebuilt and an unchanged one is reused by every later process. Missing
libraries build in parallel (one ``nvcc`` per source, all started
together). A build or load that fails raises :class:`KernelBuildError`
with the compiler's output; nothing falls back to another path.

Pointers and the stream cross into C as ``ctypes.c_void_p`` (a bare
Python int would be cut to 32 bits), integers as ``ctypes.c_int`` or
``c_longlong``, scalars as ``c_float``. Headers (``csrc/*.cuh``) shared by
several sources enter every library's hash.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

__all__ = ["BUILD_DIR", "KernelBuildError", "build_all", "build_logs", "load"]

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_float)
#: C entry points of each library: {library: {function: (restype, argtypes)}}.
SIGNATURES = {
    "fm_fused_fwd": {
        # tables (host array), tables (device array or null), F, bucket,
        # width, is_bf16, cd_bf16, ids, vals, batch, w0, use_linear,
        # scores, acc, stream, device
        "fm_fused_fwd": (_I, [_P, _P, _I, _I, _I, _I, _I, _P, _P, _I, _P,
                              _I, _P, _P, _P, _I]),
        "fm_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "segment_totals": {
        # delta, delta_bf16, order (or null), order_i64, seg, batch, width,
        # cap, zero_tail, out, scratch_seg, scratch_val, scratch_rows,
        # stream, device
        "segment_totals": (_I, [_P, _I, _P, _I, _P, _I, _I, _I, _I, _P, _P,
                                _P, _L, _P, _I]),
        "segment_scratch_rows": (_L, [_I]),
        "segment_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "fm_fused_bwd": {
        # urows, F, cap, width, store_bf16, cd_bf16, order, inv, s1, ds,
        # vals, vals_t, weights, batch, neg_lr (device), use_rv, rv_factors,
        # rv_linear, out, scratch_seg, scratch_val, scratch_rows, stream,
        # device
        "fm_fused_bwd": (_I, [_P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                              _P, _P, _I, _P, _I, _F, _F, _P, _P, _P, _L,
                              _P, _I]),
        "fm_bwd_scratch_rows": (_L, [_I]),
        "fm_bwd_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "sr_bits": {
        # step (device int32), seed, field, count, out, stream, device
        "sr_bits": (_I, [_P, ctypes.c_uint, ctypes.c_uint, _L, _P, _P, _I]),
        "sr_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "ffm_sel": {
        # rows, vals, out, batch, fields, rank, is_bf16, stream, device
        "ffm_sel_fwd": (_I, [_P, _P, _P, _I, _I, _I, _I, _P, _I]),
        # rows, vals, dscores, out, batch, fields, rank, is_bf16, stream,
        # device
        "ffm_sel_bwd": (_I, [_P, _P, _P, _P, _I, _I, _I, _I, _P, _I]),
        "ffm_sel_smem_bytes": (_L, [_I, _I, _I]),
        "ffm_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
    "rows": {
        # table, n, width, elem, ids, batch, out, magic, shift, stream,
        # device
        "rows_gather": (_I, [_P, _L, _I, _I, _P, _I, _P, ctypes.c_uint, _I,
                             _P, _I]),
        # table, n, width, table_bf16, ids, valid, delta, delta_bf16, batch,
        # count (or null), magic, shift, stream, device
        "rows_update_add": (_I, [_P, _L, _I, _I, _P, _P, _P, _I, _I, _P,
                                 ctypes.c_uint, _I, _P, _I]),
        "rows_cuda_error_string": (ctypes.c_char_p, [_I]),
    },
}


class KernelBuildError(RuntimeError):
    """A kernel library could not be compiled or loaded."""


_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
#: Compiler output of each library built by this process (the
#: ``-Xptxas -v`` register and spill report), by library name.
build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise KernelBuildError(
        "nvcc not found on PATH or at /usr/local/cuda/bin; the CUDA "
        "kernels build on a machine with the CUDA toolkit")


def _sources() -> dict[str, str]:
    return {f[:-3]: os.path.join(CSRC_DIR, f)
            for f in sorted(os.listdir(CSRC_DIR)) if f.endswith(".cu")}


def _lib_path(name: str, src: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(os.path.join(CSRC_DIR, f) for f in os.listdir(CSRC_DIR)
                     if f.endswith(".cuh"))
    for path in (src, *headers):
        with open(path, "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}.{h.hexdigest()[:16]}.so")


def build_all() -> dict[str, str]:
    """Compile every kernel library that is not built yet; return
    ``{name: library path}`` for all of them."""
    paths = {name: _lib_path(name, src) for name, src in _sources().items()}
    with _lock:
        todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
        if not todo:
            return paths
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        procs = {}
        for name, path in todo.items():
            tmp = f"{path}.{os.getpid()}.tmp"
            procs[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", tmp, _sources()[name]],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                tmp, path)
        failures = []
        for name, (proc, tmp, path) in procs.items():
            out, _ = proc.communicate()
            build_logs[name] = out
            if proc.returncode != 0:
                failures.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
                continue
            # Atomic publish: a concurrent process sees no library or a
            # whole one.
            os.replace(tmp, path)
        if failures:
            raise KernelBuildError("kernel build failed:\n" + "\n".join(failures))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The bound library ``name`` (built first if needed)."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    path = build_all()[name]
    with _lock:
        if name not in _libs:
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            for fn, (restype, argtypes) in SIGNATURES[name].items():
                cfn = getattr(lib, fn)
                cfn.restype = restype
                cfn.argtypes = argtypes
            _libs[name] = lib
        return _libs[name]
