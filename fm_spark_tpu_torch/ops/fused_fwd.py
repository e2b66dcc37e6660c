"""Fused gather → FM-interaction forward: the CUDA kernel's wrapper and
its plain PyTorch version.

The port of ``fm_spark_tpu/ops/pallas_fused.py::fm_fused_scores``. The
kernel (``csrc/fm_fused_fwd.cu``) sums all fields inside one launch, at
any width and field count, in one of two forms the launcher picks per
call: rows staged in shared memory by 16-byte chunks (bf16 tables, small
batches, wide rows, many fields), or one warp per sample reading single
elements (fp32 tables of ≤ 128 columns and ≤ 64 fields at batches of at
least 4 rows per SM, 528 on an H100); see the source for the design and
bound.
:func:`fm_fused_scores` launches it for CUDA tensors and runs
:func:`fm_fused_scores_plain` only for tensors on the CPU — a tensor on
another device raises :class:`~fm_spark_tpu_torch.ops.KernelUnavailable`.
Above :data:`PARAM_FIELDS` fields the table pointers go to the card in a
device array, staged once per set of table addresses
(:func:`stage_table_pointers`) by the first call outside a capture, so a
CUDA graph's capture of a later call records no copy from the host; a
capture whose pointers were never staged refuses
(``KernelUnavailable``) rather than record a copy it cannot replay.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from fm_spark_tpu_torch.ops import KernelUnavailable, note_recorded

__all__ = ["PARAM_FIELDS", "fm_fused_scores", "fm_fused_scores_plain",
           "launches", "stage_table_pointers"]

#: Fields whose table pointers travel in the kernel's parameter space
#: (FM_PARAM_FIELDS in the source); above it they go in a device array.
PARAM_FIELDS = 64

#: Kernel launches made by :func:`fm_fused_scores` in this process.
#: A call that a CUDA graph records is no launch: the graph's replays
#: launch the kernel, past the wrapper.
launches = 0
_launch_lock = threading.Lock()

#: The staged pointer arrays, by (device, table addresses). An array holds
#: its key, so it stays right for whatever tables later live at those
#: addresses; the arrays are kept for the life of the process, because a
#: captured graph reads its array at every replay (8 bytes per field for
#: each set of addresses ever served).
_staged: dict = {}
_staged_lock = threading.Lock()


def _check(tables, ids, vals, w0):
    if ids.dim() != 2 or ids.shape != vals.shape:
        raise KernelUnavailable(f"want matching [B, F] ids/vals, got "
                         f"{tuple(ids.shape)} / {tuple(vals.shape)}")
    b, num_fields = ids.shape
    if b < 1:
        raise KernelUnavailable("empty batch")
    if len(tables) != num_fields:
        raise KernelUnavailable(f"{len(tables)} tables for {num_fields} fields")
    if ids.dtype != torch.int32 or vals.dtype != torch.float32:
        raise TypeError(f"want int32 ids and float32 vals, got {ids.dtype} "
                        f"/ {vals.dtype}")
    shape, dtype = tables[0].shape, tables[0].dtype
    if len(shape) != 2 or shape[1] < 2:
        raise KernelUnavailable(f"want [bucket, k+1] tables, got {tuple(shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"table storage must be float32 or bfloat16, got {dtype}")
    dev = ids.device
    for t in tables:
        if t.shape != shape or t.dtype != dtype:
            raise KernelUnavailable("every field table must share one shape and dtype")
        if t.device != dev:
            raise KernelUnavailable(f"table on {t.device}, ids on {dev}")
    if vals.device != dev:
        raise KernelUnavailable(f"vals on {vals.device}, ids on {dev}")
    if w0 is not None and (w0.numel() != 1 or w0.dtype != torch.float32
                           or w0.device != dev):
        raise KernelUnavailable("w0 must be one float32 value on the ids' device")


def _capturing() -> bool:
    """Is a CUDA graph capturing on this thread's current stream?"""
    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def stage_table_pointers(tables) -> torch.Tensor:
    """The int64 array of ``tables``' addresses on their device, staged
    (copied from the host) at the first call for this set of addresses
    and reused after. Under a capture an unstaged set raises
    :class:`KernelUnavailable`: the copy could not be replayed."""
    dev = tables[0].device
    addrs = tuple(t.data_ptr() for t in tables)
    key = (str(dev), addrs)
    with _staged_lock:
        ptrs = _staged.get(key)
    if ptrs is not None:
        return ptrs
    if _capturing():
        raise KernelUnavailable(
            f"fm_fused_scores: the pointers of {len(addrs)} fields > "
            f"{PARAM_FIELDS} tables are not staged on the card; a call "
            "outside the capture stages them")
    ptrs = torch.tensor(addrs, dtype=torch.int64, device=dev)
    with _staged_lock:
        return _staged.setdefault(key, ptrs)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fm_fused_scores_plain(tables, ids, vals, *, use_linear: bool = True,
                          w0=None, compute_bf16: bool = False):
    """Plain PyTorch version: per-field indexing and the same math as the
    kernel (fp32 accumulation; with ``compute_bf16`` the row, x, each
    x·row product and w0 rounded to bf16 first). Returns
    ``(scores [B], acc [B, k+1])``."""
    tables = list(tables)
    bucket, w = tables[0].shape
    k = w - 1
    rnd = _round_bf16 if compute_bf16 else (lambda x: x)
    acc = torch.zeros(ids.shape[0], w, dtype=torch.float32, device=ids.device)
    ssq = torch.zeros(ids.shape[0], dtype=torch.float32, device=ids.device)
    for f, table in enumerate(tables):
        idx = ids[:, f].clamp(0, bucket - 1).long()
        xv = rnd(rnd(table[idx].float()) * rnd(vals[:, f:f + 1].float()))
        acc += xv
        ssq += (xv[:, :k] * xv[:, :k]).sum(dim=1)
    s = acc[:, :k]
    scores = 0.5 * ((s * s).sum(dim=1) - ssq)
    if use_linear:
        scores = scores + acc[:, k]
    if w0 is not None:
        scores = scores + rnd(w0.reshape(()).float())
    return scores, acc


def fm_fused_scores(tables, ids, vals, *, use_linear: bool = True, w0=None,
                    compute_bf16: bool = False):
    """Fused gather→FM-interaction forward over per-field tables.

    ``tables``: F × ``[bucket, k+1]`` (fused-linear layout, fp32 or bf16
    storage, contiguous, at any storage offset; any k and F) as a
    sequence or one stacked tensor; ``ids``
    int32 and ``vals`` float32, both ``[B, F]``; ``w0`` an optional
    one-element float32 tensor. Ids are clamped to ``[0, bucket)``.
    ``compute_bf16`` rounds as a bf16 compute dtype does (see
    :func:`fm_fused_scores_plain`). Returns ``(scores [B], acc [B, k+1])``
    in float32: ``acc`` columns ``[:k]`` are ``s = Σ_f x·v`` and column k
    the linear sum.
    """
    tables = list(tables)      # a stacked tensor iterates over its fields
    _check(tables, ids, vals, w0)
    b, num_fields = ids.shape
    if ids.device.type == "cpu":
        return fm_fused_scores_plain(tables, ids, vals, use_linear=use_linear,
                                     w0=w0, compute_bf16=compute_bf16)
    if ids.device.type != "cuda":
        raise KernelUnavailable(f"fm_fused_scores: no kernel for {ids.device}")
    bucket, w = tables[0].shape
    if not (ids.is_contiguous() and vals.is_contiguous()
            and all(t.is_contiguous() for t in tables)):
        raise KernelUnavailable("fm_fused_scores: ids, vals and tables must be contiguous")
    from fm_spark_tpu_torch.kernels import build

    lib = build.load("fm_fused_fwd")
    dev = ids.device
    scores = torch.empty(b, dtype=torch.float32, device=dev)
    acc = torch.empty(b, w, dtype=torch.float32, device=dev)
    addrs = [t.data_ptr() for t in tables]
    ptrs = (ctypes.c_void_p * num_fields)(*addrs)
    ptrs_dev = (stage_table_pointers(tables)
                if num_fields > PARAM_FIELDS else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.fm_fused_fwd(
        ctypes.cast(ptrs, ctypes.c_void_p),
        None if ptrs_dev is None else ptrs_dev.data_ptr(),
        num_fields, bucket, w,
        int(tables[0].dtype == torch.bfloat16), int(compute_bf16),
        ids.data_ptr(),
        vals.data_ptr(), b, None if w0 is None else w0.data_ptr(),
        int(use_linear), scores.data_ptr(), acc.data_ptr(), stream,
        dev.index)
    if err:
        raise RuntimeError(
            f"fm_fused_fwd launch failed: CUDA error {err} "
            f"({lib.fm_cuda_error_string(err).decode()})")
    global launches
    if torch.cuda.is_current_stream_capturing():
        note_recorded("fm_fused_scores")
    else:
        with _launch_lock:
            launches += 1
    return scores, acc
