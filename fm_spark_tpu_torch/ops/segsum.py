"""Segment totals of lanes grouped by segment: the CUDA kernel's wrapper and
its plain PyTorch version.

The port of ``fm_spark_tpu/ops/pallas_segsum.py::segment_totals``: the
compact update's segment-sum stage when ``TrainConfig.segtotal_pallas`` is
set, and the segment sum of every device dedup (``ops/scatter.py``). The
kernel (``csrc/segment_totals.cu``) sums runs of equal ranks with no
atomics, in a fixed order, so a repeat gives the same bits, and reads an
unsorted delta through the caller's sort order in place.
:func:`segment_totals` launches it for CUDA tensors and runs
:func:`segment_totals_plain` only for tensors on the CPU.
"""

from __future__ import annotations

import threading

import torch

from fm_spark_tpu_torch.ops import KernelUnavailable, note_recorded

__all__ = ["launches", "segment_totals", "segment_totals_plain"]

#: Kernel launches made by :func:`segment_totals` in this process.
#: A call that a CUDA graph records is no launch: the graph's replays
#: launch the kernel, past the wrapper.
launches = 0
_launch_lock = threading.Lock()


def _check(delta, seg, cap, order, dtypes):
    if delta.dim() != 2 or seg.dim() != 1 or seg.shape[0] < 1:
        raise ValueError(f"want delta [B, w] and seg [B], got "
                         f"{tuple(delta.shape)} / {tuple(seg.shape)}")
    if delta.dtype not in dtypes or seg.dtype != torch.int32:
        raise TypeError(f"want {dtypes} delta and int32 seg, got "
                        f"{delta.dtype} / {seg.dtype}")
    lanes = [seg] if order is None else [seg, order]
    if order is not None and (order.shape != seg.shape or order.dtype
                              not in (torch.int32, torch.int64)):
        raise TypeError(f"want an int32 or int64 order of "
                        f"{tuple(seg.shape)}, got {tuple(order.shape)} "
                        f"{order.dtype}")
    if order is None and delta.shape[0] != seg.shape[0]:
        raise ValueError(f"delta has {delta.shape[0]} rows, seg "
                         f"{seg.shape[0]} lanes")
    for t in lanes:
        if t.device != delta.device:
            raise ValueError(f"lanes on {t.device}, delta on {delta.device}")
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")


def segment_totals_plain(delta: torch.Tensor, seg: torch.Tensor, cap: int,
                         order: torch.Tensor | None = None,
                         zero_tail: bool = True) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` in lane order into a
    ``[cap + 1, w]`` buffer with ranks outside ``[0, cap)`` parked on the
    trash row ``cap``, which is then trimmed. Sums in float64 for a
    float64 ``delta`` (an exact reference), else in float32 (bf16 widened
    first). Every row past the last rank is 0, whatever ``zero_tail``."""
    _check(delta, seg, cap, order,
           (torch.float32, torch.bfloat16, torch.float64))
    rows = delta if order is None else delta[order.long()]
    if rows.dtype == torch.bfloat16:
        rows = rows.float()
    idx = seg.long()
    idx = torch.where((idx >= 0) & (idx < cap), idx, cap)
    out = torch.zeros(cap + 1, delta.shape[1], dtype=rows.dtype,
                      device=delta.device)
    out.index_add_(0, idx, rows)
    return out[:cap]


def segment_totals(delta: torch.Tensor, seg: torch.Tensor, cap: int,
                   order: torch.Tensor | None = None,
                   zero_tail: bool = True) -> torch.Tensor:
    """Per-segment sums ``out[s] = Σ_{seg[t]=s} x_t``, ``[cap, w]`` float32.

    ``x_t`` is row ``t`` of ``delta`` ([B, w] float32 or bf16), or row
    ``order[t]`` when an ``order`` ([B] int32 or int64, entries in
    ``[0, rows of delta)``) is given: the lanes in the caller's sorted
    order, read in place. ``seg`` [B] int32 holds NON-DECREASING ranks
    (the reference's precondition; gaps between them are allowed). Ranks
    outside ``[0, cap)`` are dropped (the reference's trash row). Rows
    that no lane falls in are 0, except that with ``zero_tail=False`` the
    kernel leaves the rows past the last rank unwritten: for a caller
    that never reads them (ranks dense from 0, as the device dedup's).
    """
    _check(delta, seg, cap, order, (torch.float32, torch.bfloat16))
    if delta.device.type == "cpu":
        return segment_totals_plain(delta, seg, cap, order, zero_tail)
    if delta.device.type != "cuda":
        raise KernelUnavailable(f"segment_totals: no kernel for {delta.device}")
    lanes = [delta, seg] if order is None else [delta, seg, order]
    if not all(t.is_contiguous() for t in lanes):
        raise ValueError("segment_totals: operands must be contiguous")
    from fm_spark_tpu_torch.kernels import build

    lib = build.load("segment_totals")
    dev = delta.device
    b, w = seg.shape[0], delta.shape[1]
    rows = lib.segment_scratch_rows(b)
    out = torch.empty(cap, w, dtype=torch.float32, device=dev)
    cseg = torch.empty(rows, dtype=torch.int32, device=dev)
    cval = torch.empty(rows, w, dtype=torch.float32, device=dev)
    err = lib.segment_totals(
        delta.data_ptr(), int(delta.dtype == torch.bfloat16),
        None if order is None else order.data_ptr(),
        int(order is not None and order.dtype == torch.int64),
        seg.data_ptr(), b, w, cap, int(zero_tail), out.data_ptr(),
        cseg.data_ptr(), cval.data_ptr(), rows,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err:
        raise RuntimeError(
            f"segment_totals launch failed: CUDA error {err} "
            f"({lib.segment_cuda_error_string(err).decode()})")
    global launches
    if torch.cuda.is_current_stream_capturing():
        note_recorded("segment_totals")
    else:
        with _launch_lock:
            launches += 1
    return out
