"""Segment totals of sorted deltas: the CUDA kernel's wrapper and its plain
PyTorch version.

The port of ``fm_spark_tpu/ops/pallas_segsum.py::segment_totals``, the
compact update's segment-sum stage when ``TrainConfig.segtotal_pallas``
is set. The kernel (``csrc/segment_totals.cu``, on the tile-and-carry
skeleton of ``csrc/segment_scan.cuh``) sums runs of equal ranks with no
atomics, so a repeat gives the same bits. :func:`segment_totals` launches
it for CUDA tensors and runs :func:`segment_totals_plain` only for tensors
on the CPU.
"""

from __future__ import annotations

import threading

import torch

from fm_spark_tpu_torch.ops import KernelUnavailable

__all__ = ["MAX_WIDTH", "launches", "segment_totals", "segment_totals_plain"]

#: Widest row the kernel takes (SEG_MAX_WIDTH: one thread per column).
MAX_WIDTH = 128

#: Kernel launches made by :func:`segment_totals` in this process.
launches = 0
_launch_lock = threading.Lock()


def _check(sdelta, seg, cap, dtypes=(torch.float32,)):
    if sdelta.dim() != 2 or seg.dim() != 1 or seg.shape[0] != sdelta.shape[0]:
        raise ValueError(f"want sdelta [B, w] and seg [B], got "
                         f"{tuple(sdelta.shape)} / {tuple(seg.shape)}")
    if sdelta.shape[0] < 1:
        raise ValueError("empty batch")
    if sdelta.dtype not in dtypes or seg.dtype != torch.int32:
        raise TypeError(f"want {dtypes} sdelta and int32 seg, got "
                        f"{sdelta.dtype} / {seg.dtype}")
    if seg.device != sdelta.device:
        raise ValueError(f"seg on {seg.device}, sdelta on {sdelta.device}")
    if cap < 1:
        raise ValueError(f"cap must be >= 1, got {cap}")


def segment_totals_plain(sdelta: torch.Tensor, seg: torch.Tensor,
                         cap: int) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` into a ``[cap + 1, w]``
    buffer with ranks outside ``[0, cap)`` parked on the trash row
    ``cap``, which is then trimmed. Sums in the dtype of ``sdelta``
    (float32, or float64 for an exact reference)."""
    _check(sdelta, seg, cap, (torch.float32, torch.float64))
    idx = seg.long()
    idx = torch.where((idx >= 0) & (idx < cap), idx, cap)
    out = torch.zeros(cap + 1, sdelta.shape[1], dtype=sdelta.dtype,
                      device=sdelta.device)
    out.index_add_(0, idx, sdelta)
    return out[:cap]


def segment_totals(sdelta: torch.Tensor, seg: torch.Tensor,
                   cap: int) -> torch.Tensor:
    """Per-segment sums ``out[s] = Σ_{seg[t]=s} sdelta[t]``, ``[cap, w]``
    float32.

    ``sdelta`` [B, w] float32 grouped by segment (equal ranks contiguous,
    as the compact aux's sorted order gives them); ``seg`` [B] int32. Ranks
    outside ``[0, cap)`` are dropped (the reference's trash row). Unlike
    the TPU kernel, which drops lanes of gapped ranks silently, the kernel
    sums any grouping of ranks.
    """
    _check(sdelta, seg, cap)
    if sdelta.device.type == "cpu":
        return segment_totals_plain(sdelta, seg, cap)
    if sdelta.device.type != "cuda":
        raise KernelUnavailable(f"segment_totals: no kernel for {sdelta.device}")
    b, w = sdelta.shape
    if w > MAX_WIDTH:
        raise KernelUnavailable(
            f"segment_totals: kernel takes rows of width <= {MAX_WIDTH}, got {w}")
    if not (sdelta.is_contiguous() and seg.is_contiguous()):
        raise ValueError("segment_totals: sdelta and seg must be contiguous")
    from fm_spark_tpu_torch.kernels import build

    lib = build.load("segment_totals")
    dev = sdelta.device
    rows = lib.segment_scratch_rows(b)
    out = torch.empty(cap, w, dtype=torch.float32, device=dev)
    cseg = torch.empty(rows, dtype=torch.int32, device=dev)
    cval = torch.empty(rows, w, dtype=torch.float32, device=dev)
    err = lib.segment_totals(
        sdelta.data_ptr(), seg.data_ptr(), b, w, cap, out.data_ptr(),
        cseg.data_ptr(), cval.data_ptr(), rows,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err:
        raise RuntimeError(
            f"segment_totals launch failed: CUDA error {err} "
            f"({lib.segment_cuda_error_string(err).decode()})")
    global launches
    with _launch_lock:
        launches += 1
    return out
