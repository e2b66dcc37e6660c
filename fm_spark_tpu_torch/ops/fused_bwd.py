"""Fused FM backward + segment totals: the CUDA kernel's wrapper, its plain
PyTorch version, and the g_full expression both share.

The port of ``fm_spark_tpu/ops/pallas_fused.py::fm_bwd_segment_totals``,
the ``fused_embed`` form of the compact update. For every field the kernel
(``csrc/fm_fused_bwd.cu``) rebuilds ``-lr·g_full`` lane by lane from the
unsorted per-example streams and the field's unique rows, and sums it per
segment in the same pass: the F × [B, k+1] gradient set is never written.
One launch covers all fields. :func:`fm_bwd_segment_totals` launches it
for CUDA tensors and runs :func:`fm_bwd_segment_totals_plain` (the
``_gfull_grads`` + segment-sum composition it subsumes) only for tensors
on the CPU.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import torch

from fm_spark_tpu_torch.ops import KernelUnavailable, note_recorded
from fm_spark_tpu_torch.ops.segsum import segment_totals_plain

__all__ = ["MAX_FIELDS", "MAX_WIDTH", "fm_bwd_segment_totals",
           "fm_bwd_segment_totals_plain", "fm_bwd_sorted_deltas",
           "fm_bwd_supported", "gfull",
           "launches", "round_to", "rv_vector"]

#: Limits of the kernel (FM_BWD_MAX_FIELDS and SEG_MAX_WIDTH in the source).
MAX_FIELDS = 64
MAX_WIDTH = 128

#: Kernel launches made by :func:`fm_bwd_segment_totals` in this process.
#: A call that a CUDA graph records is no launch: the graph's replays
#: launch the kernel, past the wrapper.
launches = 0
_launch_lock = threading.Lock()


def fm_bwd_supported(cap: int, width: int, num_fields: int) -> str | None:
    """Why the kernel cannot serve ``num_fields`` fields of ``[cap, width]``
    unique rows, or None.

    The TPU kernel keeps the totals and the unique rows resident in VMEM,
    which bounds ``cap·width``. This kernel keeps neither resident: it
    stages a tile's unique rows in shared memory (at most 128 rows of at
    most 528 bytes) and writes the totals once, so ``cap`` is bounded only
    by the 32-bit row index. Its limits are the width (128 lanes' staged
    rows and their 16-bit offsets, and the carry passes' thread per
    column), the table pointers it carries by value, and that index.
    """
    if width > MAX_WIDTH:
        return (f"row width {width} > {MAX_WIDTH} (the carry passes run "
                "one thread per column)")
    if num_fields > MAX_FIELDS:
        return f"{num_fields} fields > {MAX_FIELDS} (table pointers by value)"
    if cap * width >= 2**31:
        return f"cap·width = {cap * width} overflows the kernel's int32 index"
    return None


def gfull(rows, xv_full, s1, ds, x, touched, rv, colmask, extra=None):
    """One field's fused row gradient (``sparse._gfull_grads``):
    ``(ds·(s1 − mask·xv_full) + extra)·x + rv·rows·touched``, every
    operation in the compute dtype of its operands. ``rows``/``xv_full``/
    ``s1`` [B, k+1]; ``ds``/``x``/``touched`` [B]; ``rv`` [k+1] or None;
    ``colmask`` [k+1] bool, False on the linear column; ``extra`` [B, k+1]
    or None (FieldDeepFM's deep-head pullback, zero on the linear
    column)."""
    base = ds[:, None] * (s1 - torch.where(colmask, xv_full,
                                           torch.zeros((), dtype=s1.dtype,
                                                       device=s1.device)))
    if extra is not None:
        base = base + extra
    g = base * x[:, None]
    if rv is not None:
        g = g + rv * rows * touched[:, None]
    return g


def round_to(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (float32 or bf16) as ``torch.tensor(
    value, dtype=dtype)`` rounds it (to float32, then to nearest even in
    bf16), in plain Python: no tensor op, so a captured step may call it."""
    (bits,) = struct.unpack("<I", struct.pack("<f", value))
    if dtype == torch.bfloat16 and (bits & 0x7F800000) != 0x7F800000:
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    elif dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"round_to takes float32 or bfloat16, not {dtype}")
    return struct.unpack("<f", struct.pack("<I", bits))[0]


def rv_vector(rv, k, cd, device):
    """The per-column reg vector ``[k+1]`` of a ``(factor, linear)`` pair
    (None stays None), made on ``device`` by fills, not copied from the
    host (a captured step may build it). Each value is rounded to ``cd``
    on the host first, as JAX rounds the list it is given."""
    if rv is None:
        return None
    factor, linear = (round_to(r, cd) for r in rv)
    out = torch.full((k + 1,), factor, dtype=cd, device=device)
    out[k:].fill_(linear)
    return out


def _check(urows, s1, dscores, vals, weights, order, inv, cap):
    if not urows:
        raise ValueError("no fields")
    num_fields = len(urows)
    b, w = s1.shape
    shape, dtype = urows[0].shape, urows[0].dtype
    if tuple(shape) != (cap, w):
        raise ValueError(f"want [cap, k+1] = [{cap}, {w}] urows, got {tuple(shape)}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"urows storage must be float32 or bfloat16, got {dtype}")
    if s1.dtype not in (torch.float32, torch.bfloat16) or dscores.dtype != s1.dtype:
        raise TypeError(f"s1 and dscores must share a float32/bfloat16 "
                        f"compute dtype, got {s1.dtype} / {dscores.dtype}")
    if (dscores.shape != (b,) or vals.shape != (b, num_fields)
            or weights.shape != (b,) or order.shape != (num_fields, b)
            or inv.shape != (num_fields, b)):
        raise ValueError("want dscores/weights [B], vals [B, F], order/inv [F, B]")
    if vals.dtype != torch.float32 or weights.dtype != torch.float32:
        raise TypeError("vals and weights must be float32")
    if order.dtype != torch.int32 or inv.dtype != torch.int32:
        raise TypeError("order and inv must be int32")
    dev = s1.device
    for t in (*urows, dscores, vals, weights, order, inv):
        if t.device != dev:
            raise ValueError(f"tensor on {t.device}, s1 on {dev}")
    for t in urows:
        if t.shape != shape or t.dtype != dtype:
            raise ValueError("every field's urows must share one shape and dtype")


def fm_bwd_sorted_deltas(urows, s1, dscores, vals, weights, order, inv,
                         neg_lr, rv=None, *, cap: int):
    """Per field, the unique rows expanded by ``inv`` (a zero row past
    ``cap``), :func:`gfull` and ``neg_lr·g`` in float32, reordered by
    ``order``: a list of F ``(sdelta [B, k+1] float32, seg [B] int32)``
    pairs, the terms that :func:`fm_bwd_segment_totals_plain` sums."""
    urows = list(urows)
    _check(urows, s1, dscores, vals, weights, order, inv, cap)
    cd, (b, w) = s1.dtype, s1.shape
    k = w - 1
    x_all = vals.to(cd)
    touched = (weights > 0).to(cd)
    rv_vec = rv_vector(rv, k, cd, s1.device)
    colmask = torch.arange(w, device=s1.device) < k
    out = []
    for f, u in enumerate(urows):
        seg = inv[f].long()
        live = (seg < cap)[:, None]
        rows = torch.where(live, u.to(cd)[seg.clamp(max=cap - 1)],
                           torch.zeros((), dtype=cd, device=s1.device))
        x = x_all[:, f]
        g = gfull(rows, rows * x[:, None], s1, dscores, x, touched, rv_vec,
                  colmask)
        o = order[f].long()
        delta = g.float() * neg_lr
        out.append((delta[o].contiguous(), inv[f][o].contiguous()))
    return out


def fm_bwd_segment_totals_plain(urows, s1, dscores, vals, weights, order,
                                inv, neg_lr, rv=None, *, cap: int):
    """Plain PyTorch version: :func:`fm_bwd_sorted_deltas` summed per
    segment by :func:`~fm_spark_tpu_torch.ops.segsum.segment_totals_plain`.
    Returns ``[F, cap, k+1]`` float32."""
    return torch.stack([
        segment_totals_plain(d, seg, cap)
        for d, seg in fm_bwd_sorted_deltas(urows, s1, dscores, vals, weights,
                                           order, inv, neg_lr, rv, cap=cap)])


def fm_bwd_segment_totals(urows, s1, dscores, vals, weights, order, inv,
                          neg_lr, rv=None, *, cap: int):
    """Segment totals of ``neg_lr·g_full`` for every field, ``[F, cap, k+1]``
    float32, with the gradient never materialised.

    ``urows``: F × ``[cap, k+1]`` unique rows (float32 or bf16 storage);
    ``s1`` ``[B, k+1]`` (``[s, lin_on]``) and ``dscores`` ``[B]`` in the
    compute dtype; ``vals`` ``[B, F]`` and ``weights`` ``[B]`` float32
    (touched = weights > 0); ``order``/``inv`` ``[F, B]`` int32 from the
    compact aux, unsorted streams read through them. ``neg_lr`` is a
    float32 value, as a Python float or a 0-dim float32 tensor on the
    device (the kernel reads it there, so a captured step takes each
    replay's learning rate); ``rv`` the ``(factor, linear)`` column regs
    or None.
    """
    urows = list(urows)
    _check(urows, s1, dscores, vals, weights, order, inv, cap)
    dev = s1.device
    if dev.type == "cpu":
        return fm_bwd_segment_totals_plain(urows, s1, dscores, vals, weights,
                                           order, inv, neg_lr, rv, cap=cap)
    if dev.type != "cuda":
        raise KernelUnavailable(f"fm_bwd_segment_totals: no kernel for {dev}")
    num_fields = len(urows)
    b, w = s1.shape
    reason = fm_bwd_supported(cap, w, num_fields)
    if reason:
        raise KernelUnavailable(f"fm_bwd_segment_totals: {reason}")
    if not all(t.is_contiguous() for t in (*urows, s1, dscores, vals,
                                           weights, order, inv)):
        raise ValueError("fm_bwd_segment_totals: inputs must be contiguous")
    from fm_spark_tpu_torch.kernels import build

    lib = build.load("fm_fused_bwd")
    cd = s1.dtype
    rv_f, rv_l = (0.0, 0.0) if rv is None else (round_to(r, cd) for r in rv)
    if isinstance(neg_lr, torch.Tensor):
        if (neg_lr.shape != () or neg_lr.dtype != torch.float32
                or neg_lr.device != dev):
            raise ValueError(f"fm_bwd_segment_totals: neg_lr must be a 0-dim "
                             f"float32 tensor on {dev}")
    else:
        neg_lr = torch.full((), neg_lr, dtype=torch.float32, device=dev)
    rows = lib.fm_bwd_scratch_rows(b) * num_fields
    out = torch.empty(num_fields, cap, w, dtype=torch.float32, device=dev)
    cseg = torch.empty(rows, dtype=torch.int32, device=dev)
    cval = torch.empty(rows, w, dtype=torch.float32, device=dev)
    ptrs = (ctypes.c_void_p * num_fields)(*[t.data_ptr() for t in urows])
    vals_t = torch.empty(num_fields, b, dtype=torch.float32, device=dev)
    err = lib.fm_fused_bwd(
        ctypes.cast(ptrs, ctypes.c_void_p), num_fields, cap, w,
        int(urows[0].dtype == torch.bfloat16), int(cd == torch.bfloat16),
        order.data_ptr(), inv.data_ptr(), s1.data_ptr(), dscores.data_ptr(),
        vals.data_ptr(), vals_t.data_ptr(), weights.data_ptr(), b,
        neg_lr.data_ptr(),
        int(rv is not None), rv_f, rv_l, out.data_ptr(), cseg.data_ptr(),
        cval.data_ptr(), rows,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    if err:
        raise RuntimeError(
            f"fm_fused_bwd launch failed: CUDA error {err} "
            f"({lib.fm_bwd_cuda_error_string(err).decode()})")
    global launches
    if torch.cuda.is_current_stream_capturing():
        note_recorded("fm_bwd_segment_totals")
    else:
        with _launch_lock:
            launches += 1
    return out
