"""Sel-blocked FFM interaction, forward and backward: the CUDA kernels'
wrappers and their plain PyTorch versions.

The port of ``fm_spark_tpu/ops/pallas_fused.py::ffm_sel_scores`` and
``::ffm_sel_bwd`` with ``ffm_sel_supported``. Both take the per-field rows
stacked as ``rows_stacked [B, F, F·k]`` (row ``b``, owner field ``i``,
columns ``j·k:(j+1)·k`` = the factor vector toward field ``j``), so the
``[B, F, F, k]`` sel tensor is never written. The kernels
(``csrc/ffm_sel.cu``) stage one row per block in shared memory; see the
source for their design and bound.

:func:`ffm_sel_scores` and :func:`ffm_sel_bwd` launch the kernels for CUDA
tensors and run :func:`ffm_sel_scores_plain` / :func:`ffm_sel_bwd_plain`
only for tensors on the CPU. Each plain version is the JAX kernel's
owner-field loop term for term, with its fp32 sums taken in index order,
the order the kernels sum in.
"""

from __future__ import annotations

import threading

import torch

from fm_spark_tpu_torch.ops import KernelUnavailable, note_recorded

__all__ = ["MAX_SMEM_BYTES", "bwd_launches", "ffm_sel_bwd",
           "ffm_sel_bwd_plain", "ffm_sel_scores", "ffm_sel_scores_plain",
           "ffm_sel_supported", "scores_launches", "smem_bytes"]

#: Shared memory one block can use on the card (kMaxSmem in the source).
MAX_SMEM_BYTES = 232_448

#: Kernel launches made by :func:`ffm_sel_scores` / :func:`ffm_sel_bwd` in
#: this process.
#: A call that a CUDA graph records is no launch: the graph's replays
#: launch the kernel, past the wrapper.
scores_launches = 0
bwd_launches = 0
_launch_lock = threading.Lock()

_DTYPES = {torch.float32: 4, torch.bfloat16: 2}


def smem_bytes(num_fields: int, rank: int, elem_bytes: int) -> int:
    """Shared memory the kernels stage per row (``ffm_sel_smem_bytes`` in
    the source): the ``[F·F, k]`` slab with each k-vector padded to an odd
    number of 16-byte units, and ``2F + F²`` float32 values of the
    forward's sums."""
    units = -(-rank * elem_bytes // 16)
    if units % 2 == 0:
        units += 1
    slab = num_fields * num_fields * units * 16
    return slab + 4 * (2 * num_fields + num_fields * num_fields)


def ffm_sel_supported(num_fields: int, rank: int,
                      cd_bytes: int = 4) -> str | None:
    """Why the kernels cannot serve ``num_fields`` fields of rank ``rank``
    in a compute dtype of ``cd_bytes`` bytes, or None.

    The TPU kernels hold a ``[128, F, F·k]`` tile in VMEM. These stage one
    row's ``[F, F·k]`` slab per block in shared memory, which bounds
    ``F²·k``."""
    if cd_bytes not in (2, 4):
        return (f"a compute dtype of {cd_bytes} bytes (the kernels take "
                "float32 or bfloat16)")
    need = smem_bytes(num_fields, rank, cd_bytes)
    if need > MAX_SMEM_BYTES:
        return (f"one row's slab [{num_fields}, {num_fields}·{rank}] needs "
                f"{need:,} B of shared memory > the {MAX_SMEM_BYTES:,} B "
                "a block can use")
    return None


def _check(rows_stacked, vals, dscores=None):
    """Validate the operands; return ``(B, F, k)``."""
    if rows_stacked.dim() != 3:
        raise ValueError(f"want rows_stacked [B, F, F·k], got "
                         f"{tuple(rows_stacked.shape)}")
    b, num_fields, fk = rows_stacked.shape
    rank = fk // num_fields if num_fields else 0
    if rank < 1 or rank * num_fields != fk:
        raise KernelUnavailable(
            f"ffm_sel: packed width {fk} is not divisible by the field "
            f"count {num_fields}")
    if b < 1:
        raise ValueError("empty batch")
    if rows_stacked.dtype not in _DTYPES:
        raise TypeError(f"rows must be float32 or bfloat16, got "
                        f"{rows_stacked.dtype}")
    if vals.shape != (b, num_fields) or not vals.is_floating_point():
        raise ValueError(f"want float vals [{b}, {num_fields}], got "
                         f"{tuple(vals.shape)} {vals.dtype}")
    others = [vals]
    if dscores is not None:
        if dscores.shape != (b,) or not dscores.is_floating_point():
            raise ValueError(f"want float dscores [{b}], got "
                             f"{tuple(dscores.shape)} {dscores.dtype}")
        others.append(dscores)
    for t in others:
        if t.device != rows_stacked.device:
            raise ValueError(f"tensor on {t.device}, rows on "
                             f"{rows_stacked.device}")
    return b, num_fields, rank


def _sum_in_order(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum along ``dim`` in fp32, in index order, rounded once to ``x``'s
    dtype (``jnp.sum`` on bf16 accumulates in fp32 and rounds once)."""
    parts = x.float().unbind(dim)
    s = parts[0]
    for p in parts[1:]:
        s = s + p
    return s.to(x.dtype)


def ffm_sel_scores_plain(rows_stacked, vals):
    """Plain PyTorch version of :func:`ffm_sel_scores`: ``_ffm_fwd_kernel``'s
    owner-field loop in the rows' dtype, fp32 sums in index order."""
    b, num_fields, rank = _check(rows_stacked, vals)
    r = rows_stacked.reshape(b, num_fields, num_fields, rank)
    x = vals.to(r.dtype)
    acc = torch.zeros(b, dtype=r.dtype, device=r.device)
    for i in range(num_fields):
        sel_i = r[:, i] * x[:, i, None, None]
        selt_i = r[:, :, i, :] * x[:, :, None]
        prod = _sum_in_order(sel_i * selt_i, -1)                 # [B, F]
        acc = acc + _sum_in_order(prod, 1) - prod[:, i]
    return acc.to(vals.dtype)


def ffm_sel_bwd_plain(rows_stacked, vals, dscores):
    """Plain PyTorch version of :func:`ffm_sel_bwd`: ``_ffm_bwd_kernel``'s
    owner-field loop in the rows' dtype."""
    b, num_fields, rank = _check(rows_stacked, vals, dscores)
    r = rows_stacked.reshape(b, num_fields, num_fields, rank)
    x = vals.to(r.dtype)
    ds = dscores.to(r.dtype)
    out = torch.empty(b, num_fields, num_fields * rank, dtype=r.dtype,
                      device=r.device)
    for i in range(num_fields):
        selt_i = r[:, :, i, :] * x[:, :, None]
        dsel_i = ds[:, None, None] * selt_i
        dsel_i[:, i, :].zero_()
        out[:, i, :] = (dsel_i * x[:, i, None, None]).reshape(b, -1)
    return out


def _kernel_operands(name, rows_stacked, *others):
    """Refuse what the kernels do not take; return the library and the
    other operands in the rows' dtype, contiguous."""
    dev = rows_stacked.device
    if dev.type != "cuda":
        raise KernelUnavailable(f"{name}: no kernel for {dev}")
    b, num_fields, fk = rows_stacked.shape
    reason = ffm_sel_supported(num_fields, fk // num_fields,
                               _DTYPES[rows_stacked.dtype])
    if reason:
        raise KernelUnavailable(f"{name}: {reason}")
    if not rows_stacked.is_contiguous():
        raise ValueError(f"{name}: rows_stacked must be contiguous")
    from fm_spark_tpu_torch.kernels import build

    return build.load("ffm_sel"), [t.to(rows_stacked.dtype).contiguous()
                                   for t in others]


def _raise_on(lib, name, err):
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.ffm_cuda_error_string(err).decode()})")


def ffm_sel_scores(rows_stacked, vals):
    """The pairwise FFM accumulator ``acc [B]`` (``scores = ½·acc``; the
    caller applies the ½) from ``rows_stacked [B, F, F·k]`` (float32 or
    bf16, the compute dtype) and ``vals [B, F]`` (cast to the rows'
    dtype). Returned in ``vals``' dtype, as the JAX kernel's."""
    b, num_fields, rank = _check(rows_stacked, vals)
    if rows_stacked.device.type == "cpu":
        return ffm_sel_scores_plain(rows_stacked, vals)
    lib, (x,) = _kernel_operands("ffm_sel_scores", rows_stacked, vals)
    dev = rows_stacked.device
    acc = torch.empty(b, dtype=rows_stacked.dtype, device=dev)
    err = lib.ffm_sel_fwd(
        rows_stacked.data_ptr(), x.data_ptr(), acc.data_ptr(), b, num_fields,
        rank, int(rows_stacked.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _raise_on(lib, "ffm_sel_fwd", err)
    global scores_launches
    if torch.cuda.is_current_stream_capturing():
        note_recorded("ffm_sel_scores")
    else:
        with _launch_lock:
            scores_launches += 1
    return acc.to(vals.dtype)


def ffm_sel_bwd(rows_stacked, vals, dscores):
    """Per-owner-field factor gradients ``dvs [B, F, F·k]`` in the rows'
    dtype, ``dvs[b, i, j·k:(j+1)·k] = [i≠j]·(ds_b·(R[b,j,i]·x_j))·x_i``,
    from ``rows_stacked`` as in :func:`ffm_sel_scores`, ``vals [B, F]``
    and ``dscores [B]`` (both cast to the rows' dtype)."""
    b, num_fields, rank = _check(rows_stacked, vals, dscores)
    if rows_stacked.device.type == "cpu":
        return ffm_sel_bwd_plain(rows_stacked, vals, dscores)
    lib, (x, ds) = _kernel_operands("ffm_sel_bwd", rows_stacked, vals,
                                    dscores)
    dev = rows_stacked.device
    out = torch.empty_like(rows_stacked)
    err = lib.ffm_sel_bwd(
        rows_stacked.data_ptr(), x.data_ptr(), ds.data_ptr(), out.data_ptr(),
        b, num_fields, rank, int(rows_stacked.dtype == torch.bfloat16),
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _raise_on(lib, "ffm_sel_bwd", err)
    global bwd_launches
    if torch.cuda.is_current_stream_capturing():
        note_recorded("ffm_sel_bwd")
    else:
        with _launch_lock:
            bwd_launches += 1
    return out
