"""Row gather and in-place row update: the CUDA kernels' wrappers and their
plain PyTorch versions.

The port of ``fm_spark_tpu/ops/pallas_fm.py::gather_rows`` and
``::update_rows_add``, the row access of the fused sparse-SGD steps under
``TrainConfig.use_pallas`` (``scatter.pallas_gather`` and
``scatter._pallas_dedup_add``). The gather kernel (``csrc/rows.cu``)
copies the flat output in 16-byte chunks, the update strides a persistent
grid over the live lanes' elements; see the source for their design and
bound. The TPU's
limits (a width that is a multiple of 128, B a multiple of 256, at most
64 Ki scalar-prefetched ids) are not carried over: any B >= 0 and any
width are taken.

:func:`gather_rows` and :func:`update_rows_add` launch the kernels for
CUDA tensors and run :func:`gather_rows_plain` / :func:`update_rows_add_plain`
only for tensors on the CPU. A gather is a copy and the update one fp32
add and one rounding per element, so kernel and plain version give the
same bits.
"""

from __future__ import annotations

import threading

import torch

from fm_spark_tpu_torch.ops import KernelUnavailable, note_recorded

__all__ = ["gather_launches", "gather_rows", "gather_rows_plain",
           "update_launches", "update_rows_add", "update_rows_add_plain"]

#: Kernel launches made by :func:`gather_rows` / :func:`update_rows_add` in
#: this process.
#: A call that a CUDA graph records is no launch: the graph's replays
#: launch the kernel, past the wrapper.
gather_launches = 0
update_launches = 0
_launch_lock = threading.Lock()

_DTYPES = (torch.float32, torch.bfloat16)


def _check_table(table, ids):
    if table.dim() != 2 or table.shape[0] < 1:
        raise ValueError(f"want a non-empty table [n, w], got "
                         f"{tuple(table.shape)}")
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if ids.dim() != 1 or ids.dtype != torch.int32:
        raise TypeError(f"want int32 ids [B], got {tuple(ids.shape)} "
                        f"{ids.dtype}")
    if ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")


def _check_update(table, ids, valid, delta, count):
    _check_table(table, ids)
    b, w = ids.shape[0], table.shape[1]
    if valid is not None and (valid.shape != (b,)
                              or valid.dtype != torch.int32):
        raise TypeError(f"want int32 valid [{b}], got {tuple(valid.shape)} "
                        f"{valid.dtype}")
    if delta.shape != (b, w) or delta.dtype not in _DTYPES:
        raise TypeError(f"want float32 or bfloat16 delta [{b}, {w}], got "
                        f"{tuple(delta.shape)} {delta.dtype}")
    if count is not None and (count.shape != (1,)
                              or count.dtype != torch.int32):
        raise TypeError(f"want count as one int32, got {tuple(count.shape)} "
                        f"{count.dtype}")
    for t in (valid, delta, count):
        if t is not None and t.device != table.device:
            raise ValueError(f"tensor on {t.device}, table on {table.device}")


def _lib_for(name, *tensors):
    """The bound library, after refusing what the kernels do not take."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise KernelUnavailable(f"{name}: no kernel for {dev}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")
    from fm_spark_tpu_torch.kernels import build

    return build.load("rows")


def _raise_on(lib, name, err):
    if err:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.rows_cuda_error_string(err).decode()})")


def _divider(d: int) -> tuple[int, int]:
    """``(magic, shift)`` with ``(x * magic) >> shift == x // d`` for every
    ``0 <= x < 2**31`` (``magic`` < 2**32): ``l = ceil(log2 d)``,
    ``magic = ceil(2**(31 + l) / d)``, ``shift = 31 + l``."""
    if d < 1:
        raise ValueError(f"divisor {d} < 1")
    lg = (d - 1).bit_length()
    return -(-(1 << (31 + lg)) // d), 31 + lg


def gather_rows_plain(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of :func:`gather_rows`."""
    _check_table(table, ids)
    return table[ids.long().clamp(0, table.shape[0] - 1)]


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[clamp(ids, 0, n - 1)]``, ``[B, w]`` in the table's dtype.

    ``table`` [n, w] float32 or bf16, ``ids`` [B] int32. An id outside the
    table reads its nearest edge row (``scatter.pallas_gather``'s clamp).
    """
    _check_table(table, ids)
    if table.device.type == "cpu":
        return gather_rows_plain(table, ids)
    lib = _lib_for("gather_rows", table, ids)
    dev = table.device
    b, (n, w) = ids.shape[0], table.shape
    out = torch.empty(b, w, dtype=table.dtype, device=dev)
    if b == 0:
        return out
    magic, shift = _divider(w)
    err = lib.rows_gather(table.data_ptr(), n, w, table.element_size(),
                          ids.data_ptr(), b, out.data_ptr(), magic, shift,
                          torch.cuda.current_stream(dev).cuda_stream,
                          dev.index)
    _raise_on(lib, "rows_gather", err)
    global gather_launches
    if torch.cuda.is_current_stream_capturing():
        note_recorded("gather_rows")
    else:
        with _launch_lock:
            gather_launches += 1
    return out


def update_rows_add_plain(table, ids, valid, delta, count=None):
    """Plain PyTorch version of :func:`update_rows_add`, with no read on
    the host: every lane writes, to its id clamped into the table, the
    value its row ends with (a kept lane's sum, else the row as it is), so
    lanes that share a row agree."""
    _check_update(table, ids, valid, delta, count)
    n, b = table.shape[0], ids.shape[0]
    lane = torch.arange(b, device=ids.device)
    keep = (ids >= 0) & (ids < n)
    if valid is not None:
        keep &= valid != 0
    if count is not None:
        keep &= lane < count
    idx = ids.long().clamp(0, n - 1)
    summed = (table[idx].float() + delta.float()).to(table.dtype)
    owner = torch.full((n,), -1, dtype=torch.int64, device=ids.device)
    owner.scatter_reduce_(0, idx, torch.where(keep, lane, -1), reduce="amax")
    src = owner[idx]
    final = torch.where((src >= 0)[:, None], summed[src.clamp(min=0)],
                        table[idx])
    return table.index_copy_(0, idx, final)


def update_rows_add(table: torch.Tensor, ids: torch.Tensor,
                    valid: torch.Tensor | None, delta: torch.Tensor,
                    count: torch.Tensor | None = None) -> torch.Tensor:
    """In place, ``table[ids[m]] = (float(table[ids[m]]) + float(delta[m]))``
    rounded once to the table's dtype, for every lane with ``valid[m] != 0``;
    returns ``table``.

    ``table`` [n, w] float32 or bf16, ``ids`` and ``valid`` [B] int32,
    ``delta`` [B, w] float32 or bf16. The ids must be UNIQUE among the
    valid lanes (the TPU kernel's contract): this is not checked, since a
    check would need a sync with the host, and duplicates make the result
    undefined. A valid lane whose id lies outside ``[0, n)`` is skipped.
    The device dedup's form: ``valid=None`` makes every lane valid, and
    ``count`` (one int32 on the table's device, which the host does not
    know) skips the lanes at or past it without reading them.
    """
    _check_update(table, ids, valid, delta, count)
    if table.device.type == "cpu":
        return update_rows_add_plain(table, ids, valid, delta, count)
    lanes = [t for t in (table, ids, valid, delta, count) if t is not None]
    lib = _lib_for("update_rows_add", *lanes)
    dev = table.device
    b, (n, w) = ids.shape[0], table.shape
    if b == 0:
        return table
    magic, shift = _divider(w)
    err = lib.rows_update_add(
        table.data_ptr(), n, w, int(table.dtype == torch.bfloat16),
        ids.data_ptr(), None if valid is None else valid.data_ptr(),
        delta.data_ptr(), int(delta.dtype == torch.bfloat16), b,
        None if count is None else count.data_ptr(), magic, shift,
        torch.cuda.current_stream(dev).cuda_stream, dev.index)
    _raise_on(lib, "rows_update_add", err)
    global update_launches
    if torch.cuda.is_current_stream_capturing():
        note_recorded("update_rows_add")
    else:
        with _launch_lock:
            update_launches += 1
    return table
