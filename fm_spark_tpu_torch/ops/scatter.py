"""Sparse row updates of the fused steps: the compact path, the per-lane
dedup forms, stochastic rounding, scatter-add, and the host-side aux
builders (the port of ``fm_spark_tpu/ops/scatter.py``).

Write strategies (``TrainConfig.sparse_update``):

- ``"scatter_add"``: ``index_add_`` of every lane's delta.
- ``"dedup"``: per-segment totals of the sorted deltas, then one add per
  unique id; with the compact aux (``compact_cap > 0``) on ``cap`` lanes,
  else on ``B`` lanes with the segments from the device sort
  (:func:`_dedup`) or from the host's :func:`dedup_aux`.
- ``"dedup_sr"``: the same totals, then one stochastic-rounded set per
  unique id of ``old row + total``.

With ``use_pallas`` the ``scatter_add`` and ``dedup`` writes go through
:func:`_pallas_dedup_add` (the device sort, the segment sums by kernel A,
``ops.segsum``, then the row-update kernel, ``ops.rows``), and the row
gathers through :func:`pallas_gather`. Every device segment sum of the
dedup forms runs through kernel A, which adds in a fixed order: a step
repeats bit for bit on the card.

Tables are updated IN PLACE (the JAX package donates them; the port never
holds a second copy of a 1.33 GB table set) and returned. The compact
path's gather and writes take FieldFM's transposed ``col`` layout too
(``col=True``: ``[w, n]`` tables, the same values), and
:func:`apply_split_row_updates` is the update of its unfused
(``fused_linear=False``) form.

Out-of-range writes: XLA's ``mode="drop"`` has no torch counterpart, and
an out-of-range ``index_add_``/``index_copy_`` on CUDA is a device-side
assert. So a write clamps every index into the table and makes each
dropped lane's write a no-op (an add of zero, or a set of the value its
row ends with), with no device-to-host sync to count the real lanes. As in
JAX, an id in ``[-n, 0)`` counts from the end on the XLA-path writes, and
the Pallas path drops it (:func:`_pallas_dedup_add`) where
:func:`pallas_gather` clamps it to row 0.

SR noise: :class:`SrNoise` draws JAX's own threefry bits per (step,
field) key from ``seed + 0x5EED`` (``ops.srbits``: a kernel on the card,
its plain version on the CPU), so a bf16 ``dedup_sr`` write rounds as the
JAX step's does; :func:`stochastic_round` takes the bits as an argument
so tests can inject others.

Device aux: :func:`device_compact_aux` builds the compact aux inside the
step (``compact_device``) with no host round trip: one batched stable
sort of the ``[F, B]`` ids, scatters into ``cap + 1`` slots whose last
one takes the dropped lanes, and nothing that reads a size on the host.

Host aux: :func:`compact_aux` and :func:`dedup_aux` run the native
counting sort (``fm_spark_tpu_torch.native``) where its scratch fits
(``native.counting_sort_fits``, the reference's rule) and the numpy
builders :func:`compact_aux_plain` / :func:`dedup_aux_plain` otherwise;
both give the same ints.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fm_spark_tpu_torch import native
from fm_spark_tpu_torch.ops import rows as rows_lib
from fm_spark_tpu_torch.ops import segsum as segsum_lib
from fm_spark_tpu_torch.ops import srbits

__all__ = ["SPARSE_UPDATE_MODES", "CompactCapOverflow", "SrNoise",
           "apply_row_updates", "compact_apply", "compact_apply_totals",
           "compact_aux", "compact_aux_plain", "compact_gather", "dedup_aux",
           "dedup_aux_plain", "device_compact_aux", "pallas_gather",
           "stochastic_round"]

SPARSE_UPDATE_MODES = ("scatter_add", "dedup", "dedup_sr")

_IMAX = np.iinfo(np.int32).max


class CompactCapOverflow(ValueError):
    """A field's per-batch unique-id count exceeded ``compact_cap``."""


class SrNoise:
    """SR noise bits: ``noise(step, field, shape)`` → int32 values in
    ``[0, 65536)`` on ``device``, JAX's ``jax.random.bits(sr_key(key(seed),
    step, field), shape) & 0xFFFF`` (:func:`~fm_spark_tpu_torch.ops.srbits
    .sr_bits`). ``seed`` is the config's ``seed + 0x5EED``, as the
    reference's key; ``step`` an int or a 0-dim int tensor on ``device``."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)

    def __call__(self, step, field: int, shape) -> torch.Tensor:
        return srbits.sr_bits(self.seed, step, field, shape, self.device)


def stochastic_round(x: torch.Tensor, dtype: torch.dtype,
                     noise: torch.Tensor | None = None) -> torch.Tensor:
    """Round fp32 ``x`` to ``dtype`` stochastically (unbiased).

    bf16: add the low-16-bit ``noise`` (int32 values in ``[0, 65536)``,
    shaped like ``x``) to the float's bits and truncate. A finite input
    the carry pushes to inf saturates to ±bf16 max; non-finite inputs pass
    through unrounded. fp32 targets are the identity (no noise needed).
    """
    if dtype == torch.float32:
        return x
    if dtype != torch.bfloat16:
        raise ValueError(f"stochastic_round supports bf16/fp32, not {dtype}")
    if noise is None or noise.shape != x.shape:
        raise ValueError("bf16 stochastic_round needs noise bits shaped like x")
    x = x.float().contiguous()
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (bits + noise.to(torch.int64)) & 0xFFFF0000
    rounded = torch.where(rounded >= 1 << 31, rounded - (1 << 32), rounded)
    out = rounded.to(torch.int32).view(torch.float32).to(torch.bfloat16)
    finite_in = torch.isfinite(x)
    maxv = torch.finfo(torch.bfloat16).max
    out = torch.where(torch.isfinite(out) | ~finite_in, out,
                      (torch.sign(x) * maxv).to(torch.bfloat16))
    return torch.where(finite_in, out, x.to(torch.bfloat16))


def _overflow(field: int, count: int, cap: int) -> CompactCapOverflow:
    return CompactCapOverflow(
        f"field {field}: {count} unique ids > compact cap {cap}; raise "
        "compact_cap (it must bound the per-field per-batch "
        "unique-id count)"
    )


def _compact_ids(ids, cap: int) -> np.ndarray:
    """The reference's checks of a compact-aux batch; returns it as an
    array."""
    ids = np.asarray(ids)
    if ids.ndim != 2:
        raise ValueError("compact_aux expects [B, F] ids")
    b = ids.shape[0]
    if cap < 1 or cap > max(b, 1):
        raise ValueError(f"cap must be in [1, B], got {cap} (B={b})")
    if b and ids.min() < 0:
        raise ValueError("compact_aux requires non-negative ids")
    if b and int(ids.max()) >= _IMAX - cap:
        raise ValueError("id space collides with the sentinel range")
    return ids


def compact_aux(ids, cap: int):
    """HOST-side aux of the compact update for a ``[B, F]`` id batch
    (int-exact with the reference's builder). Returns ``(useg, segstart,
    segend, order, inv)``, all int32:

    - ``useg`` [F, cap]: each field's unique ids, ascending, padded with
      DISTINCT ascending sentinels ``INT32_MAX - cap + j`` past the table;
    - ``segstart`` / ``segend`` [F, cap]: first / last sorted-lane index of
      each segment (padding: ``B - 1``);
    - ``order`` [F, B]: each field's stable argsort of the ids;
    - ``inv`` [F, B]: the segment of each ORIGINAL lane.

    The native counting sort builds it where its scratch fits, else
    :func:`compact_aux_plain`. Raises :class:`CompactCapOverflow` if a
    field has more than ``cap`` unique ids (the lowest such field).
    """
    ids = _compact_ids(ids, cap)
    b, f = ids.shape
    bucket = int(ids.max()) + 1 if b else 1
    if not native.counting_sort_fits(bucket, f):
        return compact_aux_plain(ids, cap)
    aux, over = native.compact_aux(ids, bucket, cap)
    if over >= 0:
        raise _overflow(over, np.unique(ids[:, over]).size, cap)
    return aux


def compact_aux_plain(ids, cap: int):
    """The numpy builder of :func:`compact_aux` (the same ints)."""
    ids = _compact_ids(ids, cap)
    b, f = ids.shape
    useg = np.zeros((f, cap), np.int32)
    segstart = np.full((f, cap), max(b - 1, 0), np.int32)
    segend = np.full((f, cap), max(b - 1, 0), np.int32)
    order = np.ascontiguousarray(
        np.argsort(ids, axis=0, kind="stable").astype(np.int32).T)
    inv = np.zeros((f, b), np.int32)
    sentinel = (_IMAX - cap) + np.arange(cap, dtype=np.int32)
    for j in range(f):
        sid = ids[order[j], j]
        u, first = (np.unique(sid, return_index=True) if b
                    else (np.empty(0, np.int32), np.empty(0, np.int64)))
        s = u.size
        if s > cap:
            raise _overflow(j, s, cap)
        useg[j, :s] = u
        useg[j, s:] = sentinel[: cap - s]
        segstart[j, :s] = first
        segend[j, :s] = np.r_[first[1:] - 1, b - 1] if s else []
        seg_of_sorted = np.cumsum(
            np.r_[0, (sid[1:] != sid[:-1]).astype(np.int32)]
        ) if b else np.empty(0, np.int64)
        inv[j, order[j]] = seg_of_sorted
    return useg, segstart, segend, order, inv


def dedup_aux(ids):
    """HOST-side aux of the per-lane dedup forms (``host_dedup`` without a
    cap) for a ``[B, F]`` id batch (a ``[B]`` batch gives ``[B]`` arrays):
    ``(order, seg, useg, ord_first)``, each int32 ``[F, B]``:

    - ``order``: each field's stable argsort of the ids;
    - ``seg``: the segment of each SORTED lane (duplicates share one);
    - ``useg``: the unique id each segment writes to, padded past the
      segment count with ``INT32_MAX`` (past any table: dropped);
    - ``ord_first``: the original lane of each segment's first sorted
      occurrence (the ``dedup_sr`` representative row).

    The native counting sort builds it where its scratch fits, else
    :func:`dedup_aux_plain`; both give the reference's ints.
    """
    return _dedup_aux(ids, native_ok=True)


def dedup_aux_plain(ids):
    """The numpy builder of :func:`dedup_aux` (the same ints)."""
    return _dedup_aux(ids, native_ok=False)


def _dedup_aux(ids, native_ok: bool):
    ids = np.asarray(ids)
    squeeze = ids.ndim == 1
    if squeeze:
        ids = ids[:, None]
    b, f = ids.shape
    if b and ids.min() < 0:
        raise ValueError("dedup_aux requires non-negative ids")
    bucket = int(ids.max()) + 1 if b else 1
    if native_ok and b and native.counting_sort_fits(bucket, f):
        out = native.dedup_aux(ids, bucket)
    else:
        out = _dedup_aux_numpy(ids)
    return tuple(a[0] for a in out) if squeeze else out


def _dedup_aux_numpy(ids):
    b, f = ids.shape
    ids_t = np.ascontiguousarray(ids.T)
    order = np.argsort(ids_t, axis=1, kind="stable").astype(np.int32)
    sid = np.take_along_axis(ids_t, order, axis=1)
    run = np.concatenate(
        [np.ones((f, min(b, 1)), bool), sid[:, 1:] != sid[:, :-1]], axis=1)
    seg = run.cumsum(axis=1).astype(np.int32) - 1
    useg = np.full((f, b), _IMAX, np.int32)
    ord_first = np.zeros((f, b), np.int32)
    for j in range(f):
        u = sid[j, run[j]]
        useg[j, : u.size] = u
        ord_first[j, : u.size] = order[j, run[j]]
    return order, seg, useg, ord_first


def _check_sentinel_range(bucket: int, cap: int) -> None:
    """The table must end below the sentinel range ``[INT32_MAX - cap,
    INT32_MAX)``, so padding slots are never real rows."""
    if bucket > _IMAX - cap:
        raise ValueError(
            f"table bucket dim {bucket} collides with the compact "
            f"sentinel range [{_IMAX - cap}, {_IMAX}); shard or split the "
            "table below INT32_MAX - cap rows"
        )


def _rows_of(table: torch.Tensor, col: bool) -> int:
    """The table's row count: ``[n, w]``, or ``[w, n]`` in the ``col``
    layout (FieldFM's ``table_layout='col'``, the same values
    transposed)."""
    return table.shape[1] if col else table.shape[0]


def compact_gather(table: torch.Tensor, useg: torch.Tensor,
                   col: bool = False) -> torch.Tensor:
    """Gather each unique id's row once, ``[cap, w]`` in the storage dtype;
    sentinels clip to the last row (``mode="clip"``; ``inv`` never points
    at them). ``col``: the table is stored transposed, ``[w, n]``; its
    columns are gathered and the small ``[w, cap]`` buffer transposed, so
    the caller sees the row layout's values."""
    n = _rows_of(table, col)
    _check_sentinel_range(n, useg.shape[-1])
    idx = useg.long().clamp(0, n - 1)
    return table[:, idx].t() if col else table[idx]


def device_compact_aux(ids: torch.Tensor, cap: int):
    """DEVICE-side :func:`compact_aux` of a ``[B, F]`` id batch, built
    inside the step (``compact_device``; the reference's
    ``device_compact_aux`` vmapped over the fields): one stable sort of
    the ``[F, B]`` ids, with static shapes and no read on the host.

    Returns ``((useg, segstart, segend, order, inv), nseg)``: the five
    int32 ``[F, ...]`` arrays of :func:`compact_aux`, bit for bit when no
    field overflows, and each field's segment count ``nseg`` ``[F]``. It
    cannot raise on overflow: segments past ``cap`` (the largest ids) get
    no slot, their lanes keep ``inv >= cap`` (the step zeroes their rows,
    ``sparse._compact_gather_all``) and their updates are never written:
    the reference's ``compact_overflow='drop'`` semantics. A slot index
    past ``cap`` lands in a spare slot ``cap`` that is cut off (JAX's
    ``mode="drop"``; an out-of-range index in torch would be a device
    assert).
    """
    cols = ids.t().contiguous()                             # [F, B]
    f, b = cols.shape
    sid, order = torch.sort(cols, dim=1, stable=True)
    run_start = torch.ones_like(sid, dtype=torch.bool)
    torch.ne(sid[:, 1:], sid[:, :-1], out=run_start[:, 1:])
    run_end = torch.ones_like(run_start)
    run_end[:, :-1] = run_start[:, 1:]
    seg = torch.cumsum(run_start, 1, dtype=torch.int32).sub_(1)
    nseg = seg[:, -1] + 1
    lane = torch.arange(b, dtype=torch.int32, device=ids.device).expand(f, b)
    fits = seg < cap
    start_tgt = torch.where(run_start & fits, seg, cap).long()
    end_tgt = torch.where(run_end & fits, seg, cap).long()

    def slots(fill, tgt, src):
        out = torch.full((f, cap + 1), fill, dtype=torch.int32,
                         device=ids.device)
        return out.scatter_(1, tgt, src)[:, :cap]

    useg = slots(0, start_tgt, sid.to(torch.int32))
    segstart = slots(b - 1, start_tgt, lane)
    segend = slots(b - 1, end_tgt, lane)
    # Padding slots (pos >= nseg) carry compact_aux's ascending
    # sentinels past the table.
    pos = torch.arange(cap, dtype=torch.int32, device=ids.device)[None, :]
    live = pos < nseg[:, None]
    useg = torch.where(live, useg, (pos - nseg[:, None]) + (_IMAX - cap))
    segstart = torch.where(live, segstart, b - 1)
    segend = torch.where(live, segend, b - 1)
    inv = torch.empty_like(seg).scatter_(1, order, seg)
    return (useg, segstart, segend, order.to(torch.int32), inv), nseg


# Block size of the two-level prefix in compact_apply (the reference's).
_CSUM_BLOCK = 512


# Run length of XLA's cumulative sums: a prefix along n > 16 elements is
# taken as sequential sums over runs of 16 plus the prefix of the runs'
# totals, taken the same way.
_SCAN_RUN = 16


def _run_prefix(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sums along ``dim`` (at most ``_SCAN_RUN``
    long), added one after another, each partial sum rounded to float32.
    On the card that is one ``torch.cumsum`` along a dimension that is not
    the innermost (and not the only one of more than one element): CUDA
    scans such a dimension with one float32 accumulator per column, in
    order (``tests/test_torch_package.py`` and ``chip_smoke.py`` hold it
    to the CPU's adds bit for bit); its first sum is ``0 + x[0]``, so
    ``x[0]`` is copied back (a −0.0 stays −0.0)."""
    if x.is_cuda and dim < x.dim() - 1 and x.numel() > x.shape[dim]:
        out = torch.cumsum(x, dim)
        out.select(dim, 0).copy_(x.select(dim, 0))
        return out
    parts = list(x.unbind(dim))
    for j in range(1, len(parts)):
        parts[j] = parts[j - 1] + parts[j]
    return torch.stack(parts, dim)


def _prefix_f32(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive float32 prefix sums along ``dim``, each partial sum
    rounded to float32 and associated as the reference's ``jnp.cumsum``
    (XLA's two-level scan): sequential sums over runs of 16
    (:func:`_run_prefix`) plus the prefix of the runs' totals, so the CPU
    and the card give the same bits, and they equal the reference's on
    the CPU. (``torch.cumsum`` over the whole dimension accumulates
    float32 in float64 on the CPU and scans in another order on the
    card.)"""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= _SCAN_RUN:
        return _run_prefix(x, 0).movedim(0, dim)
    pad = (-n) % _SCAN_RUN
    if pad:
        x = torch.cat([x, x.new_zeros((pad, *x.shape[1:]))], 0)
    runs = _run_prefix(x.reshape(-1, _SCAN_RUN, *x.shape[1:]), 1)
    off = _prefix_f32(runs[:, -1], 0)
    off = torch.cat([torch.zeros_like(off[:1]), off[:-1]], 0)
    out = (runs + off[:, None]).reshape(-1, *x.shape[1:])[:n]
    return out.movedim(0, dim)


def _blocked_segment_sums(sdelta, segstart, segend):
    """The reference's segment sums by a two-level blocked fp32 prefix:
    ``csum(end) − csum(start) + sdelta[start]`` per segment."""
    b, w = sdelta.shape
    blk = _CSUM_BLOCK
    pad = (-b) % blk
    padded = (torch.nn.functional.pad(sdelta, (0, 0, 0, pad)) if pad
              else sdelta)
    nb = padded.shape[0] // blk
    bl = _prefix_f32(padded.reshape(nb, blk, w), 1)            # in-block
    off = _prefix_f32(bl[:, -1, :], 0)                         # inclusive
    off = torch.cat([torch.zeros_like(off[:1]), off[:-1]], dim=0)

    def csum_at(pos):
        # Boundary positions are < b, so padding rows never enter.
        return bl[pos // blk, pos % blk] + off[pos // blk]

    start, end = segstart.long(), segend.long()
    return csum_at(end) - csum_at(start) + sdelta[start]


def compact_apply(table, delta, caux, mode, noise, urows,
                  segtotal_pallas: bool = False, col: bool = False):
    """Update half of the compact path: per-segment totals of the sorted
    fp32 deltas (the blocked prefix, or kernel A with ``segtotal_pallas``),
    then one write per unique id (:func:`_compact_write`). ``noise``:
    the SR bits ``[cap, w]`` for a bf16 ``dedup_sr`` table, else None.
    ``col``: the table is stored transposed; the totals are the same and
    the write goes to its columns."""
    useg, segstart, segend, order, inv = caux
    cap = useg.shape[-1]
    _check_sentinel_range(_rows_of(table, col), cap)
    o = order.long()
    if segtotal_pallas:
        totals = segsum_lib.segment_totals(
            delta.contiguous(), inv[o].to(torch.int32).contiguous(), cap,
            order=order.to(torch.int32).contiguous())
    else:
        totals = _blocked_segment_sums(delta[o].float().contiguous(),
                                       segstart, segend)
    return _compact_write(table, totals, useg, mode, noise, urows, col)


def _compact_write(table, totals, useg, mode, noise, urows,
                   col: bool = False):
    """The compact update's WRITE half, in place: ``add`` of the fp32
    totals for ``dedup``, stochastic-rounded set of ``urows + totals`` for
    ``dedup_sr``. Padding slots (``useg`` past the table) clamp to the
    last row and write nothing new there (see the module note). ``col``:
    the same values written to the columns of a transposed table."""
    n = _rows_of(table, col)
    real = useg < n
    if mode == "dedup":
        return _add_rows(table, useg, real, totals, col)
    idx = useg.long().clamp(max=n - 1)
    if mode != "dedup_sr":
        raise ValueError(f"compact write takes 'dedup' or 'dedup_sr', not {mode!r}")
    if urows is None:
        raise ValueError("dedup_sr needs noise= and urows=")
    vals = stochastic_round(urows.float() + totals, table.dtype, noise)
    # Every slot that clamps to row n-1 writes the value that row ends
    # with: the last real slot's if it is row n-1, else the row as it is.
    # The real slots are a prefix; the last one is found on the device.
    last = (real.sum() - 1).clamp(min=0).reshape(1)
    last_row = table[:, n - 1:n].t() if col else table[n - 1:n]
    fill = torch.where((useg.index_select(0, last) == n - 1)[:, None],
                       vals.index_select(0, last), last_row)
    src = torch.where(real[:, None], vals, fill)
    if col:
        return table.index_copy_(1, idx, src.t())
    return table.index_copy_(0, idx, src)


def compact_apply_totals(table, totals, caux, mode, noise, urows,
                         col: bool = False):
    """Apply precomputed ``[cap, w]`` fp32 totals (the fused backward's) —
    the write half of :func:`compact_apply`."""
    useg = caux[0]
    _check_sentinel_range(_rows_of(table, col), useg.shape[-1])
    return _compact_write(table, totals, useg, mode, noise, urows, col)


class _Dedup(NamedTuple):
    """The device dedup of one ids column: its ``B`` lanes sorted, and per
    segment ``s`` (one per distinct id) of which the first ``count`` are
    live."""
    order: torch.Tensor      # [B] int64: the stable sort order of the ids
    run_start: torch.Tensor  # [B] bool: sorted lane t starts a segment
    seg: torch.Tensor        # [B] int32: sorted lane t's segment
    useg: torch.Tensor       # [B]: segment s's id, ascending (live s only)
    count: torch.Tensor      # [1] int32: the number of segments
    totals: torch.Tensor     # [B, w] float32: s's total of delta (live s)


def _sort_segments(ids):
    """``(order, sid, run_start, seg)``: the stable sort order of ``ids``,
    the sorted ids, the run-start mask and each sorted lane's int32 rank
    (dense from 0, non-decreasing: kernel A's precondition)."""
    order = torch.argsort(ids, stable=True)
    sid = ids[order]
    run_start = torch.ones_like(sid, dtype=torch.bool)
    torch.ne(sid[1:], sid[:-1], out=run_start[1:])
    seg = torch.cumsum(run_start, 0, dtype=torch.int32).sub_(1)
    return order, sid, run_start, seg


def _dedup(ids, delta):
    """Segment duplicate ids on the device (:class:`_Dedup`), with each
    segment's float32 total of ``delta`` taken ONCE per segment by
    :func:`~fm_spark_tpu_torch.ops.segsum.segment_totals` (kernel A at
    cap = B, reading ``delta`` through the sort order in place; no
    atomics, so a repeat gives the same bits). The rows of ``totals`` past
    ``count`` are not written on the card. The sort is stable, as
    ``jnp.argsort``, so each segment's lanes are the reference's; only the
    order of the fp32 adds differs (JAX's ``segment_sum`` adds in lane
    order, as the plain version on the CPU does). No sync with the host:
    the segment count stays on the device."""
    order, sid, run_start, seg = _sort_segments(ids)
    totals = segsum_lib.segment_totals(delta.contiguous(), seg, ids.shape[0],
                                       order=order, zero_tail=False)
    # Every lane writes its id into its segment's slot: the writers of one
    # slot agree.
    useg = torch.empty_like(sid).scatter_(0, seg.long(), sid)
    return _Dedup(order, run_start, seg, useg, seg[-1:] + 1, totals)


def _dedup_by(ids, delta, keys=None):
    """:func:`_dedup` of the write ids ``ids``, segmented and summed by
    ``keys`` when given: a one-to-one relabelling of ``ids`` (the tiered
    store's global ids beside the hot-local ``ids``). Kernel A's order of
    the adds depends on where each segment sits among the sorted lanes,
    so sorting by the global ids puts every segment on the lanes it has
    in the untiered step and its total on the same bits; ``useg`` is then
    each segment's write id, that of its first sorted lane. Without
    ``keys`` this is ``_dedup(ids, delta)``."""
    if keys is None:
        return _dedup(ids, delta)
    d = _dedup(keys, delta)
    return d._replace(useg=ids[d.order[_first_lanes(d)]])


def _first_lanes(d: _Dedup) -> torch.Tensor:
    """Each segment's first lane in sorted order (0 past the count): the
    run starts write their positions into their segments' slots, every
    other lane into a spare slot, which is dropped."""
    b = d.seg.shape[0]
    first = torch.zeros(b + 1, dtype=torch.int64, device=d.seg.device)
    first.scatter_(0, torch.where(d.run_start, d.seg.long(), b),
                   torch.arange(b, device=d.seg.device))
    return first[:b]


def _add_rows(table, tgt, ok, upd, col: bool = False):
    """``table[tgt[m]] += upd[m]`` (in the table's dtype) for lanes with
    ``ok[m]``; the others add zero to a clamped row. ``col``: to the
    columns of a transposed table."""
    n = _rows_of(table, col)
    upd = torch.where(ok[:, None], upd,
                      torch.zeros((), dtype=upd.dtype, device=upd.device))
    idx = tgt.long().clamp(0, n - 1)
    if col:
        return table.index_add_(1, idx, upd.to(table.dtype).t())
    return table.index_add_(0, idx, upd.to(table.dtype))


def _set_rows(table, tgt, ok, vals):
    """``table[tgt[m]] = vals[m]`` for lanes with ``ok[m]`` (targets unique
    among them; if not, the highest such lane wins), the others writing
    nothing new. Every lane writes, to its target clamped into the table,
    the value its row ends with, so duplicate indices agree and no host
    sync is needed."""
    n, b = table.shape[0], tgt.shape[0]
    idx = tgt.long().clamp(0, n - 1)
    lane = torch.arange(b, device=table.device)
    owner = torch.full((n,), -1, dtype=torch.int64, device=table.device)
    owner.scatter_reduce_(0, idx, torch.where(ok, lane, -1), reduce="amax")
    src = owner[idx]
    final = torch.where((src >= 0)[:, None],
                        vals.to(table.dtype)[src.clamp(min=0)], table[idx])
    return table.index_copy_(0, idx, final)


def _aux_apply(table, delta, aux, mode, noise, old_rows):
    """Segment sums (kernel A, as :func:`_dedup`) and one write per unique
    id from the host's :func:`dedup_aux` (this field's ``[B]`` slices): no
    device sort. The totals past the segment count are never read: their
    ``useg`` is the ``INT32_MAX`` padding."""
    order, seg, useg, ord_first = (a.to(torch.int32).contiguous()
                                   for a in aux)
    totals = segsum_lib.segment_totals(delta.contiguous(), seg,
                                       delta.shape[0], order=order,
                                       zero_tail=False)
    useg = useg.long()
    ok = useg < table.shape[0]          # INT32_MAX padding: dropped
    if mode == "dedup":
        return _add_rows(table, useg, ok, totals)
    new_rows = old_rows[ord_first.long()].float() + totals
    return _set_rows(table, useg, ok,
                     stochastic_round(new_rows, table.dtype, noise))


def apply_split_row_updates(v, w, ids, delta):
    """The per-lane update of a FieldFM without the fused linear column, in
    place: ``delta`` ``[B, k]`` (factor columns) or ``[B, k+1]`` (then the
    linear one) summed once per distinct id by the device dedup (kernel A
    on the card, in a fixed order, so a step repeats bit for bit) and
    added, rounded once, to ``v`` ``[n, k]`` and, with the linear column,
    to ``w`` ``[n]``. This is the ``scatter_add`` of the reference's
    unfused form with one rounding per id, as the ``use_pallas``
    ``scatter_add``; an id in ``[-n, 0)`` counts from the end and any
    other out-of-range id is dropped."""
    n, k = v.shape
    if ids.shape[0] == 0:
        return
    d = _dedup(ids, delta)
    tgt = d.useg.long()
    tgt = torch.where(tgt < 0, tgt + n, tgt)
    live = torch.arange(tgt.shape[0], device=tgt.device) < d.count
    ok = live & (tgt >= 0) & (tgt < n)
    _add_rows(v, tgt, ok, d.totals[:, :k].contiguous())
    if delta.shape[1] > k:
        _add_rows(w.view(-1, 1), tgt, ok, d.totals[:, k:].contiguous())


def pallas_gather(table, ids):
    """The rows ``table[ids]`` by the gather kernel (``ops.rows``), ids
    CLAMPED into ``[0, n - 1]``: a negative id reads row 0, where the
    plain gather of the steps counts it from the end (the reference's two
    routes)."""
    return rows_lib.gather_rows(table, ids.to(torch.int32).contiguous())


def _pallas_dedup_add(table, ids, delta):
    """The device dedup, then one read-modify-write per unique id by the
    row-update kernel (``ops.rows``): the ``use_pallas`` form of both
    ``scatter_add`` and ``dedup``. Any id outside ``[0, n)``, a negative
    one too, is skipped by the update. Duplicates are summed
    in fp32 and rounded ONCE to the table's dtype: for bf16 tables more
    accurate than a rounding per duplicate, as in the reference."""
    d = _dedup(ids, delta)
    return rows_lib.update_rows_add(table, d.useg.to(torch.int32), None,
                                    d.totals, count=d.count)


def apply_row_updates(table, ids, delta, mode: str = "scatter_add",
                      noise=None, old_rows=None, use_pallas: bool = False,
                      aux=None):
    """Apply per-lane ``delta`` ([B, w]) to ``table`` ([n, w], storage
    dtype) at ``ids`` ([B]) in place, by ``mode``.

    ``old_rows`` ([B, w], compute dtype) are the lanes' gathered rows,
    needed by ``dedup_sr`` (the new value is formed in fp32 from them);
    ``noise`` the SR bits ``[B, w]`` of a bf16 ``dedup_sr`` table.
    ``use_pallas`` routes ``scatter_add``/``dedup`` through
    :func:`_pallas_dedup_add` (``dedup_sr`` keeps its set). ``aux`` is
    :func:`dedup_aux`'s ``(order, seg, useg, ord_first)`` for this ids
    column (a dedup mode): no device sort. As in JAX, an id in ``[-n, 0)``
    counts from the end and any other out-of-range id is dropped, except
    under ``use_pallas``, which drops every negative id.
    """
    if mode not in SPARSE_UPDATE_MODES:
        raise ValueError(f"unknown sparse_update mode {mode!r}")
    if aux is not None and mode == "scatter_add":
        raise ValueError("aux requires a dedup mode")
    if mode == "dedup_sr" and old_rows is None:
        raise ValueError("dedup_sr needs noise= and old_rows=")
    n = table.shape[0]
    if ids.shape[0] == 0:
        return table
    if aux is not None:
        return _aux_apply(table, delta, aux, mode, noise, old_rows)
    if use_pallas and mode in ("scatter_add", "dedup"):
        return _pallas_dedup_add(table, ids, delta)
    if mode == "scatter_add":
        idx = ids.long()
        idx = torch.where(idx < 0, idx + n, idx)
        return _add_rows(table, idx, (idx >= 0) & (idx < n), delta)

    d = _dedup(ids, delta)
    tgt = d.useg.long()
    tgt = torch.where(tgt < 0, tgt + n, tgt)
    live = torch.arange(tgt.shape[0], device=tgt.device) < d.count
    ok = live & (tgt >= 0) & (tgt < n)          # one write per segment
    if mode == "dedup":
        return _add_rows(table, tgt, ok, d.totals)
    # Each segment takes its first sorted lane's old row and SR bits, as
    # the reference's write at that lane.
    first = _first_lanes(d)
    new_rows = old_rows[d.order[first]].float() + d.totals
    return _set_rows(table, tgt, ok, stochastic_round(
        new_rows, table.dtype, None if noise is None else noise[first]))
