"""Sparse row updates of the fused FieldFM step: the compact path, stochastic
rounding, and scatter-add (the port of ``fm_spark_tpu/ops/scatter.py``).

Write strategies (``TrainConfig.sparse_update``):

- ``"scatter_add"``: ``index_add_`` of every lane's delta.
- ``"dedup"`` with the compact aux: per-segment totals of the sorted
  deltas, then one add per unique id.
- ``"dedup_sr"`` with the compact aux: one stochastic-rounded set per
  unique id of ``urows + totals``.

Tables are updated IN PLACE (the JAX package donates them; the port never
holds a second copy of a 1.33 GB table set) and returned.

Out-of-range writes: XLA's ``mode="drop"`` has no torch counterpart, and
an out-of-range ``index_add_``/``index_copy_`` on CUDA is a device-side
assert. The compact aux pads each field's ``useg`` with sentinels past the
table, so a write clamps every index into the table and makes the padding
slots' writes no-ops (an add of zero, or a set of the value the row ends
with), with no device-to-host sync to count the real slots.

SR noise: JAX draws threefry bits per (step, field) key. The port draws
them from a ``torch.Generator`` on the device seeded from (seed + 0x5EED,
step, field), so a re-run or resume draws the same bits, which equal
JAX's in distribution only; :func:`stochastic_round` takes the bits as an
argument so tests can inject JAX's.
"""

from __future__ import annotations

import numpy as np
import torch

from fm_spark_tpu_torch.ops import segsum as segsum_lib

__all__ = ["SPARSE_UPDATE_MODES", "CompactCapOverflow", "SrNoise",
           "apply_row_updates", "compact_apply", "compact_apply_totals",
           "compact_aux", "compact_gather", "stochastic_round"]

SPARSE_UPDATE_MODES = ("scatter_add", "dedup", "dedup_sr")

_IMAX = np.iinfo(np.int32).max


class CompactCapOverflow(ValueError):
    """A field's per-batch unique-id count exceeded ``compact_cap``."""


def _mix64(z: int) -> int:
    """splitmix64's finaliser: a well-spread 64-bit hash of ``z``."""
    z &= 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return z ^ (z >> 31)


class SrNoise:
    """SR noise bits: ``noise(step, field, shape)`` → int32 values in
    ``[0, 65536)`` on ``device``, deterministic in (seed, step, field).
    ``seed`` is the config's ``seed + 0x5EED``, as the reference's key."""

    def __init__(self, seed: int, device):
        self.seed = int(seed)
        self.device = torch.device(device)
        self._gen = torch.Generator(device=self.device)

    def __call__(self, step: int, field: int, shape) -> torch.Tensor:
        s = _mix64(_mix64(_mix64(self.seed) + int(step)) + int(field))
        self._gen.manual_seed(s & 0x7FFFFFFFFFFFFFFF)
        return torch.randint(0, 1 << 16, tuple(shape), generator=self._gen,
                             device=self.device, dtype=torch.int32)


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


def compact_aux(ids, cap: int):
    """HOST-side aux of the compact update for a ``[B, F]`` id batch
    (numpy; int-exact with the reference's builder). Returns ``(useg,
    segstart, segend, order, inv)``, all int32:

    - ``useg`` [F, cap]: each field's unique ids, ascending, padded with
      DISTINCT ascending sentinels ``INT32_MAX - cap + j`` past the table;
    - ``segstart`` / ``segend`` [F, cap]: first / last sorted-lane index of
      each segment (padding: ``B - 1``);
    - ``order`` [F, B]: each field's stable argsort of the ids;
    - ``inv`` [F, B]: the segment of each ORIGINAL lane.

    Raises :class:`CompactCapOverflow` if a field has more than ``cap``
    unique ids.
    """
    ids = np.asarray(ids)
    if ids.ndim != 2:
        raise ValueError("compact_aux expects [B, F] ids")
    b, f = ids.shape
    if cap < 1 or cap > max(b, 1):
        raise ValueError(f"cap must be in [1, B], got {cap} (B={b})")
    if b and ids.min() < 0:
        raise ValueError("compact_aux requires non-negative ids")
    if b and int(ids.max()) >= _IMAX - cap:
        raise ValueError("id space collides with the sentinel range")

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
            raise CompactCapOverflow(
                f"field {j}: {s} unique ids > compact cap {cap}; raise "
                "compact_cap (it must bound the per-field per-batch "
                "unique-id count)"
            )
        useg[j, :s] = u
        useg[j, s:] = sentinel[: cap - s]
        segstart[j, :s] = first
        segend[j, :s] = np.r_[first[1:] - 1, b - 1] if s else []
        seg_of_sorted = np.cumsum(
            np.r_[0, (sid[1:] != sid[:-1]).astype(np.int32)]
        ) if b else np.empty(0, np.int64)
        inv[j, order[j]] = seg_of_sorted
    return useg, segstart, segend, order, inv


def _check_sentinel_range(bucket: int, cap: int) -> None:
    """The table must end below the sentinel range ``[INT32_MAX - cap,
    INT32_MAX)``, so padding slots are never real rows."""
    if bucket > _IMAX - cap:
        raise ValueError(
            f"table bucket dim {bucket} collides with the compact "
            f"sentinel range [{_IMAX - cap}, {_IMAX}); shard or split the "
            "table below INT32_MAX - cap rows"
        )


def compact_gather(table: torch.Tensor, useg: torch.Tensor) -> torch.Tensor:
    """Gather each unique id's row once, ``[cap, w]`` in the storage dtype;
    sentinels clip to the last row (``mode="clip"``; ``inv`` never points
    at them)."""
    n = table.shape[0]
    _check_sentinel_range(n, useg.shape[-1])
    return table[useg.long().clamp(0, n - 1)]


# Block size of the two-level prefix in compact_apply (the reference's).
_CSUM_BLOCK = 512


def _blocked_segment_sums(sdelta, segstart, segend):
    """The reference's segment sums by a two-level blocked fp32 prefix:
    ``csum(end) − csum(start) + sdelta[start]`` per segment."""
    b, w = sdelta.shape
    blk = _CSUM_BLOCK
    pad = (-b) % blk
    padded = (torch.nn.functional.pad(sdelta, (0, 0, 0, pad)) if pad
              else sdelta)
    nb = padded.shape[0] // blk
    bl = torch.cumsum(padded.reshape(nb, blk, w), dim=1)      # in-block
    off = torch.cumsum(bl[:, -1, :], dim=0)                   # inclusive
    off = torch.cat([torch.zeros_like(off[:1]), off[:-1]], dim=0)

    def csum_at(pos):
        # Boundary positions are < b, so padding rows never enter.
        return bl[pos // blk, pos % blk] + off[pos // blk]

    start, end = segstart.long(), segend.long()
    return csum_at(end) - csum_at(start) + sdelta[start]


def compact_apply(table, delta, caux, mode, noise, urows,
                  segtotal_pallas: bool = False):
    """Update half of the compact path: per-segment totals of the sorted
    fp32 deltas (the blocked prefix, or kernel A with ``segtotal_pallas``),
    then one write per unique id (:func:`_compact_write`). ``noise``:
    the SR bits ``[cap, w]`` for a bf16 ``dedup_sr`` table, else None."""
    useg, segstart, segend, order, inv = caux
    cap = useg.shape[-1]
    _check_sentinel_range(table.shape[0], cap)
    o = order.long()
    sdelta = delta[o].float().contiguous()
    if segtotal_pallas:
        totals = segsum_lib.segment_totals(sdelta, inv[o].contiguous(), cap)
    else:
        totals = _blocked_segment_sums(sdelta, segstart, segend)
    return _compact_write(table, totals, useg, mode, noise, urows)


def _compact_write(table, totals, useg, mode, noise, urows):
    """The compact update's WRITE half, in place: ``add`` of the fp32
    totals for ``dedup``, stochastic-rounded set of ``urows + totals`` for
    ``dedup_sr``. Padding slots (``useg`` past the table) clamp to the
    last row and write nothing new there (see the module note)."""
    n = table.shape[0]
    real = useg < n
    idx = useg.long().clamp(max=n - 1)
    if mode == "dedup":
        upd = torch.where(real[:, None], totals,
                          torch.zeros((), dtype=totals.dtype,
                                      device=totals.device))
        return table.index_add_(0, idx, upd.to(table.dtype))
    if mode != "dedup_sr":
        raise ValueError(f"compact write takes 'dedup' or 'dedup_sr', not {mode!r}")
    if urows is None:
        raise ValueError("dedup_sr needs noise= and urows=")
    vals = stochastic_round(urows.float() + totals, table.dtype, noise)
    # Every slot that clamps to row n-1 writes the value that row ends
    # with: the last real slot's if it is row n-1, else the row as it is.
    last = real.sum() - 1
    fill = torch.where(useg[last] == n - 1, vals[last], table[n - 1])
    src = torch.where(real[:, None], vals, fill)
    return table.index_copy_(0, idx, src)


def compact_apply_totals(table, totals, caux, mode, noise, urows):
    """Apply precomputed ``[cap, w]`` fp32 totals (the fused backward's) —
    the write half of :func:`compact_apply`."""
    useg = caux[0]
    _check_sentinel_range(table.shape[0], useg.shape[-1])
    return _compact_write(table, totals, useg, mode, noise, urows)


def apply_row_updates(table, ids, delta, mode: str = "scatter_add"):
    """Add per-lane ``delta`` ([B, w]) to ``table`` rows ``ids`` ([B]) in
    place, in the table's dtype. As in JAX, an id in ``[-n, 0)`` counts
    from the end and any other out-of-range id is dropped. Only
    ``scatter_add`` is ported: the non-compact dedup modes wait for a later
    slice (ROADMAP Queue 1)."""
    if mode not in SPARSE_UPDATE_MODES:
        raise ValueError(f"unknown sparse_update mode {mode!r}")
    if mode != "scatter_add":
        raise ValueError(
            f"sparse_update={mode!r} without the compact aux is not ported "
            "yet (ROADMAP Queue 1); use host_dedup with compact_cap > 0")
    n = table.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + n, ids)
    valid = (ids >= 0) & (ids < n)
    upd = torch.where(valid[:, None], delta,
                      torch.zeros((), dtype=delta.dtype, device=delta.device))
    return table.index_add_(0, torch.where(valid, ids, 0),
                            upd.to(table.dtype))
