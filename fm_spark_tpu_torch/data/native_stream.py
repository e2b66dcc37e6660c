"""The raw-text stream at native parse rate (the port of
``fm_spark_tpu/data/native_stream.py``): :class:`NativeStreamBatches`
parses whole :class:`~fm_spark_tpu_torch.data.stream.ShardReader`-sized
chunks with the C++ chunk-row parsers (``fm_parse_*_rows`` in
``native/fasthash.cpp``) and rebuilds the per-record semantics of
:class:`~fm_spark_tpu_torch.data.stream.StreamBatches` from the per-row
status and consumed-bytes arrays:

- the same record stream: a native OK row equals the per-line Python
  parse bit for bit and passes the guard's value contract; every other
  row (malformed, outside the contract, or merely outside the strict
  native grammar, such as ``"+1"``) is parsed again by the per-line
  Python parser, so verdicts, quarantine reasons and dead-letter records
  are the same bytes;
- the same cursor: the reader's ``(epoch, shard, offset, lineno,
  records)`` advances by the consumed-bytes array as rows are CONSUMED
  into batches, so ``state()`` after batch k equals the Python path's and
  a cursor restores across the two paths in both directions;
- the same guard calls, in line order: ``ok_many`` for runs of good rows
  and one ``bad`` per bad row, so the counters, the breaker and the
  strict policy's raise points are the Python path's.

Wrapped in a :class:`~fm_spark_tpu_torch.data.Prefetcher`, chunk N+1
parses on the producer thread while batch N trains (the ctypes call
releases the GIL). The fault points: ``ingest_truncate`` per chunk read,
``ingest_corrupt`` once per parsed chunk (an injected error marks the
chunk's first record bad). Each chunk read runs under the
``ingest_chunk`` watchdog phase and the ``ingest/chunk_read`` span, each
parse in the ``ingest/chunk_parse`` span, and an epoch's end is an
``ingest_epoch`` event.

A library that does not build raises
:class:`~fm_spark_tpu_torch.native.NativeBuildError`; it never falls back.
"""

from __future__ import annotations

import time
from collections import deque

import numpy as np

from fm_spark_tpu_torch import native, obs
from fm_spark_tpu_torch.data.stream import (RecordGuard, ShardReader,
                                            StreamBatches, line_parser)
from fm_spark_tpu_torch.resilience import faults, watchdog

__all__ = ["NativeStreamBatches", "make_stream_batches",
           "native_stream_supported", "native_stream_unsupported_reason"]

_OK = native.STREAM_OK
_SKIP = native.STREAM_SKIP
_BAD = native.STREAM_REPARSE  # after Python resolution: bad, with reason
_HEADER = 3


def native_stream_unsupported_reason(dataset: str, max_nnz: int,
                                     bucket: int = 0) -> str | None:
    """Why the native chunk path cannot serve this configuration
    bit-identically, or None when it can: the dataset needs a chunk-row
    parser, and a fixed-field format a batch row as wide as its fields
    (below that every row fails the nnz contract; the Python path prices
    that case). A parser library that does not build raises
    :class:`~fm_spark_tpu_torch.native.NativeBuildError`."""
    if not native.stream_parse_available(dataset):
        return (f"no native chunk parser for {dataset!r} (the dataset "
                "has no chunk-row entry point)")
    fields = native.STREAM_FIELDS.get(dataset)
    if fields is not None:
        if int(max_nnz) < fields:
            return (f"max_nnz={max_nnz} < the {dataset} field count "
                    f"{fields} — every row would fail the nnz contract")
        if int(bucket) <= 0:
            return f"{dataset} needs a positive hash bucket, got {bucket}"
        if fields * int(bucket) > np.iinfo(np.int32).max:
            return (f"id space {fields}*{bucket} overflows int32 batch "
                    "ids")
    if int(max_nnz) < 1:
        return f"max_nnz must be >= 1, got {max_nnz}"
    return None


def native_stream_supported(dataset: str, max_nnz: int,
                            bucket: int = 0) -> bool:
    """Can the native chunk path serve this configuration bit-identically?
    (:func:`native_stream_unsupported_reason` says why not.)"""
    return native_stream_unsupported_reason(dataset, max_nnz, bucket) is None


def make_stream_batches(reader: ShardReader, dataset: str, batch_size: int,
                        max_nnz: int, guard: RecordGuard | None = None,
                        num_features: int = 0, bucket: int = 0,
                        zero_based: bool = False,
                        native_ingest: bool | str = "auto"):
    """Build the streaming batch source, native when possible.

    ``native_ingest``: ``"auto"`` (default) uses the C++ chunk path when
    :func:`native_stream_supported` says it can be bit-identical and
    falls back to :class:`StreamBatches` for a configuration outside the
    native contract (the ``--native-ingest`` rule; a library that does
    not build raises); ``True`` requires it (raises ``RuntimeError``);
    ``False`` forces the pure-Python path. The two return types speak
    the same batch-source protocol and produce bit-identical streams,
    cursors, and quarantine accounting.
    """
    if native_ingest not in (True, False, "auto"):
        raise ValueError(
            f"native_ingest must be True/False/'auto', got {native_ingest!r}"
        )
    reason = native_stream_unsupported_reason(dataset, max_nnz, bucket)
    supported = reason is None
    if native_ingest is True and not supported:
        raise RuntimeError(
            f"native ingest requested but unavailable: {reason}"
        )
    if native_ingest in (True, "auto") and supported:
        return NativeStreamBatches(
            reader, dataset, batch_size, max_nnz, guard=guard,
            num_features=num_features, bucket=bucket, zero_based=zero_based,
        )
    return StreamBatches(
        reader, line_parser(dataset, bucket, zero_based), batch_size,
        max_nnz, guard=guard, num_features=num_features,
    )


class _Block:
    """One chunk's parse result plus its consume cursor.

    ``status`` per row: OK (native- or oracle-parsed, admissible), SKIP
    (no record; counted by the cursor only), BAD (reason known — guard
    policy applies at consume time), HEADER (cursor's lineno/offset
    advance only, never ``records``).
    """

    __slots__ = ("shard", "path", "base_offset", "base_lineno",
                 "base_records", "buf", "n", "status", "ids", "vals",
                 "labels", "rowlen", "line_start", "end_off",
                 "records_cum", "good_pos", "bad_pos", "reasons", "pos")

    def line(self, r: int) -> bytes:
        start = int(self.line_start[r])
        return self.buf[start: start + int(self.rowlen[r])].rstrip(b"\r\n")


class NativeStreamBatches(StreamBatches):
    """:class:`StreamBatches` semantics at native parse rate.

    Drop-in batch source (``next_batch``/``state``/``restore``) over the
    same :class:`ShardReader` + :class:`RecordGuard`; the per-line
    Python parser is kept solely as the fallback oracle for rows the
    strict native grammar routes back (and for error formatting), so
    the record stream, cursor, and quarantine accounting are
    bit-identical to the pure-Python path. Wrap with
    :class:`~fm_spark_tpu.data.pipeline.Prefetcher` to parse chunk N+1
    on the producer thread while batch N trains.
    """

    def __init__(self, reader: ShardReader, dataset: str, batch_size: int,
                 max_nnz: int, guard: RecordGuard | None = None,
                 num_features: int = 0, bucket: int = 0,
                 zero_based: bool = False):
        reason = native_stream_unsupported_reason(dataset, max_nnz, bucket)
        if reason is not None:
            raise RuntimeError(f"native chunk parser unavailable: {reason}")
        super().__init__(reader, line_parser(dataset, bucket, zero_based),
                         batch_size, max_nnz, guard=guard,
                         num_features=num_features)
        self._dataset = dataset
        self._bucket = int(bucket)
        self._zero_based = bool(zero_based)
        self._fields = native.STREAM_FIELDS.get(dataset, self.max_nnz)
        self._chunk_bytes = self._reader.chunk_bytes
        self._blocks: deque[_Block] = deque()
        self._rfh = None
        self._rtail = b""
        self._sync_read()

    # --------------------------------------------------------- read-ahead

    def _sync_read(self) -> None:
        """Point the parse-ahead position at the reader's cursor."""
        if self._rfh is not None:
            self._rfh.close()
            self._rfh = None
        self._rtail = b""
        self._blocks.clear()
        self._read_shard = self._reader.shard
        self._read_offset = self._reader.offset
        self._read_lineno = self._reader.lineno
        self._ahead_records = self._reader.records

    def _fill_block(self) -> _Block | None:
        """Read + parse the next chunk of complete lines; ``None`` at the
        end of the shard list (the caller rewinds for the next epoch)."""
        paths = self._reader.paths
        while True:
            if self._read_shard >= len(paths):
                return None
            if self._rfh is None:
                self._rfh = open(paths[self._read_shard], "rb")
                if self._read_offset:
                    self._rfh.seek(self._read_offset)
                self._rtail = b""
            with watchdog.phase("ingest_chunk"):
                faults.inject("ingest_truncate")
                with obs.span("ingest/chunk_read", shard=self._read_shard):
                    chunk = self._rfh.read(self._chunk_bytes)
            if chunk:
                buf = self._rtail + chunk
                nl = buf.rfind(b"\n")
                if nl < 0:
                    self._rtail = buf
                    continue
                self._rtail = buf[nl + 1:]
                data = buf[:nl + 1]
                blk = self._parse_block(self._read_shard, self._read_offset,
                                        self._read_lineno, data, False)
                self._read_offset += len(data)
                self._read_lineno += blk.n
                return blk
            # Shard EOF: flush a final unterminated line, then advance.
            tail, self._rtail = self._rtail, b""
            self._rfh.close()
            self._rfh = None
            shard = self._read_shard
            base_off, base_ln = self._read_offset, self._read_lineno
            self._read_shard += 1
            self._read_offset = 0
            self._read_lineno = 0
            if tail:
                return self._parse_block(shard, base_off, base_ln, tail,
                                         True)

    def _parse_block(self, shard: int, base_offset: int, base_lineno: int,
                     data: bytes, unterminated: bool) -> _Block:
        # Deterministic data-fault hook (per CHUNK on this path): an
        # injected 'error' marks the chunk's first record bad and takes
        # the policy path; device loss is the supervisor's to classify.
        forced_reason = None
        try:
            faults.inject("ingest_corrupt")
        except faults.InjectedDeviceLoss:
            raise
        except faults.FaultInjected as e:
            forced_reason = str(e) or type(e).__name__
        if unterminated:
            data += b"\n"
        with obs.span("ingest/chunk_parse", shard=shard,
                      bytes=len(data)) as sp:
            ids, vals, labels, status, rowlen = native.parse_stream_chunk(
                self._dataset, data, bucket=self._bucket,
                num_features=self.num_features, max_nnz=self.max_nnz,
                zero_based=self._zero_based)
            sp.set(rows=int(status.shape[0]))
        blk = _Block()
        blk.shard = shard
        blk.path = self._reader.paths[shard]
        blk.base_offset = base_offset
        blk.base_lineno = base_lineno
        blk.buf = data
        blk.n = status.shape[0]
        blk.status = status
        blk.ids = ids
        blk.vals = vals
        blk.labels = labels
        blk.rowlen = rowlen
        if unterminated:
            rowlen[-1] -= 1  # the appended terminator is not on disk
        blk.line_start = np.cumsum(rowlen) - rowlen
        blk.reasons = {}
        # Header skip by MATCH at the shard's first line only (the
        # ShardReader rule: split shards must not lose one row each).
        prefix = self._reader.header_prefix
        if (prefix is not None and base_lineno == 0 and blk.n
                and data.startswith(prefix)):
            status[0] = _HEADER
        if forced_reason is not None:
            # Attach to the first line the per-record path would have
            # injected at: blank lines are skipped BEFORE the Python
            # inject point (never headers either), but comment-only
            # lines are eligible — parse runs after inject there.
            for r in range(blk.n):
                if status[r] != _HEADER and blk.line(r).strip():
                    status[r] = _BAD
                    blk.reasons[r] = forced_reason
                    break
        self._resolve_reparse(blk)
        blk.end_off = np.cumsum(rowlen)
        blk.records_cum = np.concatenate(
            [[0], np.cumsum(status != _HEADER)])
        blk.good_pos = np.flatnonzero(status == _OK)
        blk.bad_pos = np.flatnonzero(status == _BAD)
        blk.base_records = self._ahead_records
        self._ahead_records += int(blk.records_cum[-1])
        blk.pos = 0
        return blk

    def _resolve_reparse(self, blk: _Block) -> None:
        """Route rows outside the strict native grammar through the
        per-line Python oracle: a row it parses AND the value contract
        admits is patched into the arrays (bit-identical by
        construction); everything else keeps the oracle's exact reason
        for the guard's consume-time verdict."""
        S = self.max_nnz
        for r in np.flatnonzero(blk.status == _BAD):
            r = int(r)
            if r in blk.reasons:
                continue  # the injected-fault row: verdict already forced
            line = blk.line(r)
            try:
                row = self._parse(line)
            except ValueError as e:
                blk.reasons[r] = str(e) or type(e).__name__
                continue
            if row is None:
                blk.status[r] = _SKIP
                continue
            label, idx, val = row
            reason = RecordGuard.violation(
                label, idx, val, num_features=self.num_features,
                max_nnz=S)
            if reason is not None:
                blk.reasons[r] = reason
                continue
            k = min(len(idx), blk.ids.shape[1])
            blk.ids[r] = 0
            blk.ids[r, :k] = idx[:k]
            if blk.vals is not None:
                blk.vals[r] = 0.0
                blk.vals[r, :k] = val[:k]
            blk.labels[r] = label
            blk.status[r] = _OK

    # ------------------------------------------------------------ consume

    def _head_block(self) -> _Block | None:
        while True:
            if self._blocks:
                blk = self._blocks[0]
                if blk.pos < blk.n:
                    return blk
                self._blocks.popleft()
                continue
            blk = self._fill_block()
            if blk is None:
                return None
            self._blocks.append(blk)

    def _process_guard_range(self, blk: _Block, lo: int, hi: int) -> None:
        """Replay the guard over consumed rows in line order: bulk
        ``ok_many`` for runs of good rows, a per-row ``bad`` (policy
        raise point included) for each bad row."""
        goods, bads = blk.good_pos, blk.bad_pos
        g_lo = int(np.searchsorted(goods, lo))
        g_hi = int(np.searchsorted(goods, hi))
        b_lo = int(np.searchsorted(bads, lo))
        b_hi = int(np.searchsorted(bads, hi))
        if b_lo == b_hi:
            if g_hi > g_lo:
                self.guard.ok_many(g_hi - g_lo)
            return
        gptr = g_lo
        for bi in range(b_lo, b_hi):
            b = int(bads[bi])
            g_end = int(np.searchsorted(goods, b))
            if g_end > gptr:
                self.guard.ok_many(g_end - gptr)
                gptr = g_end
            self.guard.bad(blk.path, blk.base_lineno + b + 1, blk.line(b),
                           blk.reasons.get(b, "bad record"))
        if g_hi > gptr:
            self.guard.ok_many(g_hi - gptr)

    def _advance_cursor(self, blk: _Block, cut: int) -> None:
        r = self._reader
        r.shard = blk.shard
        r.offset = blk.base_offset + int(blk.end_off[cut - 1])
        r.lineno = blk.base_lineno + cut
        r.records = blk.base_records + int(blk.records_cum[cut])

    def _take_from_block(self, blk: _Block, need: int, out_ids, out_vals,
                         out_labels, taken: int) -> int:
        """Consume rows from ``blk`` into the output arrays: up to
        ``need`` good rows, plus every skip/bad row before the last one
        taken (or the whole block remainder when no good rows are
        left). Returns the number of good rows taken."""
        goods = blk.good_pos
        g_lo = int(np.searchsorted(goods, blk.pos))
        avail = goods.shape[0] - g_lo
        take = min(need, avail)
        cut = blk.n if take == 0 else int(goods[g_lo + take - 1]) + 1
        self._process_guard_range(blk, blk.pos, cut)
        if take:
            w = blk.ids.shape[1]
            if cut - blk.pos == take:  # contiguous good run: one copy
                sel = slice(blk.pos, cut)
            else:
                sel = goods[g_lo: g_lo + take]
            out_ids[taken: taken + take, :w] = blk.ids[sel]
            if blk.vals is not None:
                out_vals[taken: taken + take, :w] = blk.vals[sel]
            else:
                out_vals[taken: taken + take, :self._fields] = 1.0
            out_labels[taken: taken + take] = blk.labels[sel]
        self._advance_cursor(blk, cut)
        blk.pos = cut
        return take

    def next_batch(self):
        """Return ``(ids, vals, labels, weights)`` with static shapes
        ``[B, S] / [B, S] / [B] / [B]``, advancing the cursor — the
        :class:`StreamBatches` contract, assembled by array slice
        instead of per-row Python."""
        t_batch0 = time.perf_counter()
        b, S = self.batch_size, self.max_nnz
        ids = np.zeros((b, S), np.int32)
        vals = np.zeros((b, S), np.float32)
        labels = np.zeros((b,), np.float32)
        weights = np.zeros((b,), np.float32)
        taken = 0
        empty_passes = 0
        while taken < b:
            blk = self._head_block()
            if blk is None:
                # End of the shard list: rewind for the next epoch —
                # pad the final partial batch, or apply the empty-pass
                # rule on a batch with no rows yet.
                if taken:
                    self._rewind_epoch()
                    break
                empty_passes += 1
                if self.guard.n_ok == 0 or empty_passes >= 2:
                    raise ValueError(
                        "no parseable records in an entire pass over "
                        f"{len(self._reader.paths)} shard(s) "
                        f"({self.guard.n_bad} quarantined)"
                    )
                self._rewind_epoch()
                continue
            taken += self._take_from_block(blk, b - taken, ids, vals,
                                           labels, taken)
        weights[:taken] = 1.0
        self._cursor = dict(self._reader.state(),
                            **self.guard.counters())
        self._note_ingest(taken, time.perf_counter() - t_batch0)
        return ids, vals, labels, weights

    def _rewind_epoch(self) -> None:
        self._reader.rewind()
        obs.event("ingest_epoch", epoch=self._reader.epoch,
                  records=self._reader.records)
        self._read_shard = 0
        self._read_offset = 0
        self._read_lineno = 0

    # ------------------------------------------------------------- cursor

    def restore(self, state: dict) -> None:
        super().restore(state)
        self._sync_read()

    def close(self) -> None:
        if self._rfh is not None:
            self._rfh.close()
            self._rfh = None
        self._blocks.clear()
        self._reader.close()
