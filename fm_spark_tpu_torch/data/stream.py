"""Raw-text streaming ingest: bounded-memory shard reading, per-record
error policies and an exactly-once resumable cursor (the port of
``fm_spark_tpu/data/stream.py``).

- :class:`ShardReader` walks an ordered list of text shards in
  fixed-size chunks (one chunk and one carried partial line resident at a
  time) and keeps the cursor ``(epoch, shard, offset, lineno, records)``,
  exact at line granularity, so ``restore()`` seeks straight to the next
  unconsumed line.
- :class:`RecordGuard` holds each record to the schema contract (a
  parseable row, a finite label and values, ids inside the hash bucket,
  nnz ≤ S) under two policies: ``strict`` raises :class:`BadRecord` with
  ``path:lineno``; ``quarantine`` journals the record to
  ``<quarantine_dir>/deadletter.jsonl`` (an
  :class:`~fm_spark_tpu_torch.utils.logging.EventLog`) and goes on. The
  bad-record-rate breaker raises :class:`IngestAborted` when more than
  ``max_bad_frac`` of a trailing window is bad.
- :class:`StreamBatches` turns reader, parser and guard into the
  batch-source protocol (``next_batch``/``state``/``restore``) with fixed
  shapes; the epoch's last batch is padded with ``weight=0`` rows, and
  ``state()`` is the cursor as of the last emitted batch, so a
  checkpointed kill-and-resume run consumes every record exactly once.

The counters ``ingest.rows_ok_total`` and
``ingest.rows_quarantined_total`` and the gauge ``ingest.rows_per_sec``
live in the port's metrics registry (:mod:`fm_spark_tpu_torch.obs`).
Each chunk read runs under the ``ingest_chunk`` watchdog phase and the
``ingest/chunk_read`` span; an epoch's end is an ``ingest_epoch`` event;
the breaker's abort is an ``ingest_aborted`` event and a flight dump;
the dead-letter journal is mirrored into the flight recorder's ring. The
fault points ``ingest_truncate`` (per chunk read) and ``ingest_corrupt``
(per record, before its parse) call
:func:`fm_spark_tpu_torch.resilience.faults.inject`.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque

import numpy as np

from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.resilience import faults, watchdog
from fm_spark_tpu_torch.utils.logging import EventLog

__all__ = ["DEAD_LETTER_FILE", "POLICIES", "BadRecord", "IngestAborted",
           "RecordGuard", "ShardReader", "StreamBatches", "line_parser",
           "preview_line"]

#: Dead-letter journal filename inside a quarantine directory.
DEAD_LETTER_FILE = "deadletter.jsonl"

#: Per-record error policies (the rate breaker rides ``quarantine``
#: whenever ``max_bad_frac < 1``).
POLICIES = ("strict", "quarantine")


def preview_line(line: bytes, limit: int = 160) -> str:
    """A truncated, repr-escaped preview of a raw line, safe to embed in
    an error message or a JSONL record."""
    if isinstance(line, str):
        line = line.encode("utf-8", "replace")
    text = repr(line[:limit])
    if len(line) > limit:
        text += f"... ({len(line)} bytes)"
    return text


class BadRecord(ValueError):
    """A record that fails the schema contract, with its source context."""

    def __init__(self, path: str, lineno: int, reason: str,
                 line: bytes = b""):
        self.path = str(path)
        self.lineno = int(lineno)
        self.reason = str(reason)
        msg = f"{self.path}:{self.lineno}: {self.reason}"
        if line:
            msg += f" — line {preview_line(line)}"
        super().__init__(msg)


class IngestAborted(RuntimeError):
    """The bad-record-rate breaker tripped: more than ``max_bad_frac`` of
    the trailing window was bad."""


class ShardReader:
    """Bounded-memory, ordered, line-oriented reader over text shards.

    Reads each shard of ``paths`` in ``chunk_bytes`` chunks and yields
    complete lines. ``offset`` is the byte offset of the next UNCONSUMED
    line of the current shard (not the read-ahead position). ``rewind()``
    starts the next epoch; ``records`` counts emitted lines over all
    epochs. ``header_prefix`` consumes the first line of a shard only when
    it starts with that prefix (``b"id,"`` for Avazu CSV): a shard list
    split from a headered file carries the header in shard 0 only. A
    skipped header counts toward ``lineno`` (1-based file lines), never
    toward ``records``; ``b""`` matches every first line.
    """

    def __init__(self, paths, chunk_bytes: int = 1 << 20,
                 header_prefix: bytes | None = None):
        if isinstance(paths, (str, bytes, os.PathLike)):
            paths = [paths]
        self.paths = [str(p) for p in paths]
        if not self.paths:
            raise ValueError("ShardReader needs at least one shard path")
        self.chunk_bytes = max(int(chunk_bytes), 1)
        self.header_prefix = header_prefix
        self.epoch = 0
        self.shard = 0
        self.offset = 0
        self.lineno = 0     # lines consumed from the current shard
        self.records = 0    # lines emitted, lifetime (headers excluded)
        self._fh = None
        self._pending: deque[bytes] = deque()
        self._tail = b""
        self._eof = False

    def state(self) -> dict:
        return {"epoch": self.epoch, "shard": self.shard,
                "offset": self.offset, "lineno": self.lineno,
                "records": self.records, "shards": len(self.paths)}

    def restore(self, state: dict) -> None:
        if int(state.get("shards", len(self.paths))) != len(self.paths):
            raise ValueError(
                f"restoring a {state.get('shards')}-shard cursor onto "
                f"{len(self.paths)} shard(s) — the shard list changed, "
                "so byte offsets no longer address the same records")
        self._drop()
        self.epoch = int(state["epoch"])
        self.shard = int(state["shard"])
        self.offset = int(state["offset"])
        self.lineno = int(state["lineno"])
        self.records = int(state.get("records", 0))

    def rewind(self) -> None:
        """Start the next epoch at shard 0, byte 0."""
        self._drop()
        self.epoch += 1
        self.shard = 0
        self.offset = 0
        self.lineno = 0

    def _drop(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None
        self._pending.clear()
        self._tail = b""
        self._eof = False

    def _open(self) -> None:
        self._fh = open(self.paths[self.shard], "rb")
        if self.offset:
            self._fh.seek(self.offset)
        self._tail = b""
        self._eof = False

    def _fill(self) -> None:
        """Read ONE chunk into the pending lines, under the
        ``ingest_chunk`` deadline (a hung shard read becomes a structured
        ``HangDetected``)."""
        with watchdog.phase("ingest_chunk"):
            faults.inject("ingest_truncate")
            with obs.span("ingest/chunk_read", shard=self.shard):
                chunk = self._fh.read(self.chunk_bytes)
        if not chunk:
            if self._tail:
                self._pending.append(self._tail)   # an unterminated last line
                self._tail = b""
            self._eof = True
            return
        buf = self._tail + chunk
        nl = buf.rfind(b"\n")
        if nl < 0:
            self._tail = buf
            return
        self._tail = buf[nl + 1:]
        self._pending.extend(buf[:nl + 1].splitlines(keepends=True))

    def next_line(self):
        """``(shard_index, lineno, line)`` with the terminator stripped,
        advancing the cursor; ``StopIteration`` after the last shard's
        last line (:meth:`rewind` starts another epoch)."""
        while True:
            if self._fh is None:
                if self.shard >= len(self.paths):
                    raise StopIteration
                self._open()
            while not self._pending and not self._eof:
                self._fill()
            if self._pending:
                raw = self._pending.popleft()
                self.offset += len(raw)
                self.lineno += 1
                if (self.header_prefix is not None and self.lineno == 1
                        and raw.startswith(self.header_prefix)):
                    continue
                self.records += 1
                return self.shard, self.lineno, raw.rstrip(b"\r\n")
            self._fh.close()
            self._fh = None
            self._eof = False
            self.shard += 1
            self.offset = 0
            self.lineno = 0

    def close(self) -> None:
        self._drop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordGuard:
    """Schema contract, per-record error policy and rate breaker.

    ``strict`` raises :class:`BadRecord` at the first bad record;
    ``quarantine`` journals each as a ``bad_record`` event in
    ``<quarantine_dir>/deadletter.jsonl`` and goes on. Under quarantine,
    when ``max_bad_frac < 1`` and the bad fraction of the trailing
    ``window`` records (once ``min_records`` were seen) exceeds it, an
    ``ingest_aborted`` event is journaled and :class:`IngestAborted`
    raised. ``windowed=False`` is for the in-memory loaders, which report
    the bad lines during the parse and the good count in one
    :meth:`ok_many` after it: they call :meth:`check_overall` instead.

    The counters ``n_ok``/``n_bad`` ride the stream's cursor through
    :meth:`counters`/:meth:`restore`; the trailing window restarts on a
    restore.
    """

    def __init__(self, policy: str = "strict", quarantine_dir=None,
                 max_bad_frac: float = 1.0, window: int = 1024,
                 min_records: int = 100, journal=None,
                 windowed: bool = True):
        if policy not in POLICIES:
            raise ValueError(
                f"unknown data policy {policy!r} (know {POLICIES})")
        if not (0.0 <= float(max_bad_frac) <= 1.0):
            raise ValueError(
                f"max_bad_frac must be in [0, 1], got {max_bad_frac}")
        self.policy = policy
        self.max_bad_frac = float(max_bad_frac)
        self.n_ok = 0
        self.n_bad = 0
        self._window: deque[int] = deque(maxlen=max(int(window), 1))
        self._window_bad = 0
        self._min_records = max(1, min(int(min_records), int(window)))
        self._windowed = bool(windowed)
        self.journal = journal
        self.quarantine_dir = quarantine_dir
        self.dead_letter_path = None
        self._dead = None
        if quarantine_dir is not None:
            os.makedirs(str(quarantine_dir), exist_ok=True)
            self.dead_letter_path = os.path.join(str(quarantine_dir),
                                                 DEAD_LETTER_FILE)
            # Mirrored into the flight recorder's ring: the last-N crash
            # window carries the quarantine's narrative.
            self._dead = EventLog(self.dead_letter_path, keep=False,
                                  mirror_to_flight=True,
                                  path_class="quarantine")
        self._c_ok = obs.counter("ingest.rows_ok_total")
        self._c_bad = obs.counter("ingest.rows_quarantined_total")

    def _push(self, bit: int) -> None:
        """Append to the trailing window and evaluate the breaker, on
        every record (O(1))."""
        if len(self._window) == self._window.maxlen:
            self._window_bad -= self._window[0]
        self._window.append(bit)
        self._window_bad += bit
        n = len(self._window)
        if (self._windowed and self.max_bad_frac < 1.0
                and n >= self._min_records
                and self._window_bad / n > self.max_bad_frac):
            self._abort(self._window_bad / n, n)

    def ok(self) -> None:
        """Count one record that passed the contract."""
        self.n_ok += 1
        self._c_ok.add(1)
        self._push(0)

    def ok_many(self, n: int) -> None:
        """Count ``n`` good records at once."""
        n = int(n)
        self.n_ok += n
        self._c_ok.add(n)
        for _ in range(min(n, self._window.maxlen)):
            self._push(0)

    def bad(self, path, lineno, line, reason) -> None:
        """Route one bad record through the policy."""
        if self.policy == "strict":
            raise BadRecord(path, lineno, reason, line)
        self.n_bad += 1
        self._c_bad.add(1)
        if self._dead is not None:
            self._dead.emit("bad_record", path=str(path),
                            lineno=int(lineno), reason=str(reason),
                            line=preview_line(line))
        self._push(1)

    def on_error(self, path, lineno, line, reason) -> None:
        """The text parsers' ``on_error`` callback."""
        self.bad(path, lineno, line, reason)

    def check_overall(self) -> None:
        """The whole-load breaker of the in-memory loaders: the overall
        bad fraction after a full parse."""
        total = self.n_ok + self.n_bad
        if self.max_bad_frac >= 1.0 or total == 0:
            return
        frac = self.n_bad / total
        if frac > self.max_bad_frac:
            self._abort(frac, total)

    def _abort(self, frac: float, window: int) -> None:
        fields = dict(bad_frac=round(frac, 4),
                      max_bad_frac=self.max_bad_frac, window=int(window),
                      n_ok=self.n_ok, n_bad=self.n_bad)
        if self._dead is not None:
            self._dead.emit("ingest_aborted", **fields)
        if self.journal is not None:
            self.journal.emit("ingest_aborted", **fields)
        if self._dead is None and self.journal is None:
            # No mirrored sink carried the event into the flight ring.
            obs.event("ingest_aborted", **fields)
        # The last-N window, with the bad-record burst that tripped the
        # breaker, is kept before the exception unwinds the run.
        obs.flight_dump("ingest_aborted", **fields)
        raise IngestAborted(
            f"bad-record rate {frac:.1%} over the trailing {window} "
            f"record(s) exceeds max_bad_frac={self.max_bad_frac:.1%} "
            f"({self.n_bad} quarantined, {self.n_ok} ok) — refusing to "
            "train on what looks like a truncated or garbage input; "
            "inspect the dead-letter journal"
            + (f" at {self.dead_letter_path}" if self.dead_letter_path
               else ""))

    @staticmethod
    def violation(label, idx, val, *, num_features: int = 0,
                  max_nnz: int = 0) -> str | None:
        """The reason a parsed row fails the value contract, or None (no
        side effect: the native path classifies at parse time and counts
        at consume time)."""
        if not math.isfinite(label):
            return f"non-finite label {label!r}"
        if max_nnz and len(idx) > max_nnz:
            return f"row has {len(idx)} non-zeros, max_nnz is {max_nnz}"
        for v in val:
            if not math.isfinite(v):
                return f"non-finite value {v!r}"
        for i in idx:
            if i < 0 or (num_features and i >= num_features):
                return (
                    f"feature id {i} outside the hash bucket "
                    f"[0, {num_features})" if num_features
                    else f"negative feature id {i}")
        return None

    def admit(self, path, lineno, line, label, idx, val, *,
              num_features: int = 0, max_nnz: int = 0) -> bool:
        """Hold one parsed row to the value contract: count it (ok, or
        bad by the policy) and return whether it may train."""
        reason = self.violation(label, idx, val, num_features=num_features,
                                max_nnz=max_nnz)
        if reason is not None:
            self.bad(path, lineno, line, reason)
            return False
        self.ok()
        return True

    def counters(self) -> dict:
        return {"ok": self.n_ok, "bad": self.n_bad}

    def restore(self, state: dict) -> None:
        self.n_ok = int(state.get("ok", 0))
        self.n_bad = int(state.get("bad", 0))
        self._window.clear()
        self._window_bad = 0

    def close(self) -> None:
        if self._dead is not None:
            self._dead.close()


class StreamBatches:
    """Fixed-shape, epoch-cycling, exactly-once-resumable batch source over
    a :class:`ShardReader`, a per-line parser and a :class:`RecordGuard`.

    ``next_batch()`` returns numpy ``(ids [B, S] int32, vals [B, S]
    float32, labels [B], weights [B])``; the epoch's last partial batch is
    padded with ``weight=0`` rows and the cursor then points at the next
    epoch's start. ``state()`` is the reader's cursor plus the guard's
    ``ok``/``bad`` counters as of the LAST EMITTED batch.

    ``parse`` maps one stripped line to ``(label, idx, val)``, returns
    None for a line that carries no record (a libsvm comment line,
    skipped uncounted), and raises ``ValueError`` on malformed input
    (:func:`line_parser`). Blank lines are skipped uncounted.
    """

    def __init__(self, reader: ShardReader, parse, batch_size: int,
                 max_nnz: int, guard: RecordGuard | None = None,
                 num_features: int = 0):
        self._reader = reader
        self._parse = parse
        self.batch_size = int(batch_size)
        self.max_nnz = int(max_nnz)
        if self.batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if self.max_nnz < 1:
            raise ValueError(f"max_nnz must be >= 1, got {max_nnz}")
        self.num_features = int(num_features)
        self.guard = guard if guard is not None else RecordGuard()
        self._cursor = dict(self._reader.state(), **self.guard.counters())
        # Rows emitted per second spent INSIDE next_batch (the consumer's
        # time excluded): the ``ingest.rows_per_sec`` gauge.
        self._ingest_busy_s = 0.0
        self._ingest_rows = 0
        self._g_rate = obs.gauge("ingest.rows_per_sec")

    @property
    def rows_per_sec(self) -> float | None:
        """This source's parse rate so far (rows per busy second)."""
        if self._ingest_busy_s <= 0:
            return None
        return self._ingest_rows / self._ingest_busy_s

    def _note_ingest(self, rows: int, busy_s: float) -> None:
        self._ingest_rows += int(rows)
        self._ingest_busy_s += float(busy_s)
        if self._ingest_busy_s > 0:
            self._g_rate.set(self._ingest_rows / self._ingest_busy_s)

    def _next_row(self):
        """One good record, or None at an epoch boundary (the reader is
        rewound first)."""
        while True:
            try:
                shard, lineno, line = self._reader.next_line()
            except StopIteration:
                self._reader.rewind()
                obs.event("ingest_epoch", epoch=self._reader.epoch,
                          records=self._reader.records)
                return None
            if not line.strip():
                continue
            path = self._reader.paths[shard]
            try:
                # An injected error here IS a corrupt record.
                faults.inject("ingest_corrupt")
                row = self._parse(line)
            except faults.InjectedDeviceLoss:
                raise
            except (ValueError, faults.FaultInjected) as e:
                self.guard.bad(path, lineno, line,
                               str(e) or type(e).__name__)
                continue
            if row is None:
                continue                        # no record on this line
            label, idx, val = row
            if not self.guard.admit(path, lineno, line, label, idx, val,
                                    num_features=self.num_features,
                                    max_nnz=self.max_nnz):
                continue
            return label, idx, val

    def next_batch(self):
        """``(ids, vals, labels, weights)`` of static shapes ``[B, S] /
        [B, S] / [B] / [B]``, advancing the cursor."""
        t_batch0 = time.perf_counter()
        b, s = self.batch_size, self.max_nnz
        rows = []
        empty_passes = 0
        while len(rows) < b:
            row = self._next_row()
            if row is None:
                if rows:
                    break               # pad the epoch's last partial batch
                empty_passes += 1
                if self.guard.n_ok == 0 or empty_passes >= 2:
                    raise ValueError(
                        "no parseable records in an entire pass over "
                        f"{len(self._reader.paths)} shard(s) "
                        f"({self.guard.n_bad} quarantined)")
                continue
            rows.append(row)
        ids = np.zeros((b, s), np.int32)
        vals = np.zeros((b, s), np.float32)
        labels = np.zeros((b,), np.float32)
        weights = np.zeros((b,), np.float32)
        for r, (label, idx, val) in enumerate(rows):
            k = min(len(idx), s)
            ids[r, :k] = idx[:k]
            vals[r, :k] = val[:k]
            labels[r] = label
            weights[r] = 1.0
        self._cursor = dict(self._reader.state(), **self.guard.counters())
        self._note_ingest(len(rows), time.perf_counter() - t_batch0)
        return ids, vals, labels, weights

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()

    def state(self) -> dict:
        return dict(self._cursor)

    def restore(self, state: dict) -> None:
        self._reader.restore(state)
        self.guard.restore(state)
        self._cursor = dict(self._reader.state(), **self.guard.counters())

    def close(self) -> None:
        self._reader.close()


def line_parser(dataset: str, bucket: int = 0, zero_based: bool = False):
    """The per-line parse callable of :class:`StreamBatches` for a text
    format: ``libsvm`` (``label idx:val ...``), or ``criteo``/``avazu``
    (fixed-field hashed rows: ids GLOBAL, field offset plus hash, vals
    1.0, so ``num_features = num_fields * bucket`` bounds them). It
    raises ``ValueError`` without source context (the guard adds
    ``path:lineno``) and returns None for a libsvm comment line."""
    if dataset == "libsvm":
        from fm_spark_tpu_torch.data.libsvm import parse_libsvm_line

        def parse_svm(line, _zb=zero_based):
            if not line.split(b"#")[0].strip():
                return None
            return parse_libsvm_line(line, zero_based=_zb)

        return parse_svm
    if dataset in ("criteo", "avazu"):
        import importlib

        mod = importlib.import_module(f"fm_spark_tpu_torch.data.{dataset}")

        def _raise(path, lineno, line, reason):
            raise ValueError(reason)

        def parse(line, _mod=mod, _bucket=bucket):
            ids, labels = _mod.parse_lines([line], _bucket, on_error=_raise)
            row = ids[0].tolist()
            return float(labels[0]), row, [1.0] * len(row)

        return parse
    raise ValueError(f"no line parser for dataset kind {dataset!r} "
                     "(know libsvm/criteo/avazu)")
