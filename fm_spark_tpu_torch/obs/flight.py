"""Flight recorder (the port's copy of ``fm_spark_tpu/obs/flight.py``): a
bounded ring of the last N telemetry events that survives any crash,
SIGKILL included. It keeps two copies of the window:

- an in-memory ring (``deque(maxlen=N)``) that :meth:`FlightRecorder.dump`
  writes atomically (tmp + rename) with a reason and a metrics snapshot
  on the catchable endings: SIGTERM, an ingest abort, a hang, a device
  loss, the run's end;
- an append-only JSONL spool flushed per record and compacted back to
  the last N lines whenever it reaches 2N, so after an uncatchable ending
  (SIGKILL, a hang killed from outside) the spool still holds a
  parseable last-N window.

A recorder opened over an existing spool (a retried run re-entering its
run directory) seeds its ring and sequence counter from the spool's
tail, so the window is continuous across process restarts.
"""

from __future__ import annotations

import json
import os
import threading
import time

from fm_spark_tpu_torch.utils import durable

__all__ = ["FlightRecorder", "read_spool"]


def read_spool(path: str) -> list[dict]:
    """Parse a flight spool (JSONL); unparseable lines — the torn tail
    a SIGKILL can leave — are skipped, never fatal."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


class FlightRecorder:
    """Bounded last-N event ring with a crash-surviving disk spool."""

    def __init__(self, capacity: int = 256, spool_path: str | None = None):
        self.capacity = max(int(capacity), 1)
        from collections import deque

        self._ring: "deque[dict]" = deque(maxlen=self.capacity)
        # RLock, not Lock: the SIGTERM dump handler runs on the main
        # thread BETWEEN bytecodes, possibly while that same thread is
        # inside record() — a non-reentrant lock would self-deadlock
        # the process on the very dump the handler exists to write.
        self._lock = threading.RLock()
        self._seq = 0
        self.spool_path = spool_path
        self._spool = None
        self._spool_lines = 0
        if spool_path is not None:
            prior = read_spool(spool_path)
            for rec in prior[-self.capacity:]:
                self._ring.append(rec)
            if prior:
                self._seq = max(int(r.get("seq", -1)) for r in prior) + 1
            self._spool_lines = len(prior)
            self._spool = open(spool_path, "a")

    # ----------------------------------------------------------- record

    def record(self, kind: str, **fields) -> dict:
        """Append one event (ring + spool, flushed). Best-effort on the
        disk side; the in-memory ring always advances. A ``ts`` in
        ``fields`` overrides the recording time — mirrored journal
        events keep their ORIGINAL stamp so the same transition carries
        one timestamp in every stream (what the report's timeline
        de-duplicates on)."""
        ts = fields.pop("ts", None)
        with self._lock:
            rec = {"seq": self._seq,
                   "ts": ts if ts is not None else round(time.time(), 3),
                   "kind": kind}
            self._seq += 1
            for k, v in fields.items():
                rec.setdefault(k, v)
            self._ring.append(rec)
            if self._spool is None and self.spool_path is not None:
                # A failed compaction (below) may have dropped the
                # handle; keep trying — the disk may have come back.
                try:
                    self._spool = open(self.spool_path, "a")
                except OSError:
                    pass
            if self._spool is not None:
                try:
                    # Durable seam, ``obs`` class, best-effort tier: a
                    # failed append is counted + flagged by the seam
                    # and the ring still advances. The except keeps
                    # non-OSError surprises (unserializable fields)
                    # equally non-fatal.
                    if durable.append_line(self._spool,
                                           json.dumps(rec),
                                           path_class="obs",
                                           best_effort=True):
                        self._spool_lines += 1
                        if self._spool_lines >= 2 * self.capacity:
                            self._compact_locked()
                except (OSError, TypeError, ValueError):
                    pass
        return rec

    def _compact_locked(self) -> None:
        """Rewrite the spool to exactly the ring's contents (the last N
        records), atomically, then continue appending. A failed rewrite
        (ENOSPC, a vanished mount) must leave the recorder APPENDING,
        never holding a closed handle that silently eats every later
        write — the append handle is re-established in ``finally``."""
        self._spool.close()
        try:
            durable.atomic_write_lines(
                self.spool_path,
                [json.dumps(rec) for rec in self._ring],
                path_class="obs", best_effort=True)
        finally:
            # Reset the counter even on failure: retrying the rewrite
            # on EVERY event would turn a full disk into a hot loop.
            self._spool_lines = len(self._ring)
            try:
                self._spool = open(self.spool_path, "a")
            except OSError:
                self._spool = None  # record() retries on the next event

    def events(self) -> list[dict]:
        with self._lock:
            return list(self._ring)

    # ------------------------------------------------------------- dump

    def dump(self, reason: str, path: str | None = None,
             extra: dict | None = None) -> str | None:
        """Atomically write the last-N window (+ a metrics snapshot) as
        one JSON document. Default path: ``flight_dump.json`` next to
        the spool. Best-effort: returns the path, or None on failure —
        a dump must never take down the fault path invoking it."""
        if path is None:
            if self.spool_path is None:
                return None
            path = os.path.join(os.path.dirname(self.spool_path),
                                "flight_dump.json")
        try:
            from fm_spark_tpu_torch.obs.metrics import registry

            doc = {
                "reason": str(reason),
                "ts": round(time.time(), 3),
                "events": self.events(),
                "metrics": registry().snapshot(),
            }
            if extra:
                doc.update(extra)
            if not durable.atomic_write_json(path, doc,
                                             path_class="obs",
                                             best_effort=True):
                return None
            return path
        except Exception:
            return None

    def close(self) -> None:
        with self._lock:
            if self._spool is not None:
                try:
                    self._spool.close()
                except OSError:
                    pass
                self._spool = None
