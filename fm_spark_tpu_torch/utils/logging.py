"""Structured logging: per-step metric lines, one JSON object per line (a
reduced copy of ``fm_spark_tpu/utils/logging.py``'s ``MetricsLogger``,
without its metrics-registry mirror), with a wall-clock samples/s between
logs; and the health-event journal (``EventLog``)."""

from __future__ import annotations

import json
import sys
import threading
import time


class MetricsLogger:
    """Writes ``{"step", "ts", ["samples_per_sec"], metrics...}`` lines to
    ``stream`` (default stdout)."""

    def __init__(self, stream=None):
        self._stream = stream if stream is not None else sys.stdout
        self._t0 = None

    def log(self, step: int, samples: int = 0, **metrics) -> dict:
        now = time.perf_counter()
        record = {"step": step, "ts": time.time()}
        if samples:
            if self._t0 is not None and now > self._t0:
                record["samples_per_sec"] = round(samples / (now - self._t0), 2)
            self._t0 = now
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        print(json.dumps(record), file=self._stream, flush=True)
        return record


class EventLog:
    """Append-only JSONL journal of health events (a reduced copy of
    ``fm_spark_tpu/utils/logging.py``'s ``EventLog``): one
    ``{"ts", "event", ...}`` object per line, to a file and/or a stream.
    Best-effort: a journal write never takes down the operation it
    narrates. ``records`` keeps every emitted event in memory too, unless
    ``keep=False`` (a journal that may grow with the data, such as the
    dead-letter log)."""

    def __init__(self, path: str | None = None, stream=None,
                 keep: bool = True):
        self._fh = open(path, "a") if path else None
        self._stream = stream
        self._keep = keep
        self._lock = threading.Lock()
        self.records: list[dict] = []

    def emit(self, event: str, **fields) -> dict:
        record = {"ts": round(time.time(), 3), "event": event, **fields}
        with self._lock:
            if self._keep:
                self.records.append(record)
            try:
                line = json.dumps(record)
                if self._stream is not None:
                    print(line, file=self._stream, flush=True)
                if self._fh is not None:
                    self._fh.write(line + "\n")
                    self._fh.flush()
            except (OSError, TypeError, ValueError):
                pass
        return record

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def read_events(path: str) -> list[dict]:
    """The records of an :class:`EventLog` file; a line that does not
    parse (a torn tail write) is skipped."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    out.append(json.loads(line))
                except json.JSONDecodeError:
                    continue
    except OSError:
        pass
    return out
