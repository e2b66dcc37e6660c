"""Structured logging (the port's copy of ``fm_spark_tpu/utils/logging.py``):
per-step metric lines, one JSON object per line, to stdout and/or a file
(``MetricsLogger``), and the append-only health-event journal
(``EventLog``). Both write their files through the durable seam's
best-effort tier: a dead metrics file or journal degrades telemetry
(counted), never the step it narrates.
"""

from __future__ import annotations

import json
import sys
import threading
import time

from fm_spark_tpu_torch.utils import durable


class MetricsLogger:
    """Writes one JSON object per line (``{"step", "ts",
    ["samples_per_sec", "samples_per_sec_per_chip"], metrics...}``) to
    ``stream`` (default stdout) and, with ``path``, appends it to that
    JSONL file; tracks a wall-clock samples/s between sample-bearing
    logs.

    It is a facade over the process-wide metrics registry
    (:mod:`fm_spark_tpu_torch.obs.metrics`): every figure a ``log`` call
    computes is also published as an instrument (the
    ``train.samples_total`` counter, the ``train.samples_per_sec``,
    ``train.samples_per_sec_per_chip`` and ``train.n_chips`` gauges, and
    a ``train.<metric>`` gauge per numeric keyword), so snapshots and the
    ``/metrics`` endpoint see the numbers the stream prints.
    """

    def __init__(self, path: str | None = None, stream=None,
                 n_chips: int = 1):
        # Imported here: obs imports this module (the EventLog sink).
        from fm_spark_tpu_torch.obs import metrics as obs_metrics

        self._fh = open(path, "a") if path else None
        self._stream = stream if stream is not None else sys.stdout
        self._n_chips = max(n_chips, 1)
        self._t0 = None
        self._paused = 0.0
        self._registry = obs_metrics.registry()
        self._c_samples = self._registry.counter("train.samples_total")
        self._g_rate = self._registry.gauge("train.samples_per_sec")
        self._g_rate_chip = self._registry.gauge(
            "train.samples_per_sec_per_chip")
        self._g_chips = self._registry.gauge("train.n_chips")
        self._g_chips.set(self._n_chips)

    def log(self, step: int, samples: int = 0, **metrics) -> dict:
        now = time.perf_counter()
        record = {"step": step, "ts": time.time()}
        if samples:
            self._c_samples.add(samples)
            if self._t0 is not None:
                # ``samples`` covers exactly the window since the previous
                # samples-bearing log: pair it with this window's
                # duration, less the pauses recorded in it.
                dt = now - self._t0 - self._paused
                rate = samples / dt if dt > 0 else 0.0
                record["samples_per_sec"] = round(rate, 2)
                record["samples_per_sec_per_chip"] = round(
                    rate / self._n_chips, 2)
                self._g_rate.set(record["samples_per_sec"])
                self._g_rate_chip.set(record["samples_per_sec_per_chip"])
            self._t0 = now
            self._paused = 0.0
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
            if isinstance(record[k], (int, float)):
                self._registry.gauge(f"train.{k}").set(record[k])
        line = json.dumps(record)
        if self._stream is not None:
            print(line, file=self._stream, flush=True)
        if self._fh is not None:
            durable.append_line(self._fh, line, path_class="obs",
                                best_effort=True)
        return record

    def add_pause(self, seconds: float) -> None:
        """Exclude a non-training interval (an eval pass, a checkpoint
        stall) from the current samples/s window."""
        self._paused += max(float(seconds), 0.0)

    def set_n_chips(self, n_chips: int) -> None:
        """Re-normalise the per-chip rate's denominator."""
        self._n_chips = max(int(n_chips), 1)
        self._g_chips.set(self._n_chips)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


class EventLog:
    """Append-only JSONL journal of health events: one ``{"ts", "event",
    ...}`` object per line, to a file and/or a stream. Best-effort: a
    journal write never takes down the operation it narrates (the file
    goes through the durable seam's best-effort tier, scoped by
    ``path_class``: ``obs`` by default, ``quarantine`` for the
    dead-letter journal). ``records`` keeps every emitted event in memory
    too, unless ``keep=False`` (a journal that may grow with the data).
    ``mirror_to_flight=True`` also records each event into the flight
    recorder's ring (:func:`fm_spark_tpu_torch.obs.event`), so the last-N
    crash window carries the health narrative; never on the obs plane's
    own trace sink."""

    def __init__(self, path: str | None = None, stream=None,
                 keep: bool = True, mirror_to_flight: bool = False,
                 path_class: str = "obs"):
        self._fh = open(path, "a") if path else None
        self._stream = stream
        self._keep = keep
        self._mirror = bool(mirror_to_flight)
        self._path_class = str(path_class)
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
                    durable.append_line(self._fh, line,
                                        path_class=self._path_class,
                                        best_effort=True)
            except (OSError, TypeError, ValueError):
                # An unserializable field degrades to a dropped line.
                pass
        if self._mirror:
            try:
                from fm_spark_tpu_torch import obs

                obs.event(event, ts=record["ts"], **fields)
            except Exception:
                pass
        return record

    def close(self) -> None:
        with self._lock:
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
