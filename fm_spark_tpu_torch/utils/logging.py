"""Structured per-step logging: one JSON object per line (a reduced copy of
``fm_spark_tpu/utils/logging.py``'s ``MetricsLogger``, without its
metrics-registry mirror), with a wall-clock samples/s between logs."""

from __future__ import annotations

import json
import sys
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
