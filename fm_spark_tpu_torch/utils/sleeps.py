"""Designed-sleep scaling (the port's copy of
``fm_spark_tpu/utils/sleeps.py``).

Fault drills deliberately sleep (retry backoffs, a slow-disk fault's
latency), and those sleeps prove nothing by themselves: a drill's
assertions are about behaviour (events journaled, retries counted,
verdicts classified), never about how long the process waited.
``FM_SPARK_TEST_SLEEP_SCALE`` scales every designed sleep
multiplicatively (the fault tests set 0.25; unset = 1.0 = production
timing).

The knob scales ONLY sleeps that are design choices. It never scales
measured durations, deadlines a test asserts on, or the watchdog's
hang-detection windows: shrinking those would change the behaviour under
test, not just the wait for it.
"""

from __future__ import annotations

import os

ENV = "FM_SPARK_TEST_SLEEP_SCALE"


def sleep_scale(default: float = 1.0) -> float:
    """The designed-sleep multiplier: ``FM_SPARK_TEST_SLEEP_SCALE``
    parsed as a float, clamped to [0, 1] (scaling sleeps up is never
    what a test wants, and production leaves the variable unset)."""
    val = os.environ.get(ENV, "").strip()
    if not val:
        return float(default)
    try:
        scale = float(val)
    except ValueError:
        return float(default)
    return min(max(scale, 0.0), 1.0)


def scaled(seconds: float) -> float:
    """``seconds * sleep_scale()``, for designed-sleep call sites."""
    return float(seconds) * sleep_scale()
