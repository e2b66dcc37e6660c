"""Operation and byte counts, one module per kernel (by the kernel's
profiler symbols) and one per model family's whole step. Each module
gives ``count(shape) → (flops, bytes)`` for the shape dict the driver
builds (``batch``, ``fields``, ``rank``, ``width``, ``store_bytes``,
``compute_bytes``, ``unique``: the distinct ids per field, averaged over
the pool). Counts are what the inputs need: each input byte read once,
each output byte written once, and only the live rows."""

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")
