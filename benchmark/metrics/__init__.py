"""The per-layer metrics, one reader per file: ``read(ctx)`` returns
the metric's value from the run's spans, counters or trace, or None when
there is nothing to read (the harness then leaves it out of the line).

``ctx`` keys: ``stats`` (``fit_field_sparse``'s ``stats``), ``window``
(``open_step``, ``end``, ``profiled``: the ``[first, last)`` calls under
the profiler), ``span`` (a :class:`benchmark.trace.Span` or None),
``shape`` (the roofline shape dict), ``config`` and ``traffic`` (the
cell's files)."""

import importlib


def load(name: str):
    return importlib.import_module(f"{__name__}.{name}")
