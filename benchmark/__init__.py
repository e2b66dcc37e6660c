"""The port's benchmark: one run of one cell of ``BENCHMARK.json``
(``python3 -m benchmark.run``), its traffic, configurations, per-layer
metric readers, roofline counts and plain references."""
