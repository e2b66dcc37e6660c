"""A cell of ``BENCHMARK.json`` with its files, found by name: the
configuration's file, the traffic mix (``benchmark/traffic/<mix>.json``),
the end-to-end and per-layer metrics it reports, and its limits."""

from __future__ import annotations

import json
import os

from benchmark import compare, traffic

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, spec: dict | None = None) -> dict:
    """The cell ``name``: its entry, ``config`` (the file's contents),
    ``traffic``, ``end_to_end`` and ``per_layer`` (the metrics it
    reports) and ``limits``."""
    spec = spec or bench()
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                       f"{sorted(cells)}")
    cell = dict(cells[name])
    conf = {c["name"]: c for c in spec["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as fh:
        cell["config"] = json.load(fh)
    cell["traffic"] = traffic.load(cell["traffic"])
    e2e = [m for m in spec["end_to_end"] if _reports(m, name)]
    moved = {m["name"] for m in e2e}
    cell["end_to_end"] = e2e
    cell["per_layer"] = [m for m in spec["per_layer"]
                         if m["moves"] in moved and _reports(m, name)]
    cell["limits"] = compare.limits_for(name)
    return cell
