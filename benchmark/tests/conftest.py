"""Shared helpers of the benchmark's tests: a cell of ``BENCHMARK.json``
shrunk to a size the CPU runs in seconds (the same files, configuration
and traffic, with fewer fields, buckets, rows and steps)."""

import pytest
import torch


def tiny(name: str, batch: int = 256, **traffic) -> dict:
    """The cell ``name`` at a test size: 5 fields of 512 buckets (the
    mix's last five), rank 4 (FieldFM) or 2 (FieldFFM), ``batch`` rows, a
    pool of 4 batches, a loss line every 2 steps and the window opening at
    step 4."""
    from benchmark import cells

    cell = cells.load(name)
    fm = cell["config"]["family"] == "field_fm"
    cell["config"] = dict(cell["config"], num_fields=5, bucket=512,
                          rank=4 if fm else 2)
    cap = cell["traffic"].get("compact_cap", 0)
    cell["traffic"] = dict(cell["traffic"], batch=batch, pool=4, log_every=2,
                           warmup_steps=4,
                           compact_cap=min(cap, batch) if cap else 0,
                           fields=cell["traffic"]["fields"][-5:], **traffic)
    return cell


@pytest.fixture
def cpu():
    return torch.device("cpu")
