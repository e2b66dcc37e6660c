"""Host batching (the part of ``fm_spark_tpu/data/pipeline.py`` the
serving slice needs)."""

from __future__ import annotations

import numpy as np


def iterate_once(ids, vals, labels, batch_size: int):
    """One ordered, finite pass over the data — for evaluation/predict.

    Yields ``(ids, vals, labels, weight)``; the final partial batch is
    zero-padded with ``weight=0`` so every batch has one shape.
    """
    n = ids.shape[0]
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        b = end - start
        if b == batch_size:
            yield ids[start:end], vals[start:end], labels[start:end], np.ones(
                (batch_size,), np.float32
            )
        else:
            pad = batch_size - b
            yield (
                np.concatenate([ids[start:end], np.zeros((pad,) + ids.shape[1:], ids.dtype)]),
                np.concatenate([vals[start:end], np.zeros((pad,) + vals.shape[1:], vals.dtype)]),
                np.concatenate([labels[start:end], np.zeros((pad,), labels.dtype)]),
                np.concatenate([np.ones((b,), np.float32), np.zeros((pad,), np.float32)]),
            )
