"""Synthetic CTR data with planted low-rank FM structure (a copy of
``fm_spark_tpu/data/synthetic.py``: the same seed gives the same ids,
values and labels in both packages)."""

from __future__ import annotations

import numpy as np


def synthetic_ctr(
    num_examples: int,
    num_features: int,
    nnz: int,
    rank: int = 4,
    seed: int = 0,
    scale: float = 1.5,
):
    """Generate ``(ids, vals, labels)`` from a planted FM.

    Each example activates ``nnz`` distinct features drawn from ``nnz``
    disjoint field buckets, with Zipf-skewed ids like real CTR data. The
    label is Bernoulli(sigmoid(scale · standardized FM score)).

    Returns:
      ids   int32 [N, nnz] (global, per-field offset), vals float32
      [N, nnz] (all ones), labels float32 [N].
    """
    rng = np.random.default_rng(seed)
    if num_features < nnz:
        raise ValueError("num_features must be >= nnz (one feature per field)")
    bucket = num_features // nnz
    raw = rng.zipf(1.5, size=(num_examples, nnz)) % bucket
    ids = (raw + np.arange(nnz)[None, :] * bucket).astype(np.int32)
    vals = np.ones((num_examples, nnz), np.float32)

    true_w0 = rng.normal() * 0.1
    true_w = rng.normal(size=(num_features,)) * 0.3
    true_v = rng.normal(size=(num_features, rank)) * 0.4

    rows = true_v[ids]                                    # [N, nnz, r]
    s = rows.sum(axis=1)
    interaction = 0.5 * ((s * s).sum(-1) - (rows * rows).sum((1, 2)))
    score = true_w0 + true_w[ids].sum(1) + interaction
    score = (score - score.mean()) / (score.std() + 1e-9) * scale
    labels = (rng.random(num_examples) < 1.0 / (1.0 + np.exp(-score))).astype(
        np.float32
    )
    return ids, vals, labels


def field_local(ids: np.ndarray, bucket: int) -> np.ndarray:
    """Global per-field-offset ids [N, F] → field-local ids in
    [0, bucket): the FieldFM id layout (``id - field*bucket``)."""
    offs = np.arange(ids.shape[1], dtype=ids.dtype) * bucket
    return ids - offs[None, :]
