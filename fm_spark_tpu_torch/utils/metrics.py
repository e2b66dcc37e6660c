"""Streaming evaluation metrics: logloss, RMSE and histogram AUC (the port
of ``fm_spark_tpu/utils/metrics.py``, with the same bin count).

Scores are squashed to probabilities; positives and negatives each
accumulate a fixed-bin histogram of them, and AUC is the probability that
a positive outranks a negative, ties within a bin counting half. Every
field of the state is a plain sum, so batches fold in any order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

DEFAULT_BINS = 4096


class MetricsState(NamedTuple):
    """Additive metric accumulators (float32 tensors on one device)."""

    pos_hist: torch.Tensor    # [bins] count of positives per probability bin
    neg_hist: torch.Tensor    # [bins]
    loss_sum: torch.Tensor    # scalar Σ per-example loss
    count: torch.Tensor       # scalar number of examples
    sq_err_sum: torch.Tensor  # scalar Σ (ŷ − y)² (regression RMSE support)


def init_metrics(bins: int = DEFAULT_BINS, device="cpu") -> MetricsState:
    z = torch.zeros((), dtype=torch.float32, device=device)
    return MetricsState(
        pos_hist=torch.zeros(bins, dtype=torch.float32, device=device),
        neg_hist=torch.zeros(bins, dtype=torch.float32, device=device),
        loss_sum=z, count=z, sq_err_sum=z,
    )


def update_metrics(state: MetricsState, scores, labels, per_example_loss,
                   weights=None, predictions=None) -> MetricsState:
    """Fold a batch of raw scores into the accumulators. ``weights``
    masks padded examples (0 ⇒ ignore); ``predictions`` (default: the
    raw scores) feeds the squared-error accumulator."""
    bins = state.pos_hist.shape[0]
    if weights is None:
        weights = torch.ones_like(labels)
    if predictions is None:
        predictions = scores
    w = weights.float()
    p = torch.sigmoid(scores)
    idx = torch.clamp((p * bins).to(torch.int32), 0, bins - 1).long()
    is_pos = (labels > 0.5).float() * w
    is_neg = (labels <= 0.5).float() * w
    err = (predictions - labels) * w
    return MetricsState(
        pos_hist=state.pos_hist.index_add(0, idx, is_pos),
        neg_hist=state.neg_hist.index_add(0, idx, is_neg),
        loss_sum=state.loss_sum + torch.sum(per_example_loss * w),
        count=state.count + torch.sum(w),
        sq_err_sum=state.sq_err_sum + torch.sum(err * err),
    )


def finalize_metrics(state: MetricsState) -> dict:
    """Histograms → {auc, logloss, rmse, count} as Python floats."""
    pos, neg = state.pos_hist, state.neg_hist
    p_total = torch.sum(pos)
    n_total = torch.sum(neg)
    neg_below = torch.cumsum(neg, 0) - neg   # negatives strictly below
    wins = torch.sum(pos * (neg_below + 0.5 * neg))
    denom = torch.clamp(p_total * n_total, min=1.0)
    auc = torch.where(p_total * n_total > 0, wins / denom,
                      torch.tensor(0.5, device=pos.device))
    count = torch.clamp(state.count, min=1.0)
    return {
        "auc": float(auc),
        "logloss": float(state.loss_sum / count),
        "rmse": float(torch.sqrt(state.sq_err_sum / count)),
        "count": float(state.count),
    }
