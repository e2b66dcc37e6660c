"""Loss functions matching the reference's task switch (the port of
``fm_spark_tpu/ops/losses.py``): logistic loss for classification with
{0, 1} labels, squared loss for regression, and hinge for parity with
MLlib-scaffolded forks."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def logistic_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example binary cross-entropy with logits, labels in {0,1}:
    ``softplus(s) - y*s``."""
    return F.softplus(scores) - labels * scores


def squared_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example ``0.5·(ŷ − y)²`` so dL/dŷ = (ŷ − y)."""
    d = scores - labels
    return 0.5 * d * d


def hinge_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example ``max(0, 1 − t·s)`` with labels {0,1} mapped to
    t ∈ {−1,+1}."""
    t = 2.0 * labels - 1.0
    return torch.clamp(1.0 - t * scores, min=0.0)


_LOSSES = {
    "logistic": logistic_loss,
    "squared": squared_loss,
    "hinge": hinge_loss,
}


def loss_fn(name: str):
    """Look up a per-example loss by name ('logistic'|'squared'|'hinge')."""
    try:
        return _LOSSES[name]
    except KeyError:
        raise ValueError(
            f"unknown loss {name!r}; available: {sorted(_LOSSES)}"
        ) from None
