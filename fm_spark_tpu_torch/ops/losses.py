"""Loss functions matching the reference's task switch (the port of
``fm_spark_tpu/ops/losses.py``): logistic loss for classification with
{0, 1} labels, squared loss for regression, and hinge for parity with
MLlib-scaffolded forks."""

from __future__ import annotations

import torch


def _no_pos_inf(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == float("inf"), torch.zeros_like(x), x)


class _LogAddExp0(torch.autograd.Function):
    """``logaddexp(0, s)`` as JAX computes it (``jax.lax.logaddexp``), op by
    op in the dtype of ``s``: ``max(s, 0) + log1p(exp(-|s|))``, and its
    derivative ``exp(s - out)`` (+inf replaced by 0 on both sides), so the
    gradient rounds where JAX's custom JVP rounds. Autograd through
    ``softplus`` rounds ``z / (z + 1)`` instead: an ulp off in bf16."""

    @staticmethod
    def forward(ctx, s):
        zero = torch.zeros_like(s)
        out = torch.maximum(zero, s) + torch.log1p(torch.exp(-torch.abs(zero - s)))
        out = torch.where(torch.isnan(zero - s), zero + s, out)
        ctx.save_for_backward(s, out)
        return out

    @staticmethod
    def backward(ctx, grad):
        s, out = ctx.saved_tensors
        return grad * torch.exp(_no_pos_inf(s) - _no_pos_inf(out))


def logistic_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example binary cross-entropy with logits, labels in {0,1}:
    ``logaddexp(0, s) - y*s``."""
    return _LogAddExp0.apply(scores) - labels * scores


def squared_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example ``0.5·(ŷ − y)²`` so dL/dŷ = (ŷ − y)."""
    d = scores - labels
    return 0.5 * d * d


def hinge_loss(scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example ``max(0, 1 − t·s)`` with labels {0,1} mapped to
    t ∈ {−1,+1}."""
    t = 2.0 * labels - 1.0
    u = 1.0 - t * scores
    # maximum, not clamp: at the kink (t·s = 1) its gradient splits the
    # tie in half, as jnp.maximum's does.
    return torch.maximum(torch.zeros_like(u), u)


# Losses that are never negative: the compact 'error' overflow policy's
# -inf loss sentinel is unambiguous only for these.
NON_NEGATIVE_LOSSES = frozenset(("logistic", "squared", "hinge"))

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
