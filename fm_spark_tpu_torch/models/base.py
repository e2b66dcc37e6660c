"""Shared model-spec scaffolding and the task-switch prediction link (the
port of ``fm_spark_tpu/models/base.py``).

Classification → sigmoid; regression → clip to the [min, max] target
range seen at training time.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fm_spark_tpu_torch.ops import losses

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a spec's dtype name ('float32' | 'bfloat16')."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; "
                         f"available: {sorted(_DTYPES)}") from None


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    """Static model hyperparameters, field for field those of the JAX
    ``ModelSpec`` so ``spec.json`` files move between the two packages."""

    num_features: int
    rank: int
    task: str = "classification"          # 'classification' | 'regression'
    loss: str | None = None       # 'logistic'|'squared'|'hinge'; None ⇒ by task
    use_bias: bool = True
    use_linear: bool = True
    init_std: float = 0.01
    min_target: float = -math.inf        # regression clip, learned from data
    max_target: float = math.inf
    param_dtype: str = "float32"          # storage dtype for the big tables
    compute_dtype: str = "float32"        # accumulation dtype

    field_local_ids = False

    def __post_init__(self):
        if self.task not in ("classification", "regression"):
            raise ValueError(f"unknown task {self.task!r}")
        if self.loss is None:
            object.__setattr__(
                self, "loss",
                "logistic" if self.task == "classification" else "squared")
        losses.loss_fn(self.loss)
        if self.task == "regression" and self.loss in ("logistic", "hinge"):
            raise ValueError(
                f"{self.loss} loss expects {{0,1}} labels; use "
                "loss='squared' (or leave loss unset) for task='regression'"
            )

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)


def predict_from_scores(spec: ModelSpec, scores: torch.Tensor) -> torch.Tensor:
    """Raw scores → predictions per the reference's task switch."""
    if spec.task == "classification":
        return torch.sigmoid(scores)
    lo = spec.min_target if spec.min_target > -math.inf else None
    hi = spec.max_target if spec.max_target < math.inf else None
    if lo is None and hi is None:
        return scores
    return torch.clamp(scores, lo, hi)


def init_linear_terms(spec: ModelSpec, device) -> dict:
    """Bias and linear weights, zero like the reference's (w = 0, w0 = 0)."""
    return {
        "w0": torch.zeros((), dtype=torch.float32, device=device),
        "w": torch.zeros(spec.num_features, dtype=spec.pdtype, device=device),
    }


def to_global_ids(ids: torch.Tensor, num_fields: int,
                  bucket: int) -> torch.Tensor:
    """A field family's field-local ids ``[B, num_fields]`` → the flat
    table's global ids (``f·bucket + id``), int32."""
    offs = torch.arange(num_fields, dtype=torch.int32,
                        device=ids.device) * bucket
    return (ids + offs[None, :]).to(torch.int32)
