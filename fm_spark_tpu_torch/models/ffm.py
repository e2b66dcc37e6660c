"""The field-aware FM over one flat table (the port of
``fm_spark_tpu/models/ffm.py``): ``V`` is ``[n, F, k]``, one latent
vector per (feature, field) pair, and the interaction uses the opposite
slot's field. Ids are global ``[B, F]``, slot ``i`` in field ``i``.

On CUDA tensors :meth:`FFMSpec.scores` runs the pairwise term through the
sel-blocked forward kernel (``ops.ffm_sel``): the gathered rows ``v[ids]``
reshaped to ``[B, F, F·k]`` are its row layout, the choice
``FieldFFMSpec.scores`` makes. On the CPU the reference's formula runs.
"""

from __future__ import annotations

import dataclasses

import torch

from fm_spark_tpu_torch import resolve_device
from fm_spark_tpu_torch.models import base
from fm_spark_tpu_torch.ops import ffm as ffm_ops


@dataclasses.dataclass(frozen=True)
class FFMSpec(base.ModelSpec):
    """FFM hyperparameters; ``num_fields`` is the fixed slot count
    (nnz)."""

    num_fields: int = 0

    def __post_init__(self):
        super().__post_init__()
        if self.num_fields <= 0:
            raise ValueError("FFMSpec requires num_fields > 0")

    def init(self, generator: torch.Generator | None = None,
             device=None) -> dict:
        """V ~ N(0, init_std²) ``[n, F, k]``, w = 0, w0 = 0, the
        reference's init. ``generator`` must live on ``device`` (default:
        one seeded with 0)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = base.init_linear_terms(self, dev)
        params["v"] = (torch.randn(self.num_features, self.num_fields,
                                   self.rank, generator=generator, device=dev)
                       * self.init_std).to(self.pdtype)
        return params

    def scores(self, params: dict, ids: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        w0 = params["w0"]
        return ffm_ops.ffm_scores(
            w0 if self.use_bias else torch.zeros((), dtype=torch.float32,
                                                 device=w0.device),
            params["w"] if self.use_linear else torch.zeros_like(params["w"]),
            params["v"], ids, vals, compute_dtype=self.cdtype)

    def predict(self, params: dict, ids: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
        return base.predict_from_scores(self, self.scores(params, ids, vals))
