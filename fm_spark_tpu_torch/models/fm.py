"""The order-2 factorization machine over one flat table (the port of
``fm_spark_tpu/models/fm.py``): the reference's ``FMModel``, configs 1
and 2.

Parameters are ``{"w0": [] float32, "w": [n], "v": [n, k]}``; ids are
global feature ids ``[B, nnz]`` with JAX's index rules (an id in
``[-n, 0)`` counts from the end, any other out-of-range id clamps into
the table). The ``dim=(k0, k1, k2)`` triple of the reference's
``train()`` maps to (``use_bias``, ``use_linear``, ``rank``). It runs as
plain PyTorch ops on either device, as the reference leaves it to XLA:
no Pallas kernel scores the flat family.
"""

from __future__ import annotations

import dataclasses

import torch

from fm_spark_tpu_torch import resolve_device
from fm_spark_tpu_torch.models import base
from fm_spark_tpu_torch.ops import fm as fm_ops


@dataclasses.dataclass(frozen=True)
class FMSpec(base.ModelSpec):
    """FM hyperparameters; see :class:`~fm_spark_tpu_torch.models.base
    .ModelSpec`."""

    def init(self, generator: torch.Generator | None = None,
             device=None) -> dict:
        """V ~ N(0, init_std²), w = 0, w0 = 0 — the reference's init.
        ``generator`` must live on ``device`` (default: one seeded with
        0)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = base.init_linear_terms(self, dev)
        params["v"] = (torch.randn(self.num_features, self.rank,
                                   generator=generator, device=dev)
                       * self.init_std).to(self.pdtype)
        return params

    def scores(self, params: dict, ids: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        """Raw batched scores; the bias and linear terms are gated by
        ``dim=(k0, k1, ·)`` by leaving them out of the sum (a zero in their
        place), so a disabled term gets no gradient."""
        w0 = params["w0"]
        return fm_ops.fm_scores(
            w0 if self.use_bias else torch.zeros((), dtype=torch.float32,
                                                 device=w0.device),
            params["w"] if self.use_linear else torch.zeros_like(params["w"]),
            params["v"], ids, vals, self.cdtype)

    def predict(self, params: dict, ids: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
        return base.predict_from_scores(self, self.scores(params, ids, vals))
