"""DeepFM over one flat table: an FM and a ReLU MLP that share the
embedding (the port of ``fm_spark_tpu/models/deepfm.py``; Guo et al.,
IJCAI 2017).

Parameters are the flat FM's ``{"w0", "w" [n], "v" [n, k]}`` and
``params["mlp"]``, a list of ``{"kernel": [d_in, d_out], "bias":
[d_out]}`` in float32 (JAX's layout, so the model dir carries it under
the same names). The deep input is the ``num_fields`` gathered rows,
value-scaled and concatenated (``[B, F·k]``); the score is ``y_fm +
y_deep``. Plain PyTorch ops on either device, as the reference leaves it
to XLA; the head's products are ``torch.matmul`` over the fixed
:data:`~fm_spark_tpu_torch.models.field_deepfm.ROW_TILE`-row tiles of
FieldDeepFM's head, so a served row's bits do not depend on its batch.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from fm_spark_tpu_torch import resolve_device
from fm_spark_tpu_torch.models import base
from fm_spark_tpu_torch.models.field_deepfm import tiled_mlp
from fm_spark_tpu_torch.ops import fm as fm_ops


@dataclasses.dataclass(frozen=True)
class DeepFMSpec(base.ModelSpec):
    """DeepFM hyperparameters: ``num_fields`` fixes the slot count (the
    MLP input is ``num_fields·rank``), ``mlp_dims`` the hidden widths."""

    num_fields: int = 0
    mlp_dims: tuple = (400, 400, 400)

    def __post_init__(self):
        super().__post_init__()
        if self.num_fields <= 0:
            raise ValueError("DeepFMSpec requires num_fields > 0")

    def init(self, generator: torch.Generator | None = None,
             device=None) -> dict:
        """V ~ N(0, init_std²), w = 0, w0 = 0, then each layer's kernel ~
        N(0, 2/d_in) (He init for the ReLU stack, the output layer too) and
        a zero bias, drawn from ``generator`` (which must live on
        ``device``; default: one seeded with 0)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = base.init_linear_terms(self, dev)
        params["v"] = (torch.randn(self.num_features, self.rank,
                                   generator=generator, device=dev)
                       * self.init_std).to(self.pdtype)
        dims = (self.num_fields * self.rank, *self.mlp_dims, 1)
        params["mlp"] = [
            {"kernel": torch.randn(d_in, d_out, generator=generator,
                                   device=dev) * math.sqrt(2.0 / d_in),
             "bias": torch.zeros(d_out, device=dev)}
            for d_in, d_out in zip(dims[:-1], dims[1:])]
        return params

    def scores(self, params: dict, ids: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        if ids.shape[1] != self.num_fields:
            raise ValueError(
                f"batch has nnz={ids.shape[1]} slots but the MLP input was "
                f"sized for num_fields={self.num_fields}")
        cd = self.cdtype
        vals_c = vals.to(cd)
        # One shared gather: the FM term and the deep head read the same
        # value-scaled rows.
        gidx = fm_ops.gather_index(ids, params["v"].shape[0])
        xv = params["v"][gidx].to(cd) * vals_c[..., None]      # [B, F, k]
        y_fm = fm_ops._interaction(xv)
        if self.use_linear:
            y_fm = y_fm + fm_ops.sum_upcast(
                params["w"][gidx].to(cd) * vals_c, 1)
        if self.use_bias:
            y_fm = y_fm + params["w0"].to(cd)
        deep = tiled_mlp(params["mlp"], xv.reshape(xv.shape[0], -1), cd,
                         len(self.mlp_dims))
        return y_fm + deep

    def predict(self, params: dict, ids: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
        return base.predict_from_scores(self, self.scores(params, ids, vals))
