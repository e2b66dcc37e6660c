"""Field-partitioned DeepFM: an FM and a ReLU MLP over one shared
embedding (the port of ``fm_spark_tpu/models/field_deepfm.py``; Guo et
al., IJCAI 2017; config 5, ``criteo1tb_deepfm``).

The embedding is FieldFM's fused-linear layout: one ``[bucket, rank+1]``
table per field, column ``rank`` the linear weight, field-local ids. The
MLP reads ``h = concat(x_f·v_f)`` ``[B, F·rank]``; its parameters keep
JAX's layout, ``params["mlp"]`` a list of ``{"kernel": [d_in, d_out],
"bias": [d_out]}`` in float32, so the model dir and the checkpoint carry
them under the same names in both packages. The score is
``y_fm + y_deep``, every operation in the compute dtype in the
reference's order: plain PyTorch ops on any device (the reference scores
DeepFM with XLA ops, no Pallas kernel), the MLP's products by
``torch.matmul``.

A row's score does not depend on the batch it is scored in: the head's
products run over tiles of :data:`ROW_TILE` rows, the last one padded
with zero rows, so every batch size runs products of one shape and a
row served in any bucket gets the bits it gets in any other. On the
card, bf16 products run with
``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``
off (float32 sums, as the reference's), set for the head's products only
and restored after them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

from fm_spark_tpu_torch import resolve_device
from fm_spark_tpu_torch.models import base
from fm_spark_tpu_torch.models.field_fm import FieldFMSpec
from fm_spark_tpu_torch.ops.fm import seq_sum as _seq_sum
from fm_spark_tpu_torch.ops.fm import sum_upcast

#: Rows per product of the MLP head: every batch runs products of this
#: one shape, so a row's bits do not depend on the batch size.
ROW_TILE = 64


@contextlib.contextmanager
def _float32_sums(device: torch.device, dtype: torch.dtype):
    """bf16 products on the card with float32 sums, only inside."""
    if device.type != "cuda" or dtype != torch.bfloat16:
        yield
        return
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_bf16_reduced_precision_reduction
    matmul.allow_bf16_reduced_precision_reduction = False
    try:
        yield
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev


def tiled_mlp(mlp, h: torch.Tensor, cd, n_hidden: int) -> torch.Tensor:
    """A DeepFM head (``n_hidden`` ReLU layers and one output) over ``h``
    ``[B, d]`` → ``[B]`` in the compute dtype ``cd``, each product over
    :data:`ROW_TILE`-row tiles of ``h`` padded with zero rows to a whole
    tile, so a row's bits do not depend on the batch it is in."""
    b = h.shape[0]
    pad = -b % ROW_TILE
    if pad:
        h = torch.cat([h, h.new_zeros(pad, h.shape[1])])
    with _float32_sums(h.device, cd):
        for li, layer in enumerate(mlp):
            kernel = layer["kernel"].to(cd)
            out = h.new_empty(h.shape[0], kernel.shape[1])
            for lo in range(0, h.shape[0], ROW_TILE):
                torch.matmul(h[lo:lo + ROW_TILE], kernel,
                             out=out[lo:lo + ROW_TILE])
            h = out + layer["bias"].to(cd)
            if li < n_hidden:
                h = torch.relu(h)
    return h[:b, 0]


@dataclasses.dataclass(frozen=True)
class FieldDeepFMSpec(base.ModelSpec):
    """DeepFM over field-partitioned embedding tables: ``num_fields``
    fields × ``bucket`` rows each, an MLP of ``mlp_dims`` hidden ReLU
    layers over ``num_fields * rank`` inputs and one output."""

    num_fields: int = 0
    bucket: int = 0
    mlp_dims: tuple = (400, 400, 400)

    def __post_init__(self):
        super().__post_init__()
        if self.num_fields <= 0 or self.bucket <= 0:
            raise ValueError(
                "FieldDeepFMSpec requires num_fields > 0 and bucket > 0"
            )
        if self.num_features != self.num_fields * self.bucket:
            raise ValueError(
                f"num_features ({self.num_features}) must equal "
                f"num_fields*bucket ({self.num_fields * self.bucket})"
            )

    # FieldFMSpec(fused_linear=True)'s layout, field-local ids.
    fused_linear = True
    field_local_ids = True

    @property
    def table_width(self) -> int:
        return self.rank + 1

    def _field_fm_spec(self) -> FieldFMSpec:
        return FieldFMSpec(
            num_features=self.num_features, rank=self.rank,
            num_fields=self.num_fields, bucket=self.bucket,
            task=self.task, loss=self.loss, use_bias=self.use_bias,
            use_linear=self.use_linear, init_std=self.init_std,
            param_dtype=self.param_dtype,
            min_target=self.min_target, max_target=self.max_target,
        )

    def init(self, generator: torch.Generator | None = None,
             device=None) -> dict:
        """Random parameters: the tables as FieldFM's, then each layer's
        kernel ~ N(0, 2/d_in) (He init for the ReLU stack) and a zero bias,
        all drawn from ``generator`` (which must live on ``device``;
        default: a generator seeded with 0)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        params = self._field_fm_spec().init(generator, dev)
        dims = (self.num_fields * self.rank, *self.mlp_dims, 1)
        params["mlp"] = [
            {"kernel": torch.randn(d_in, d_out, generator=generator,
                                   device=dev) * math.sqrt(2.0 / d_in),
             "bias": torch.zeros(d_out, device=dev)}
            for d_in, d_out in zip(dims[:-1], dims[1:])]
        return params

    def gather_rows(self, params: dict, ids: torch.Tensor) -> list:
        """One gather per field → F ``[B, rank+1]`` rows (compute dtype),
        ids indexed as JAX's gather takes them (an id in ``[-n, 0)``
        counts from the end, then ids clamp into the table)."""
        cd = self.cdtype
        out = []
        for f in range(self.num_fields):
            t = params["vw"][f]
            n = t.shape[0]
            idx = ids[:, f].long()
            idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
            out.append(t[idx].to(cd))
        return out

    def deep_scores(self, mlp, h: torch.Tensor) -> torch.Tensor:
        """The MLP head over ``h = concat(xv)`` ``[B, F*rank]`` → ``[B]``
        (:func:`tiled_mlp`)."""
        return tiled_mlp(mlp, h, self.cdtype, len(self.mlp_dims))

    def scores(self, params: dict, ids: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        if ids.shape[1] != self.num_fields:
            raise ValueError(
                f"batch has {ids.shape[1]} slots, spec has "
                f"{self.num_fields} fields"
            )
        cd = self.cdtype
        vals_c = vals.to(cd)
        rows = self.gather_rows(params, ids)
        k = self.rank
        xvs = [r[:, :k] * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
        s = _seq_sum(xvs)
        sum_sq = _seq_sum([sum_upcast(x * x, 1) for x in xvs])
        score = 0.5 * (sum_upcast(s * s, 1) - sum_sq)
        if self.use_linear:
            score = score + _seq_sum(
                [r[:, k] * vals_c[:, f] for f, r in enumerate(rows)])
        if self.use_bias:
            score = score + params["w0"].to(cd)
        h = torch.cat(xvs, dim=1)                          # [B, F*k]
        return score + self.deep_scores(params["mlp"], h)

    def predict(self, params: dict, ids: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
        return base.predict_from_scores(self, self.scores(params, ids, vals))
