"""Field-partitioned FM: one sub-table per field (the port of
``fm_spark_tpu/models/field_fm.py``).

Ids are FIELD-LOCAL, shape ``[B, F]`` with ``ids[:, f] ∈ [0, bucket)``.
Parameters are a dict: ``{"w0": [] float32, "vw": F × [bucket, k+1]}``
in the fused-linear layout (column ``rank`` is the linear weight), or
``{"w0", "w": F × [bucket], "v": F × [bucket, k]}`` without it.

On CUDA tensors :meth:`FieldFMSpec.scores` goes through the fused
gather→interaction kernel (``ops.fused_fwd``) at any rank and number of
fields, in float32 or bf16 compute (scores come back float32 either way).
The layouts the kernel does not take (``table_layout="col"``,
``fused_linear=False``) are scored by the reference's formula in
PyTorch's own ops on any device, as the reference scores them with XLA
ops: on the card that is the LIBRARY PATH, counted under
``field_fm_scores_library`` (``ops.note_library``), never under the
kernel's name.
"""

from __future__ import annotations

import dataclasses

import torch

from fm_spark_tpu_torch import resolve_device
from fm_spark_tpu_torch.models import base
from fm_spark_tpu_torch import ops
from fm_spark_tpu_torch.ops import fm as fm_ops
from fm_spark_tpu_torch.ops import fused_fwd


@dataclasses.dataclass(frozen=True)
class FieldFMSpec(base.ModelSpec):
    """FM with one sub-table per field; ``num_features`` must equal
    ``num_fields * bucket``."""

    num_fields: int = 0
    bucket: int = 0
    fused_linear: bool = True
    field_local_ids = True
    # "row" = [bucket, width] tables; "col" = transposed [width, bucket].
    table_layout: str = "row"

    def __post_init__(self):
        super().__post_init__()
        if self.num_fields <= 0 or self.bucket <= 0:
            raise ValueError("FieldFMSpec requires num_fields > 0 and bucket > 0")
        if self.num_features != self.num_fields * self.bucket:
            raise ValueError(
                f"num_features ({self.num_features}) must equal "
                f"num_fields*bucket ({self.num_fields * self.bucket})"
            )
        if self.table_layout not in ("row", "col"):
            raise ValueError(
                f"table_layout must be 'row' or 'col', got {self.table_layout!r}")
        if self.table_layout == "col" and not self.fused_linear:
            raise ValueError("table_layout='col' requires fused_linear=True")

    @property
    def table_width(self) -> int:
        return self.rank + 1 if self.fused_linear else self.rank

    def kernel_unsupported(self) -> str | None:
        """Why the fused CUDA kernel does not score this spec (it is then
        scored on the library path), or None: only the layout decides,
        never the rank or the field count."""
        if self.table_layout == "col":
            return ("table_layout='col' has no CUDA kernel: scored on the "
                    "library path (torch ops), as the reference's XLA ops")
        if not self.fused_linear:
            return ("fused_linear=False has no CUDA kernel: scored on the "
                    "library path (torch ops), as the reference's XLA ops")
        return None

    def init(self, generator: torch.Generator | None = None,
             device=None) -> dict:
        """Random parameters: factors ~ N(0, init_std²), linear weights
        and bias zero. ``generator`` must live on ``device`` (default: a
        generator seeded with 0)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        factors = [
            (torch.randn(self.bucket, self.rank, generator=generator,
                         device=dev) * self.init_std).to(self.pdtype)
            for _ in range(self.num_fields)
        ]
        w0 = torch.zeros((), dtype=torch.float32, device=dev)
        if not self.fused_linear:
            return {
                "w0": w0,
                "w": [torch.zeros(self.bucket, dtype=self.pdtype, device=dev)
                      for _ in range(self.num_fields)],
                "v": factors,
            }
        zero = torch.zeros(self.bucket, 1, dtype=self.pdtype, device=dev)
        vw = [torch.cat([v, zero], dim=1) for v in factors]
        if self.table_layout == "col":
            vw = [t.t().contiguous() for t in vw]
        return {"w0": w0, "vw": vw}

    def gather_rows(self, params: dict, ids: torch.Tensor) -> list:
        """One gather per field → F ``[B, width]`` rows (compute dtype)."""
        cd = self.cdtype
        tables = params["vw"] if self.fused_linear else params["v"]
        idx = ids.long()
        if self.table_layout == "col":
            return [tables[f][:, idx[:, f]].to(cd).t()
                    for f in range(self.num_fields)]
        return [tables[f][idx[:, f]].to(cd) for f in range(self.num_fields)]

    def scores(self, params: dict, ids: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        if ids.shape[1] != self.num_fields:
            raise ValueError(
                f"batch has {ids.shape[1]} slots, spec has {self.num_fields} fields")
        reason = self.kernel_unsupported()
        if reason is None:
            score, _ = fused_fwd.fm_fused_scores(
                params["vw"], ids, vals, use_linear=self.use_linear,
                w0=params["w0"] if self.use_bias else None,
                compute_bf16=self.compute_dtype == "bfloat16")
            return score
        if ids.device.type == "cuda":
            ops.note_library("field_fm_scores_library")
        return self._scores_plain(params, ids, vals)

    def _scores_plain(self, params, ids, vals):
        """The reference's formula term for term, for the layouts the
        kernel does not take (on the card, the library path)."""
        cd = self.cdtype
        vals_c = vals.to(cd)
        rows = self.gather_rows(params, ids)
        k = self.rank
        xv = torch.stack([r[:, :k] * vals_c[:, f:f + 1]
                          for f, r in enumerate(rows)], dim=1)
        score = fm_ops.fm_interaction_from_xv(xv)
        if self.use_linear:
            if self.fused_linear:
                lin = sum(r[:, k] * vals_c[:, f] for f, r in enumerate(rows))
            else:
                idx = ids.long()
                lin = sum(params["w"][f][idx[:, f]].to(cd) * vals_c[:, f]
                          for f in range(self.num_fields))
            score = score + lin
        if self.use_bias:
            score = score + params["w0"].to(cd)
        return score

    def predict(self, params: dict, ids: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
        return base.predict_from_scores(self, self.scores(params, ids, vals))

    # -- layout conversion (interop with the flat FMSpec) -------------------

    def flat_spec(self):
        """The flat :class:`~fm_spark_tpu_torch.models.fm.FMSpec` of the
        same model (the per-field tables stacked into one)."""
        from fm_spark_tpu_torch.models.fm import FMSpec

        kwargs = dataclasses.asdict(self)
        for key in ("num_fields", "bucket", "fused_linear", "table_layout"):
            kwargs.pop(key)
        return FMSpec(**kwargs)

    def to_flat_params(self, params: dict) -> dict:
        """The per-field tables concatenated into the flat ``{"w0", "w"
        [N], "v" [N, k]}`` layout (field ``f``'s rows at ``f·bucket``)."""
        if self.fused_linear:
            k = self.rank
            vw = params["vw"]
            if self.table_layout == "col":
                vw = [t.t() for t in vw]
            return {"w0": params["w0"],
                    "w": torch.cat([t[:, k] for t in vw]),
                    "v": torch.cat([t[:, :k] for t in vw], dim=0)}
        return {"w0": params["w0"], "w": torch.cat(params["w"]),
                "v": torch.cat(params["v"], dim=0)}

    def to_global_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Field-local ids → the flat table's global ids (``f·bucket +
        id``), int32."""
        return base.to_global_ids(ids, self.num_fields, self.bucket)
