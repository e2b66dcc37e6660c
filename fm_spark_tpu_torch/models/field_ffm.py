"""Field-partitioned FFM: one packed sub-table per field (the port of
``fm_spark_tpu/models/field_ffm.py``).

Ids are FIELD-LOCAL, shape ``[B, F]``. Parameters are a dict
``{"w0": [] float32, "vw": F × [bucket, F·k+1]}``: row ``r`` of table ``f``
packs the F factor vectors of feature ``r`` of field ``f`` (columns
``j·k:(j+1)·k`` are the one used toward field ``j``) and, in column
``F·k``, its linear weight.

On CUDA tensors :meth:`FieldFFMSpec.scores` goes through the sel-blocked
forward kernel (``ops.ffm_sel``) on the stacked gathered rows; on the CPU
it is the reference's formula over the ``[B, F, F, k]`` sel tensor.
"""

from __future__ import annotations

import dataclasses

import torch

from fm_spark_tpu_torch import resolve_device
from fm_spark_tpu_torch.models import base
from fm_spark_tpu_torch.ops import ffm_sel
from fm_spark_tpu_torch.ops.fm import sum_upcast as _sum_upcast


@dataclasses.dataclass(frozen=True)
class FieldFFMSpec(base.ModelSpec):
    """FFM with one packed sub-table per field; ``num_features`` must equal
    ``num_fields * bucket``."""

    num_fields: int = 0
    bucket: int = 0
    fused_linear: bool = True
    field_local_ids = True

    def __post_init__(self):
        super().__post_init__()
        if self.num_fields <= 0 or self.bucket <= 0:
            raise ValueError("FieldFFMSpec requires num_fields > 0 and bucket > 0")
        if self.num_features != self.num_fields * self.bucket:
            raise ValueError(
                f"num_features ({self.num_features}) must equal "
                f"num_fields*bucket ({self.num_fields * self.bucket})"
            )
        if not self.fused_linear:
            raise ValueError("FieldFFMSpec ships the fused layout only")

    @property
    def table_width(self) -> int:
        return self.num_fields * self.rank + 1

    def init(self, generator: torch.Generator | None = None,
             device=None) -> dict:
        """Random parameters: factors ~ N(0, init_std²) in ``param_dtype``,
        a zero linear column and ``w0`` = 0. ``generator`` must live on
        ``device`` (default: a generator seeded with 0)."""
        dev = resolve_device(device)
        if generator is None:
            generator = torch.Generator(device=dev).manual_seed(0)
        fk = self.num_fields * self.rank
        tables = []
        for _ in range(self.num_fields):
            v = (torch.randn(self.bucket, fk, generator=generator, device=dev)
                 * self.init_std).to(self.pdtype)
            tables.append(torch.cat(
                [v, torch.zeros(self.bucket, 1, dtype=self.pdtype, device=dev)],
                dim=1))
        return {"w0": torch.zeros((), dtype=torch.float32, device=dev),
                "vw": tables}

    def gather_rows(self, params: dict, ids: torch.Tensor) -> list:
        """One gather per field → F ``[B, F·k+1]`` rows (compute dtype)."""
        cd = self.cdtype
        idx = ids.long()
        return [params["vw"][f][idx[:, f]].to(cd)
                for f in range(self.num_fields)]

    def _sel(self, rows, vals_c):
        """``sel[b, i, j, :] = v[id_i, field j] · x_i``: the ``[B, F, F, k]``
        interaction tensor (x folded in)."""
        f, k = self.num_fields, self.rank
        factors = torch.stack([r[:, :f * k].reshape(-1, f, k) for r in rows],
                              dim=1)                  # [B, i(owner), j, k]
        return factors * vals_c[:, :, None, None]

    def _linear_and_bias(self, score, params, rows, vals_c):
        fk = self.num_fields * self.rank
        if self.use_linear:
            score = score + sum(r[:, fk] * vals_c[:, i]
                                for i, r in enumerate(rows))
        if self.use_bias:
            score = score + params["w0"].to(self.cdtype)
        return score

    def scores(self, params: dict, ids: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
        if ids.shape[1] != self.num_fields:
            raise ValueError(
                f"batch has {ids.shape[1]} slots, spec has {self.num_fields} fields")
        if ids.device.type == "cpu":
            return self._scores_reference(params, ids, vals)
        return self._scores_sel(params, ids, vals)

    def _scores_reference(self, params, ids, vals):
        """The reference's formula over the sel tensor (the CPU path)."""
        vals_c = vals.to(self.cdtype)
        rows = self.gather_rows(params, ids)
        sel = self._sel(rows, vals_c)
        a = _sum_upcast(sel * sel.transpose(1, 2), -1)          # [B, F, F]
        diag = _sum_upcast(torch.diagonal(a, dim1=1, dim2=2), -1)
        score = 0.5 * (_sum_upcast(a, (1, 2)) - diag)
        return self._linear_and_bias(score, params, rows, vals_c)

    def _scores_sel(self, params, ids, vals):
        """The stacked rows through :func:`~fm_spark_tpu_torch.ops.ffm_sel.
        ffm_sel_scores` (the kernel on CUDA, its plain version on the
        CPU), then the linear and bias terms."""
        vals_c = vals.to(self.cdtype)
        rows = self.gather_rows(params, ids)
        fk = self.num_fields * self.rank
        rstk = torch.stack([r[:, :fk] for r in rows], dim=1)   # [B, F, F·k]
        score = 0.5 * ffm_sel.ffm_sel_scores(rstk, vals_c)
        return self._linear_and_bias(score, params, rows, vals_c)

    def predict(self, params: dict, ids: torch.Tensor,
                vals: torch.Tensor) -> torch.Tensor:
        return base.predict_from_scores(self, self.scores(params, ids, vals))

    # -- layout conversion (interop with the flat FFMSpec) ------------------

    def flat_spec(self):
        """The flat :class:`~fm_spark_tpu_torch.models.ffm.FFMSpec` of the
        same model."""
        from fm_spark_tpu_torch.models.ffm import FFMSpec

        kwargs = dataclasses.asdict(self)
        kwargs.pop("bucket")
        kwargs.pop("fused_linear")
        return FFMSpec(**kwargs)

    def to_flat_params(self, params: dict) -> dict:
        """The packed per-field tables as the flat ``{"w0", "w" [N], "v"
        [N, F, k]}`` layout (field ``f``'s rows at ``f·bucket``)."""
        f, k = self.num_fields, self.rank
        return {"w0": params["w0"],
                "w": torch.cat([t[:, f * k] for t in params["vw"]]),
                "v": torch.cat([t[:, :f * k].reshape(-1, f, k)
                                for t in params["vw"]], dim=0)}

    def to_global_ids(self, ids: torch.Tensor) -> torch.Tensor:
        """Field-local ids → the flat table's global ids (``f·bucket +
        id``), int32."""
        return base.to_global_ids(ids, self.num_fields, self.bucket)
