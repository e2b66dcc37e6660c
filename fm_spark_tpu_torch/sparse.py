"""Fused sparse-SGD step of FieldFM: analytic row gradients written straight
into the tables, no dense gradient (the port of the FieldFM branch of
``fm_spark_tpu/sparse.py``).

Forms ported (the others raise with the ROADMAP item that queues them):

- ``sparse_update="scatter_add"`` without a cap: one ``index_add_`` per
  field of every lane's row delta;
- the compact host-aux path (``host_dedup=True, compact_cap > 0``) in
  ``dedup`` and ``dedup_sr``, with ``gfull_fused`` on or off,
  ``segtotal_pallas`` on or off (kernel A, ``ops.segsum``), and
  ``fused_embed`` off / auto / require (kernel B, ``ops.fused_bwd``).

Every elementwise operation runs in the spec's compute dtype in the
reference's order, and ``lr`` is a float32 scalar, so ``-lr·g_full`` is
float32 even when ``g_full`` is bf16 (JAX's promotion of a strongly
typed float32 scalar). Tables and ``w0`` are updated IN PLACE: the JAX
step donates them, and the port never holds two copies of them.
"""

from __future__ import annotations

import functools
import operator

import torch

from fm_spark_tpu_torch.ops import KernelUnavailable
from fm_spark_tpu_torch.ops import fused_bwd as fused_bwd_lib
from fm_spark_tpu_torch.ops import losses as losses_lib
from fm_spark_tpu_torch.ops import scatter as scatter_lib
from fm_spark_tpu_torch.train import TrainConfig, _lr_at

__all__ = ["fused_embed_plan", "make_field_sparse_multistep",
           "make_field_sparse_sgd_body"]


def _check_host_dedup(config: TrainConfig, loss: str):
    """Shared host_dedup/compact preconditions (the reference's, with its
    messages)."""
    if config.compact_device:
        if config.compact_cap <= 0:
            raise ValueError("compact_device requires compact_cap > 0")
        if (config.compact_overflow == "error"
                and loss not in losses_lib.NON_NEGATIVE_LOSSES):
            raise ValueError(
                "compact_overflow='error' signals overflow by poisoning "
                "the loss to -inf, which is only unambiguous for "
                "non-negative losses "
                f"{sorted(losses_lib.NON_NEGATIVE_LOSSES)}; loss "
                f"{loss!r} is not in that set — add it to "
                "losses.NON_NEGATIVE_LOSSES only after verifying it "
                "cannot go negative (or use compact_overflow='drop')"
            )
        if config.host_dedup:
            raise ValueError(
                "compact_device builds the aux in-step; host_dedup is "
                "exclusive with it"
            )
    if config.compact_cap > 0 and not (
        config.host_dedup or config.compact_device
    ):
        raise ValueError(
            "compact_cap requires host_dedup=True or compact_device=True"
        )
    if config.compact_overflow not in ("error", "drop", "split"):
        raise ValueError(
            f"unknown compact_overflow {config.compact_overflow!r}"
        )
    if config.compact_overflow != "error" and config.compact_cap <= 0:
        raise ValueError(
            f"compact_overflow={config.compact_overflow!r} has no "
            "effect without compact_cap > 0"
        )
    if config.compact_overflow == "drop" and not config.compact_device:
        raise ValueError(
            "compact_overflow='drop' is the device-side policy; the "
            "host aux builder detects overflow before the step (use "
            "'error' or 'split')"
        )
    if config.compact_overflow == "split" and config.compact_device:
        raise ValueError(
            "compact_overflow='split' is the host-pipeline policy; the "
            "device path cannot reshape a batch in-step (use 'error' "
            "or 'drop')"
        )
    if config.segtotal_pallas and config.compact_cap <= 0:
        raise ValueError(
            "segtotal_pallas requires the compact path (compact_cap > 0)"
        )
    if not (config.host_dedup or config.compact_device):
        return
    if config.sparse_update not in ("dedup", "dedup_sr"):
        raise ValueError(
            "host_dedup/compact_device require sparse_update='dedup' "
            "or 'dedup_sr'"
        )
    if config.use_pallas:
        raise ValueError("host_dedup/compact_device and use_pallas are "
                         "exclusive")


def _reject_unported(spec, config: TrainConfig, compact: bool, col: bool):
    """Forms the JAX step takes that this slice does not port yet."""
    if config.use_pallas:
        raise ValueError(
            "use_pallas (kernels gather_rows / update_rows_add) is not "
            "ported yet (ROADMAP Queue 2)")
    if config.compact_device:
        raise ValueError("compact_device (the in-step aux build) is not "
                         "ported yet (ROADMAP Queue 1)")
    if col:
        raise ValueError("table_layout='col' training is not ported yet "
                         "(ROADMAP Queue 1)")
    if not spec.fused_linear:
        raise ValueError("fused_linear=False training is not ported yet "
                         "(ROADMAP Queue 1)")
    if config.sparse_update != "scatter_add" and not compact:
        raise ValueError(
            f"sparse_update={config.sparse_update!r} without the compact "
            "host aux is not ported yet (ROADMAP Queue 1); use "
            "host_dedup=True with compact_cap > 0")


def _reject_rest(config: TrainConfig):
    """The reference's guards for levers of other steps (same messages)."""
    if config.embed_tier not in ("off", "auto", "require"):
        raise ValueError(
            f"unknown embed_tier {config.embed_tier!r} "
            "(expected 'off', 'auto', or 'require')")
    if config.embed_tier == "require":
        raise ValueError(
            "embed_tier='require' is served by the tiered flat-FM "
            "trainer (fm_spark_tpu.embed.TieredTrainer), not the "
            "single-chip FieldFM body; use 'auto' for fallback-to-in-HBM "
            "semantics")
    if config.collective_dtype != "float32":
        raise ValueError(
            f"collective_dtype={config.collective_dtype!r} is not "
            "supported by the single-chip FieldFM body; it is a "
            "field-sharded-step knob")
    if config.score_sharded:
        raise ValueError(
            "score_sharded is implemented for the field-sharded FM step "
            "only, not the single-chip FieldFM body")
    if config.sel_blocked:
        raise ValueError(
            "sel_blocked is the FieldFFM fused body's lever (it blocks the "
            "[B, F, F, k] interaction tensor), not the single-chip FieldFM "
            "body")
    if config.deep_sharded:
        raise ValueError(
            "deep_sharded is implemented for the field-sharded DeepFM step "
            "only, not the single-chip FieldFM body")


def fused_embed_plan(spec, config: TrainConfig):
    """Resolve ``TrainConfig.fused_embed`` against (spec, config): returns
    ``(family, reason)`` — ``'fm_compact_bwd'`` (kernel B) or None with
    ``reason`` naming why the plain torch path runs instead."""
    from fm_spark_tpu_torch.models.field_fm import FieldFMSpec

    if config.fused_embed not in ("off", "auto", "require"):
        raise ValueError(
            f"unknown fused_embed {config.fused_embed!r} "
            "(expected 'off', 'auto', or 'require')")
    if config.fused_embed == "off":
        return None, "fused_embed='off'"
    if type(spec) is not FieldFMSpec:
        return None, f"no fused kernel family for {type(spec).__name__}"
    if config.compact_cap <= 0:
        return None, ("the fused FM backward rides the compact "
                      "update; it needs compact_cap > 0")
    if not spec.fused_linear:
        return None, "the fused FM backward needs fused_linear=True"
    if spec.table_layout == "col":
        return None, ("table_layout='col' stores transposed tables; the "
                      "kernel reads row-major unique rows")
    reason = fused_bwd_lib.fm_bwd_supported(
        config.compact_cap, spec.rank + 1, spec.num_fields)
    if reason:
        return None, reason
    return "fm_compact_bwd", None


def _resolve_fused_embed(spec, config: TrainConfig):
    """The plan's family, with ``'require'`` escalated to
    :class:`KernelUnavailable` where no family serves."""
    family, reason = fused_embed_plan(spec, config)
    if family is None and config.fused_embed == "require":
        raise KernelUnavailable(
            f"fused_embed='require' cannot be served: {reason}")
    return family


def _seq_sum(terms):
    """Left-to-right elementwise sum, each add rounded in the operands'
    dtype (the reference's Python ``sum`` over per-field arrays)."""
    return functools.reduce(operator.add, terms)


def _sum_upcast(x, dim=None):
    """``jnp.sum``: bf16 sums accumulate in float32, rounded back once."""
    if x.dtype == torch.bfloat16:
        s = x.float().sum() if dim is None else x.float().sum(dim)
        return s.to(torch.bfloat16)
    return x.sum() if dim is None else x.sum(dim)


def _compact_gather_all(tables, aux, cd):
    """Each field's ``cap`` unique rows gathered once (storage dtype) and
    the per-lane rows expanded from them by ``inv`` (compute dtype)."""
    useg, inv = aux[0], aux[4]
    urows = [scatter_lib.compact_gather(t, useg[f])
             for f, t in enumerate(tables)]
    rows = [u.to(cd)[inv[f].long()] for f, u in enumerate(urows)]
    return urows, rows


def _gather_all(tables, ids, cd):
    """One gather per field, cast to compute dtype (as JAX's indexing: an
    id in ``[-n, 0)`` counts from the end, then ids clamp into the
    table)."""
    out = []
    for f, t in enumerate(tables):
        n = t.shape[0]
        idx = ids[:, f].long()
        idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
        out.append(t[idx].to(cd))
    return out


def _s1_and_rv(s, k, cd, use_linear: bool, config: TrainConfig):
    """``s1 = [s, lin_on]`` ([B, k+1]) and the column regs ``(factor,
    linear)`` (None when both regs are off)."""
    lin_on = 1.0 if use_linear else 0.0
    s1 = torch.cat([s, torch.full((s.shape[0], 1), lin_on, dtype=cd,
                                  device=s.device)], dim=1)
    rv = None
    if config.reg_factors or config.reg_linear:
        rv = (config.reg_factors, config.reg_linear if use_linear else 0.0)
    return s1, rv


def _gfull_grads(dscores, vals_c, s, xv_fulls, rows, touched_c, k, cd,
                 use_linear: bool, config: TrainConfig):
    """The fused g_full construction per field (``gfull_fused``):
    ``ds·(s1 − mask·xv_full)·x + rv·rows·touched``."""
    s1, rv = _s1_and_rv(s, k, cd, use_linear, config)
    rv = fused_bwd_lib.rv_vector(rv, k, cd, s.device)
    colmask = torch.arange(k + 1, device=s.device) < k
    return [fused_bwd_lib.gfull(rows[f], xv_fulls[f], s1, dscores,
                                vals_c[:, f], touched_c, rv, colmask)
            for f in range(len(rows))]


def _compact_apply_all(tables, g_fulls, urows, config: TrainConfig,
                       noise_for, step_idx, neg_lr, aux):
    """COMPACT update: per field, the segment totals of ``-lr·g_full``
    (float32) and one write per unique id (``scatter.compact_apply``)."""
    for f, (table, g_full) in enumerate(zip(tables, g_fulls)):
        scatter_lib.compact_apply(
            table, g_full.float() * neg_lr, tuple(a[f] for a in aux),
            config.sparse_update, noise_for(table, step_idx, f,
                                            urows[f].shape),
            urows[f], segtotal_pallas=config.segtotal_pallas)


def _fused_compact_updates(tables, urows, aux, s, dscores, vals, weights,
                           config: TrainConfig, noise_for, step_idx, neg_lr,
                           k, cd, use_linear: bool):
    """COMPACT update through the fused backward (kernel B): every field's
    ``-lr·g_full`` segment totals in one call, from the unsorted streams
    and the unique rows, then the same write half as
    :func:`_compact_apply_all`."""
    s1, rv = _s1_and_rv(s, k, cd, use_linear, config)
    totals = fused_bwd_lib.fm_bwd_segment_totals(
        urows, s1, dscores.contiguous(), vals.contiguous(),
        weights.contiguous(), aux[3].contiguous(), aux[4].contiguous(),
        neg_lr, rv, cap=config.compact_cap)
    for f, table in enumerate(tables):
        scatter_lib.compact_apply_totals(
            table, totals[f], tuple(a[f] for a in aux), config.sparse_update,
            noise_for(table, step_idx, f, totals[f].shape), urows[f])


def make_field_sparse_sgd_body(spec, config: TrainConfig, sr_noise=None):
    """The fused sparse-SGD step of a FieldFM:
    ``step(params, step_idx, ids, vals, labels, weights, aux=None) →
    (params, loss)``, updating ``params`` in place.

    ``ids`` int32 ``[B, F]`` (field-local), ``vals`` float32 ``[B, F]``,
    ``labels``/``weights`` float32 ``[B]``, ``aux`` the compact aux (five
    int32 tensors, :func:`~fm_spark_tpu_torch.ops.scatter.compact_aux`), all
    on the params' device. ``sr_noise(step, field, shape)`` gives the SR
    bits of a bf16 ``dedup_sr`` write (default: :class:`~fm_spark_tpu_torch
    .ops.scatter.SrNoise` from ``config.seed + 0x5EED``).
    """
    from fm_spark_tpu_torch.models.field_fm import FieldFMSpec

    if type(spec) is not FieldFMSpec:
        raise ValueError("expected a FieldFMSpec")
    if config.optimizer != "sgd":
        raise ValueError("sparse step implements plain SGD only")
    if config.sparse_update not in scatter_lib.SPARSE_UPDATE_MODES:
        raise ValueError(f"unknown sparse_update mode {config.sparse_update!r}")
    if config.sparse_update != "scatter_add" and not spec.fused_linear:
        raise ValueError("dedup/dedup_sr modes require fused_linear=True")
    if config.use_pallas and not spec.fused_linear:
        raise ValueError("use_pallas requires fused_linear=True")
    _check_host_dedup(config, spec.loss)
    compact = config.compact_cap > 0
    if compact and not spec.fused_linear:
        raise ValueError("compact_cap requires fused_linear=True")
    col = spec.table_layout == "col"
    if col and not compact:
        raise ValueError(
            "table_layout='col' requires the compact path (compact_cap "
            "> 0): the plain per-lane gather/scatter assumes row-major "
            "tables"
        )
    if col and config.use_pallas:
        raise ValueError("table_layout='col' and use_pallas are exclusive")
    if config.gfull_fused and not spec.fused_linear:
        raise ValueError("gfull_fused targets the fused-linear g_full "
                         "construction; it requires fused_linear=True")
    _reject_rest(config)
    fused_bwd = _resolve_fused_embed(spec, config) == "fm_compact_bwd"
    _reject_unported(spec, config, compact, col)
    per_example_loss = losses_lib.loss_fn(spec.loss)
    cd = spec.cdtype
    k = spec.rank
    lr_at = _lr_at(config)
    mode = config.sparse_update
    noise_box = [sr_noise]

    def noise_for(table, step_idx, f, shape):
        if mode != "dedup_sr" or table.dtype == torch.float32:
            return None
        if noise_box[0] is None:
            noise_box[0] = scatter_lib.SrNoise(config.seed + 0x5EED,
                                               table.device)
        return noise_box[0](step_idx, f, shape)

    def loss_and_grad(scores, labels, weights):
        sc = scores.detach().requires_grad_(True)
        with torch.enable_grad():
            wsum = torch.clamp(weights.sum(), min=1.0)
            loss = (per_example_loss(sc, labels) * weights).sum() / wsum
            (dscores,) = torch.autograd.grad(loss, sc)
        return loss.detach(), dscores

    @torch.no_grad()
    def step(params, step_idx, ids, vals, labels, weights, aux=None):
        if config.host_dedup and aux is None:
            raise ValueError(
                "host_dedup step needs the batch's dedup_aux operand"
            )
        step_idx = int(step_idx)
        w0 = params["w0"]
        tables = params["vw"]
        vals_c = vals.to(cd)
        if compact:
            urows, rows = _compact_gather_all(tables, aux, cd)
        else:
            urows, rows = None, _gather_all(tables, ids, cd)
        if config.gfull_fused:
            xv_fulls = [r * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
            xvs = [x[:, :k] for x in xv_fulls]
        else:
            xvs = [r[:, :k] * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
        s = _seq_sum(xvs)                                   # [B, k]
        sum_sq = _seq_sum([_sum_upcast(x * x, 1) for x in xvs])
        scores = 0.5 * (_sum_upcast(s * s, 1) - sum_sq)
        lins = [r[:, k] for r in rows]
        if spec.use_linear:
            if config.gfull_fused:
                scores = scores + _seq_sum([x[:, k] for x in xv_fulls])
            else:
                scores = scores + _seq_sum(
                    [l * vals_c[:, f] for f, l in enumerate(lins)])
        if spec.use_bias:
            scores = scores + w0.to(cd)
        loss, dscores = loss_and_grad(scores, labels, weights)
        lr = lr_at(step_idx)
        neg_lr = float(-lr)
        touched = weights > 0

        if fused_bwd:
            _fused_compact_updates(tables, urows, aux, s, dscores, vals,
                                   weights, config, noise_for, step_idx,
                                   neg_lr, k, cd, spec.use_linear)
        else:
            if config.gfull_fused:
                g_fulls = _gfull_grads(dscores, vals_c, s, xv_fulls, rows,
                                       touched.to(cd), k, cd, spec.use_linear,
                                       config)
            else:
                g_fulls = []
                for f in range(len(tables)):
                    g = dscores[:, None] * vals_c[:, f:f + 1] * (s - xvs[f])
                    if config.reg_factors:
                        g = g + (config.reg_factors * rows[f][:, :k]
                                 * touched[:, None])
                    if spec.use_linear:
                        g_lin = dscores * vals_c[:, f]
                        if config.reg_linear:
                            g_lin = g_lin + config.reg_linear * lins[f] * touched
                        g_lin = g_lin[:, None]
                    else:
                        g_lin = torch.zeros(dscores.shape[0], 1, dtype=cd,
                                            device=dscores.device)
                    g_fulls.append(torch.cat([g, g_lin], dim=1))
            if compact:
                _compact_apply_all(tables, g_fulls, urows, config,
                                   noise_for, step_idx, neg_lr, aux)
            else:
                for f, (table, g_full) in enumerate(zip(tables, g_fulls)):
                    scatter_lib.apply_row_updates(
                        table, ids[:, f], g_full.float() * neg_lr, mode)
        if spec.use_bias:
            lr_t = torch.tensor(lr, dtype=torch.float32, device=w0.device)
            w0.sub_(lr_t * (_sum_upcast(dscores) + config.reg_bias * w0))
        return params, loss

    return step


def make_field_sparse_multistep(spec, config: TrainConfig, n: int,
                                sr_noise=None):
    """``n`` fused steps per call over batches stacked on a leading
    ``[n, ...]`` axis: ``mstep(params, step0, m, ids, vals, labels,
    weights, aux=None) → (params, last_loss)`` runs the first ``m`` of
    them as steps ``step0 .. step0+m-1``. A −inf loss (the compact
    overflow poison) sticks once seen, as in the reference's roll."""
    if n < 1:
        raise ValueError(f"steps per call must be >= 1, got {n}")
    body = make_field_sparse_sgd_body(spec, config, sr_noise=sr_noise)

    def mstep(params, step0, m, ids, vals, labels, weights, aux=None):
        loss = torch.zeros((), dtype=torch.float32, device=ids.device)
        for j in range(int(m)):
            a = None if aux is None else tuple(x[j] for x in aux)
            params, lj = body(params, int(step0) + j, ids[j], vals[j],
                              labels[j], weights[j], a)
            loss = torch.where(torch.isneginf(loss), loss, lj)
        return params, loss

    return mstep
