"""Fused sparse-SGD steps of FieldFM and FieldFFM: analytic row gradients
written straight into the tables, no dense gradient (the port of the
FieldFM and FieldFFM bodies of ``fm_spark_tpu/sparse.py``).

Forms ported (the others raise with the ROADMAP item that queues them):

- without a cap, every ``sparse_update``: ``scatter_add`` (one
  ``index_add_`` per field of every lane's row delta), and ``dedup`` /
  ``dedup_sr`` on ``B`` lanes, deduplicated by the device sort or by the
  host's ``dedup_aux`` (``host_dedup=True, compact_cap=0``);
- ``use_pallas``: the row gathers and the ``scatter_add``/``dedup``
  writes through the row kernels (``ops.rows``, by ``scatter.pallas_gather``
  and ``scatter._pallas_dedup_add``);
- the compact host-aux path (``host_dedup=True, compact_cap > 0``) in
  ``dedup`` and ``dedup_sr``;
- FieldFM: ``gfull_fused`` on or off, ``segtotal_pallas`` on or off
  (kernel A, ``ops.segsum``), and ``fused_embed`` off / auto / require
  (kernel B, ``ops.fused_bwd``);
- FieldFFM: the ``[B, F, F, k]`` sel tensor, or with ``sel_blocked`` the
  per-owner-field loop, and with ``sel_blocked`` and ``fused_embed`` the
  two ``ffm_sel`` kernels (``ops.ffm_sel``).

Every elementwise operation runs in the spec's compute dtype in the
reference's order, and ``lr`` is a float32 scalar, so ``-lr·g_full`` is
float32 even when ``g_full`` is bf16 (JAX's promotion of a strongly
typed float32 scalar). A Python-float reg beside a compute-dtype array is
rounded to that dtype first, as JAX treats a weakly typed scalar. Tables
and ``w0`` are updated IN PLACE: the JAX step donates them, and the port
never holds two copies of them.
"""

from __future__ import annotations

import functools
import operator

import torch

from fm_spark_tpu_torch.ops import KernelUnavailable
from fm_spark_tpu_torch.ops import ffm_sel as ffm_sel_lib
from fm_spark_tpu_torch.ops import fused_bwd as fused_bwd_lib
from fm_spark_tpu_torch.ops import losses as losses_lib
from fm_spark_tpu_torch.ops import scatter as scatter_lib
from fm_spark_tpu_torch.ops.fm import sum_upcast as _sum_upcast
from fm_spark_tpu_torch.train import TrainConfig, _lr_at

__all__ = ["fused_embed_plan", "make_field_ffm_sparse_sgd_body",
           "make_field_sparse_multistep", "make_field_sparse_sgd_body"]


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


def _reject_unported(config: TrainConfig, col: bool = False,
                     fused_linear: bool = True):
    """Forms the JAX steps take that the port does not have yet."""
    if config.compact_device:
        raise ValueError("compact_device (the in-step aux build) is not "
                         "ported yet (ROADMAP Queue 1)")
    if col:
        raise ValueError("table_layout='col' training is not ported yet "
                         "(ROADMAP Queue 1)")
    if not fused_linear:
        raise ValueError("fused_linear=False training is not ported yet "
                         "(ROADMAP Queue 1)")


# The reference's guards for levers of other steps, with its messages;
# ``what`` names the step.


def _reject_embed_tier_require(config: TrainConfig, what: str):
    if config.embed_tier not in ("off", "auto", "require"):
        raise ValueError(
            f"unknown embed_tier {config.embed_tier!r} "
            "(expected 'off', 'auto', or 'require')")
    if config.embed_tier == "require":
        raise ValueError(
            f"embed_tier='require' is served by the tiered flat-FM "
            f"trainer (fm_spark_tpu.embed.TieredTrainer), not {what}; "
            "use 'auto' for fallback-to-in-HBM semantics")


def _reject_collective_dtype(config: TrainConfig, what: str):
    if config.collective_dtype != "float32":
        raise ValueError(
            f"collective_dtype={config.collective_dtype!r} is not "
            f"supported by {what}; it is a field-sharded-step knob")


def _reject_score_sharded(config: TrainConfig, what: str):
    if config.score_sharded:
        raise ValueError(
            f"score_sharded is implemented for the field-sharded FM "
            f"step only, not {what}")


def _reject_sel_blocked(config: TrainConfig, what: str):
    if config.sel_blocked:
        raise ValueError(
            f"sel_blocked is the FieldFFM fused body's lever (it blocks "
            f"the [B, F, F, k] interaction tensor), not {what}")


def _reject_deep_sharded(config: TrainConfig, what: str):
    if config.deep_sharded:
        raise ValueError(
            f"deep_sharded is implemented for the field-sharded DeepFM "
            f"step only, not {what}")


def _reject_gfull(config: TrainConfig, what: str):
    if config.gfull_fused:
        raise ValueError(
            f"gfull_fused is implemented for the FieldFM and "
            f"FieldDeepFM fused bodies, not {what}")


def fused_embed_plan(spec, config: TrainConfig):
    """Resolve ``TrainConfig.fused_embed`` against (spec, config): returns
    ``(family, reason)`` — ``'fm_compact_bwd'`` (kernel B), ``'ffm_sel'``
    (the sel-blocked FieldFFM kernels) or None with ``reason`` naming why
    the plain torch path runs instead."""
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec
    from fm_spark_tpu_torch.models.field_fm import FieldFMSpec

    if config.fused_embed not in ("off", "auto", "require"):
        raise ValueError(
            f"unknown fused_embed {config.fused_embed!r} "
            "(expected 'off', 'auto', or 'require')")
    if config.fused_embed == "off":
        return None, "fused_embed='off'"
    if type(spec) is FieldFMSpec:
        if config.compact_cap <= 0:
            return None, ("the fused FM backward rides the compact "
                          "update; it needs compact_cap > 0")
        if not spec.fused_linear:
            return None, "the fused FM backward needs fused_linear=True"
        if spec.table_layout == "col":
            return None, ("table_layout='col' stores transposed tables; "
                          "the kernel reads row-major unique rows")
        reason = fused_bwd_lib.fm_bwd_supported(
            config.compact_cap, spec.rank + 1, spec.num_fields)
        if reason:
            return None, reason
        return "fm_compact_bwd", None
    if type(spec) is FieldFFMSpec:
        if not config.sel_blocked:
            return None, ("the ffm_sel kernels mirror the sel-blocked "
                          "body (set sel_blocked=True)")
        reason = ffm_sel_lib.ffm_sel_supported(
            spec.num_fields, spec.rank, spec.cdtype.itemsize)
        if reason:
            return None, reason
        return "ffm_sel", None
    return None, f"no fused kernel family for {type(spec).__name__}"


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


def _as_cd(value: float, cd: torch.dtype) -> float:
    """``value`` rounded to the compute dtype: a Python float beside a
    ``cd`` array in JAX is converted to ``cd`` before the multiply, where
    PyTorch would multiply by the float32 value."""
    return float(torch.tensor(value, dtype=cd))


def _compact_gather_all(tables, aux, cd):
    """Each field's ``cap`` unique rows gathered once (storage dtype) and
    the per-lane rows expanded from them by ``inv`` (compute dtype)."""
    useg, inv = aux[0], aux[4]
    urows = [scatter_lib.compact_gather(t, useg[f])
             for f, t in enumerate(tables)]
    rows = [u.to(cd)[inv[f].long()] for f, u in enumerate(urows)]
    return urows, rows


def _gather_all(tables, ids, cd, use_pallas: bool):
    """One gather per field, cast to compute dtype: with ``use_pallas`` by
    the gather kernel (ids clamped into the table,
    ``scatter.pallas_gather``), else as JAX's indexing (an id in
    ``[-n, 0)`` counts from the end, then ids clamp into the table)."""
    if use_pallas:
        return [scatter_lib.pallas_gather(t, ids[:, f]).to(cd)
                for f, t in enumerate(tables)]
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


def _noise_fn(config: TrainConfig, sr_noise):
    """``noise_for(table, step_idx, field, shape)``: the SR bits of a bf16
    ``dedup_sr`` write, else None (default source: :class:`~fm_spark_tpu_torch
    .ops.scatter.SrNoise` from ``config.seed + 0x5EED``)."""
    noise_box = [sr_noise]

    def noise_for(table, step_idx, f, shape):
        if config.sparse_update != "dedup_sr" or table.dtype == torch.float32:
            return None
        if noise_box[0] is None:
            noise_box[0] = scatter_lib.SrNoise(config.seed + 0x5EED,
                                               table.device)
        return noise_box[0](step_idx, f, shape)

    return noise_for


def _loss_and_grad_fn(loss_name: str):
    """``(scores, labels, weights) → (loss, dscores)``: the weighted mean
    loss and its gradient with respect to the scores."""
    per_example_loss = losses_lib.loss_fn(loss_name)

    def loss_and_grad(scores, labels, weights):
        sc = scores.detach().requires_grad_(True)
        with torch.enable_grad():
            wsum = torch.clamp(weights.sum(), min=1.0)
            loss = (per_example_loss(sc, labels) * weights).sum() / wsum
            (dscores,) = torch.autograd.grad(loss, sc)
        return loss.detach(), dscores

    return loss_and_grad


def _apply_updates(compact, tables, ids, g_fulls, rows, urows,
                   config: TrainConfig, noise_for, step_idx, neg_lr, aux):
    """Write ``-lr·g_full`` into every field's table: the compact update,
    or the per-lane write of ``config.sparse_update`` (the reference's
    ``_updates_for`` / ``_apply_field_updates``), with the host's
    ``dedup_aux`` sliced per field when the batch carries it."""
    if compact:
        _compact_apply_all(tables, g_fulls, urows, config, noise_for,
                           step_idx, neg_lr, aux)
        return
    for f, (table, g_full) in enumerate(zip(tables, g_fulls)):
        scatter_lib.apply_row_updates(
            table, ids[:, f], g_full.float() * neg_lr, config.sparse_update,
            noise=noise_for(table, step_idx, f, g_full.shape),
            old_rows=rows[f], use_pallas=config.use_pallas,
            aux=None if aux is None else tuple(a[f] for a in aux))


def _update_bias(w0, lr, dscores, config: TrainConfig):
    """``w0 -= lr·(Σ dscores + reg_bias·w0)`` in float32, in place."""
    lr_t = torch.tensor(lr, dtype=torch.float32, device=w0.device)
    w0.sub_(lr_t * (_sum_upcast(dscores) + config.reg_bias * w0))


def make_field_sparse_sgd_body(spec, config: TrainConfig, sr_noise=None):
    """The fused sparse-SGD step of a FieldFM:
    ``step(params, step_idx, ids, vals, labels, weights, aux=None) →
    (params, loss)``, updating ``params`` in place.

    ``ids`` int32 ``[B, F]`` (field-local), ``vals`` float32 ``[B, F]``,
    ``labels``/``weights`` float32 ``[B]``, ``aux`` the host aux of
    ``host_dedup`` (the compact aux, five int32 tensors of
    :func:`~fm_spark_tpu_torch.ops.scatter.compact_aux`, or without a cap
    the four ``[F, B]`` of :func:`~fm_spark_tpu_torch.ops.scatter.dedup_aux`),
    all on the params' device. ``sr_noise(step, field, shape)`` gives the SR
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
    what = "the single-chip FieldFM body"
    _reject_embed_tier_require(config, what)
    _reject_collective_dtype(config, what)
    _reject_score_sharded(config, what)
    _reject_sel_blocked(config, what)
    _reject_deep_sharded(config, what)
    fused_bwd = _resolve_fused_embed(spec, config) == "fm_compact_bwd"
    _reject_unported(config, col, spec.fused_linear)
    loss_and_grad = _loss_and_grad_fn(spec.loss)
    cd = spec.cdtype
    k = spec.rank
    lr_at = _lr_at(config)
    noise_for = _noise_fn(config, sr_noise)
    reg_factors = _as_cd(config.reg_factors, cd)
    reg_linear = _as_cd(config.reg_linear, cd)

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
            urows, rows = None, _gather_all(tables, ids, cd,
                                            config.use_pallas)
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
                        g = g + (reg_factors * rows[f][:, :k]
                                 * touched[:, None])
                    if spec.use_linear:
                        g_lin = dscores * vals_c[:, f]
                        if config.reg_linear:
                            g_lin = g_lin + reg_linear * lins[f] * touched
                        g_lin = g_lin[:, None]
                    else:
                        g_lin = torch.zeros(dscores.shape[0], 1, dtype=cd,
                                            device=dscores.device)
                    g_fulls.append(torch.cat([g, g_lin], dim=1))
            _apply_updates(compact, tables, ids, g_fulls, rows, urows,
                           config, noise_for, step_idx, neg_lr, aux)
        if spec.use_bias:
            _update_bias(w0, lr, dscores, config)
        return params, loss

    return step


def make_field_ffm_sparse_sgd_body(spec, config: TrainConfig, sr_noise=None):
    """The fused sparse-SGD step of a FieldFFM, with the same signature and
    in-place contract as :func:`make_field_sparse_sgd_body`.

    With ``sel[b,i,j] = v[id_i, field j]·x_i`` the pairwise term is
    ``½ Σ_{i≠j} ⟨sel[b,i,j], sel[b,j,i]⟩``, so the factor gradient of owner
    field ``i`` toward field ``j`` is ``ds_b·sel[b,j,i]·x_i`` (zero for
    ``j = i``). Three forms compute it: the ``[B, F, F, k]`` sel tensor;
    with ``sel_blocked`` a loop over owner fields that builds one
    ``[B, F, k]`` pair at a time; and with ``sel_blocked`` and
    ``fused_embed`` the two ``ffm_sel`` kernels on the stacked rows.
    """
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec

    if type(spec) is not FieldFFMSpec:
        raise ValueError("expected a FieldFFMSpec")
    if config.optimizer != "sgd":
        raise ValueError("sparse step implements plain SGD only")
    what = "the single-chip FieldFFM body"
    _reject_gfull(config, "the FieldFFM body")
    _reject_embed_tier_require(config, what)
    _reject_collective_dtype(config, what)
    _reject_score_sharded(config, what)
    _reject_deep_sharded(config, what)
    kernels = _resolve_fused_embed(spec, config) == "ffm_sel"
    _check_host_dedup(config, spec.loss)
    if config.sparse_update not in scatter_lib.SPARSE_UPDATE_MODES:
        raise ValueError(f"unknown sparse_update mode {config.sparse_update!r}")
    compact = config.compact_cap > 0
    _reject_unported(config)
    loss_and_grad = _loss_and_grad_fn(spec.loss)
    cd = spec.cdtype
    F, k = spec.num_fields, spec.rank
    fk = F * k
    lr_at = _lr_at(config)
    noise_for = _noise_fn(config, sr_noise)
    reg_factors = _as_cd(config.reg_factors, cd)
    reg_linear = _as_cd(config.reg_linear, cd)

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
            urows, rows = None, _gather_all(
                tables, ids, cd, config.use_pallas)         # F × [B, F·k+1]
        rv = [r[:, :fk].reshape(-1, F, k) for r in rows]

        def selt(i):
            """``sel[b, j, i]`` for every j: ``[B, F, k]``."""
            return (torch.stack([rv[j][:, i, :] for j in range(F)], dim=1)
                    * vals_c[:, :, None])

        if kernels:
            rstk = torch.stack([r[:, :fk] for r in rows], dim=1)
            scores = 0.5 * ffm_sel_lib.ffm_sel_scores(rstk, vals_c)
        elif config.sel_blocked:
            acc = torch.zeros_like(vals_c[:, 0])
            for i in range(F):
                sel_i = rv[i] * vals_c[:, i, None, None]        # [B, F, k]
                prod = _sum_upcast(sel_i * selt(i), -1)         # [B, F]
                acc = acc + _sum_upcast(prod, 1) - prod[:, i]
            scores = 0.5 * acc
        else:
            sel = spec._sel(rows, vals_c)                       # [B, F, F, k]
            a = _sum_upcast(sel * sel.transpose(1, 2), -1)
            diag = _sum_upcast(torch.diagonal(a, dim1=1, dim2=2), -1)
            scores = 0.5 * (_sum_upcast(a, (1, 2)) - diag)
        lins = [r[:, fk] for r in rows]
        if spec.use_linear:
            scores = scores + sum(l * vals_c[:, i] for i, l in enumerate(lins))
        if spec.use_bias:
            scores = scores + w0.to(cd)
        loss, dscores = loss_and_grad(scores, labels, weights)
        lr = lr_at(step_idx)
        neg_lr = float(-lr)
        touched = weights > 0

        if kernels:
            dvs_stk = ffm_sel_lib.ffm_sel_bwd(rstk, vals_c, dscores.to(cd))
            dvs = [dvs_stk[:, i, :] for i in range(F)]
        elif config.sel_blocked:
            ds_cd = dscores.to(cd)
            dvs = []
            for i in range(F):
                dsel_i = ds_cd[:, None, None] * selt(i)
                dsel_i[:, i, :] = 0
                dvs.append((dsel_i * vals_c[:, i, None, None]).reshape(-1, fk))
        else:
            dsel = dscores[:, None, None, None] * sel.transpose(1, 2)
            eye = torch.eye(F, dtype=cd, device=dsel.device)[None, :, :, None]
            dsel = dsel * (1.0 - eye)
            dv = (dsel * vals_c[:, :, None, None]).reshape(-1, F, fk)
            dvs = [dv[:, f, :] for f in range(F)]

        g_fulls = []
        for f in range(F):
            g_v = dvs[f]
            if config.reg_factors:
                g_v = g_v + reg_factors * rows[f][:, :fk] * touched[:, None]
            if spec.use_linear:
                g_l = dscores * vals_c[:, f]
                if config.reg_linear:
                    g_l = g_l + reg_linear * lins[f] * touched
            else:
                g_l = torch.zeros_like(dscores)
            g_fulls.append(torch.cat([g_v, g_l[:, None]], dim=1))
        _apply_updates(compact, tables, ids, g_fulls, rows, urows, config,
                       noise_for, step_idx, neg_lr, aux)
        if spec.use_bias:
            _update_bias(w0, lr, dscores, config)
        return params, loss

    return step


def make_field_sparse_multistep(spec, config: TrainConfig, n: int,
                                sr_noise=None):
    """``n`` fused steps per call over batches stacked on a leading
    ``[n, ...]`` axis: ``mstep(params, step0, m, ids, vals, labels,
    weights, aux=None) → (params, last_loss)`` runs the first ``m`` of
    them as steps ``step0 .. step0+m-1``, through the FieldFFM body for a
    :class:`~fm_spark_tpu_torch.models.FieldFFMSpec` and the FieldFM body
    otherwise. A −inf loss (the compact overflow poison) sticks once seen,
    as in the reference's roll."""
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec

    if n < 1:
        raise ValueError(f"steps per call must be >= 1, got {n}")
    body = (make_field_ffm_sparse_sgd_body(spec, config, sr_noise=sr_noise)
            if isinstance(spec, FieldFFMSpec)
            else make_field_sparse_sgd_body(spec, config, sr_noise=sr_noise))

    def mstep(params, step0, m, ids, vals, labels, weights, aux=None):
        loss = torch.zeros((), dtype=torch.float32, device=ids.device)
        for j in range(int(m)):
            a = None if aux is None else tuple(x[j] for x in aux)
            params, lj = body(params, int(step0) + j, ids[j], vals[j],
                              labels[j], weights[j], a)
            loss = torch.where(torch.isneginf(loss), loss, lj)
        return params, loss

    return mstep
