"""Fused sparse-SGD steps of FieldFM, FieldFFM and FieldDeepFM: analytic
row gradients written straight into the tables, no dense gradient (the
port of the FieldFM, FieldFFM and FieldDeepFM bodies of
``fm_spark_tpu/sparse.py``). FieldDeepFM's step is hybrid: its tables
take the FieldFM forms below with the MLP's pullback added, its MLP and
``w0`` the dense optimizer (Adam for config 5).

Forms ported (the guards refuse what the reference refuses, in its words):

- without a cap, every ``sparse_update``: ``scatter_add`` (one
  ``index_add_`` per field of every lane's row delta), and ``dedup`` /
  ``dedup_sr`` on ``B`` lanes, deduplicated by the device sort or by the
  host's ``dedup_aux`` (``host_dedup=True, compact_cap=0``);
- ``use_pallas``: the row gathers and the ``scatter_add``/``dedup``
  writes through the row kernels (``ops.rows``, by ``scatter.pallas_gather``
  and ``scatter._pallas_dedup_add``);
- the compact path in ``dedup`` and ``dedup_sr``, on the host's aux
  (``host_dedup=True, compact_cap > 0``) or on the aux the step builds
  (``compact_device``: ``scatter.device_compact_aux``; a field past the
  cap poisons the loss to −inf under ``compact_overflow='error'``, or
  its ids past the cap act as absent features under ``'drop'``);
- FieldFM: ``gfull_fused`` on or off, ``segtotal_pallas`` on or off
  (kernel A, ``ops.segsum``), and ``fused_embed`` off / auto / require
  (kernel B, ``ops.fused_bwd``); the transposed ``table_layout='col'``
  tables on the compact path (the row layout's values, bit for bit), and
  the unfused ``fused_linear=False`` tables under ``scatter_add``
  (``scatter.apply_split_row_updates``: each id's lanes summed once by the
  device dedup, kernel A on the card);
- FieldFFM: the ``[B, F, F, k]`` sel tensor, or with ``sel_blocked`` the
  per-owner-field loop, and with ``sel_blocked`` and ``fused_embed`` the
  two ``ffm_sel`` kernels (``ops.ffm_sel``).

The bodies run eagerly; :func:`make_field_sparse_sgd_step`,
:func:`make_field_ffm_sparse_sgd_step`, :func:`make_field_deepfm_sparse_step`,
the rolls :func:`make_field_sparse_multistep` and
:func:`make_field_deepfm_multistep`, and
:func:`precompile_field_sparse_step` capture them on the card as CUDA
graphs (``graphs.py``), the counterparts of the reference's jitted,
rolled and precompiled steps. A body reads nothing of the device on the
host: the step counter and learning rate live on the device, and the SR
bits follow JAX's threefry key schedule there (``ops.srbits``).

Every elementwise operation runs in the spec's compute dtype in the
reference's order, and ``lr`` is a float32 scalar, so ``-lr·g_full`` is
float32 even when ``g_full`` is bf16 (JAX's promotion of a strongly
typed float32 scalar). A Python-float reg beside a compute-dtype array is
rounded to that dtype first, as JAX treats a weakly typed scalar. Tables
and ``w0`` (and FieldDeepFM's MLP and optimizer state) are updated IN
PLACE: the JAX step donates them, and the port never holds two copies of
them.
"""

from __future__ import annotations

import torch

from fm_spark_tpu_torch import graphs
from fm_spark_tpu_torch.ops import KernelUnavailable
from fm_spark_tpu_torch.ops import ffm_sel as ffm_sel_lib
from fm_spark_tpu_torch.ops import fused_bwd as fused_bwd_lib
from fm_spark_tpu_torch.ops import losses as losses_lib
from fm_spark_tpu_torch.ops import scatter as scatter_lib
from fm_spark_tpu_torch.ops.fm import seq_sum as _seq_sum
from fm_spark_tpu_torch.ops.fm import sum_upcast as _sum_upcast
from fm_spark_tpu_torch.train import TrainConfig, _lr_at_tensor

__all__ = ["fused_embed_plan", "make_field_deepfm_multistep",
           "make_field_deepfm_sparse_body", "make_field_deepfm_sparse_step",
           "make_field_ffm_sparse_sgd_body", "make_field_ffm_sparse_sgd_step",
           "make_field_sparse_multistep", "make_field_sparse_sgd_body",
           "make_field_sparse_sgd_step", "make_sgd_step",
           "make_sparse_sgd_step", "precompile_field_sparse_step"]


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
            f"trainer (fm_spark_tpu_torch.embed.TieredTrainer), not {what}; "
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


def _reject_fused_embed_require(config: TrainConfig, what: str):
    if config.fused_embed not in ("off", "auto", "require"):
        raise ValueError(
            f"unknown fused_embed {config.fused_embed!r} "
            "(expected 'off', 'auto', or 'require')")
    if config.fused_embed == "require":
        raise ValueError(
            f"fused_embed='require' is served by the single-chip "
            f"FieldFM compact backward and sel-blocked FieldFFM fused "
            f"bodies, not {what}; use 'auto' for fallback-to-XLA "
            "semantics")


def _reject_host_aux(config: TrainConfig, what: str):
    """Guard for steps that take no aux operand: an explicit fast-path
    request fails rather than train without it."""
    if config.host_dedup or config.compact_cap:
        raise ValueError(
            f"the HOST-built dedup/compact aux is not supported by "
            f"{what}; drop host_dedup (compact_device=True is the "
            "form that composes with sharded layouts where supported)"
        )
    if config.segtotal_pallas:
        raise ValueError(
            f"segtotal_pallas rides the compact fused update, which is "
            f"not part of {what}"
        )


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
                          "the kernel's resident urows block is "
                          "row-major")
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


def _compact_gather_all(tables, aux, cd, mask_overflow: bool = False,
                        col: bool = False):
    """Each field's ``cap`` unique rows gathered once (storage dtype) and
    the per-lane rows expanded from them by ``inv`` (compute dtype);
    ``col``: from transposed tables, the same values.

    ``mask_overflow`` (the device-built aux, which cannot raise): a lane
    whose segment lies past ``cap`` expands to a ZERO row (the overflow
    drop's absent feature), the clipped row times 0, as the reference.
    The host's aux guarantees ``inv < cap``."""
    useg, inv = aux[0], aux[4]
    cap = useg.shape[-1]
    urows = [scatter_lib.compact_gather(t, useg[f], col)
             for f, t in enumerate(tables)]
    if not mask_overflow:
        return urows, [u.to(cd)[inv[f].long()] for f, u in enumerate(urows)]
    rows = [u.to(cd)[inv[f].long().clamp(max=cap - 1)]
            * (inv[f] < cap)[:, None].to(cd) for f, u in enumerate(urows)]
    return urows, rows


def _rows_for(compact, tables, aux, cd, ids, config: TrainConfig,
              col: bool = False):
    """The bodies' forward table access: ``(urows, rows, aux, ovf)`` from
    the device-built compact aux (``compact_device``), the host's compact
    aux, or the per-lane gather. ``ovf`` is the worst field's segment
    count past the cap (a 0-dim int32 on the device; None but for the
    device aux), and ``aux`` the one the update half reads. ``col``
    (compact only): the tables are stored transposed."""
    if config.compact_device:
        cap = config.compact_cap
        aux, nseg = scatter_lib.device_compact_aux(ids, cap)
        ovf = (nseg.max() - cap).clamp(min=0)
        urows, rows = _compact_gather_all(tables, aux, cd, mask_overflow=True,
                                          col=col)
        return urows, rows, aux, ovf
    if compact:
        return (*_compact_gather_all(tables, aux, cd, col=col), aux, None)
    return None, _gather_all(tables, ids, cd, config.use_pallas), aux, None


def _fold_overflow(loss, ovf, config: TrainConfig):
    """The device aux's overflow policy: ``'error'`` poisons the loss to
    −inf (unambiguous for the non-negative losses, which a diverging run
    takes to +inf), with no read on the host; ``'drop'`` keeps the
    absent-feature semantics silently."""
    if ovf is None or config.compact_overflow == "drop":
        return loss
    return torch.where(ovf > 0, torch.full_like(loss, float("-inf")), loss)


def _step_tensor(step_idx, device) -> torch.Tensor:
    """The step as a 0-dim int32 tensor on ``device``: a Python int is
    filled in on the device (no copy from the host), a tensor passes."""
    if isinstance(step_idx, torch.Tensor):
        if step_idx.dim() != 0 or step_idx.is_floating_point():
            raise ValueError(f"step must be an int or a 0-dim integer tensor, "
                             f"got {step_idx.dtype} {tuple(step_idx.shape)}")
        return step_idx.to(device=device, dtype=torch.int32)
    return torch.full((), int(step_idx), dtype=torch.int32, device=device)


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
                 use_linear: bool, config: TrainConfig, extra=None):
    """The fused g_full construction per field (``gfull_fused``):
    ``(ds·(s1 − mask·xv_full) + extra_f)·x + rv·rows·touched``, with
    ``extra`` FieldDeepFM's deep-head pullback as one zero-padded
    ``[B, F, k+1]`` tensor (None for FieldFM)."""
    s1, rv = _s1_and_rv(s, k, cd, use_linear, config)
    rv = fused_bwd_lib.rv_vector(rv, k, cd, s.device)
    colmask = torch.arange(k + 1, device=s.device) < k
    return [fused_bwd_lib.gfull(rows[f], xv_fulls[f], s1, dscores,
                                vals_c[:, f], touched_c, rv, colmask,
                                None if extra is None else extra[:, f])
            for f in range(len(rows))]


def _compact_apply_all(tables, g_fulls, urows, config: TrainConfig,
                       noise_for, step_idx, neg_lr, aux, col: bool = False):
    """COMPACT update: per field, the segment totals of ``-lr·g_full``
    (float32) and one write per unique id (``scatter.compact_apply``;
    ``col``: into transposed tables)."""
    for f, (table, g_full) in enumerate(zip(tables, g_fulls)):
        scatter_lib.compact_apply(
            table, g_full.float() * neg_lr, tuple(a[f] for a in aux),
            config.sparse_update, noise_for(table, step_idx, f,
                                            urows[f].shape),
            urows[f], segtotal_pallas=config.segtotal_pallas, col=col)


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
    ``dedup_sr`` write, else None. The default source is JAX's key
    schedule from ``config.seed + 0x5EED`` (:class:`~fm_spark_tpu_torch
    .ops.scatter.SrNoise`, on the table's device); ``sr_noise(step, field,
    shape)`` replaces it, called with the step as the caller gave it."""

    def noise_for(table, step_idx, f, shape):
        if config.sparse_update != "dedup_sr" or table.dtype == torch.float32:
            return None
        if sr_noise is not None:
            return sr_noise(step_idx, f, shape)
        return scatter_lib.SrNoise(config.seed + 0x5EED,
                                   table.device)(step_idx, f, shape)

    return noise_for


def _loss_and_grad_fn(loss_name: str):
    """``(scores, labels, weights, wsum=None) → (loss, dscores)``: the
    weighted mean loss and its gradient with respect to the scores;
    ``wsum`` (a data-parallel step's weight total over every rank)
    replaces ``max(Σ weights, 1)``."""
    per_example_loss = losses_lib.loss_fn(loss_name)

    def loss_and_grad(scores, labels, weights, wsum=None):
        sc = scores.detach().requires_grad_(True)
        with torch.enable_grad():
            if wsum is None:
                wsum = torch.clamp(weights.sum(), min=1.0)
            loss = (per_example_loss(sc, labels) * weights).sum() / wsum
            (dscores,) = torch.autograd.grad(loss, sc)
        return loss.detach(), dscores

    return loss_and_grad


def _apply_updates(compact, tables, ids, g_fulls, rows, urows,
                   config: TrainConfig, noise_for, step_idx, neg_lr, aux,
                   col: bool = False):
    """Write ``-lr·g_full`` into every field's table: the compact update,
    or the per-lane write of ``config.sparse_update`` (the reference's
    ``_updates_for`` / ``_apply_field_updates``), with the host's
    ``dedup_aux`` sliced per field when the batch carries it."""
    if compact:
        _compact_apply_all(tables, g_fulls, urows, config, noise_for,
                           step_idx, neg_lr, aux, col)
        return
    for f, (table, g_full) in enumerate(zip(tables, g_fulls)):
        scatter_lib.apply_row_updates(
            table, ids[:, f], g_full.float() * neg_lr, config.sparse_update,
            noise=noise_for(table, step_idx, f, g_full.shape),
            old_rows=rows[f], use_pallas=config.use_pallas,
            aux=None if aux is None else tuple(a[f] for a in aux))


def _update_bias(w0, lr, dscores, config: TrainConfig):
    """``w0 -= lr·(Σ dscores + reg_bias·w0)`` in float32, in place (``lr``
    a 0-dim float32 tensor on the device)."""
    w0.sub_(lr * (_sum_upcast(dscores) + config.reg_bias * w0))


def make_field_sparse_sgd_body(spec, config: TrainConfig, sr_noise=None):
    """The fused sparse-SGD step of a FieldFM:
    ``step(params, step_idx, ids, vals, labels, weights, aux=None) →
    (params, loss)``, updating ``params`` in place.

    ``ids`` int32 ``[B, F]`` (field-local), ``vals`` float32 ``[B, F]``,
    ``labels``/``weights`` float32 ``[B]``, ``aux`` the host aux of
    ``host_dedup`` (the compact aux, five int32 tensors of
    :func:`~fm_spark_tpu_torch.ops.scatter.compact_aux`, or without a cap
    the four ``[F, B]`` of :func:`~fm_spark_tpu_torch.ops.scatter.dedup_aux`),
    all on the params' device (None with ``compact_device``: the step
    builds its own). ``step_idx`` is an int or a 0-dim integer tensor on
    the params' device. ``sr_noise(step, field, shape)`` gives the SR bits
    of a bf16 ``dedup_sr`` write (default: JAX's key schedule,
    :class:`~fm_spark_tpu_torch.ops.scatter.SrNoise` from ``config.seed +
    0x5EED``). With ``compact_overflow='error'`` a field past the cap of
    the device aux returns a −inf loss.
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
    loss_and_grad = _loss_and_grad_fn(spec.loss)
    cd = spec.cdtype
    k = spec.rank
    lr_at = _lr_at_tensor(config)
    noise_for = _noise_fn(config, sr_noise)
    reg_factors = fused_bwd_lib.round_to(config.reg_factors, cd)
    reg_linear = fused_bwd_lib.round_to(config.reg_linear, cd)

    @torch.no_grad()
    def step(params, step_idx, ids, vals, labels, weights, aux=None):
        if config.host_dedup and aux is None:
            raise ValueError(
                "host_dedup step needs the batch's dedup_aux operand"
            )
        w0 = params["w0"]
        vals_c = vals.to(cd)
        if spec.fused_linear:
            tables = params["vw"]
            urows, rows, aux, ovf = _rows_for(compact, tables, aux, cd, ids,
                                              config, col)
            lins = [r[:, k] for r in rows]
        else:
            # The unfused form: factor rows and linear weights apart.
            urows, ovf = None, None
            rows = _gather_all(params["v"], ids, cd, False)
            lins = (_gather_all(params["w"], ids, cd, False)
                    if spec.use_linear else None)
        if config.gfull_fused:
            xv_fulls = [r * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
            xvs = [x[:, :k] for x in xv_fulls]
        else:
            xvs = [r[:, :k] * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
        s = _seq_sum(xvs)                                   # [B, k]
        sum_sq = _seq_sum([_sum_upcast(x * x, 1) for x in xvs])
        scores = 0.5 * (_sum_upcast(s * s, 1) - sum_sq)
        if spec.use_linear:
            if config.gfull_fused:
                scores = scores + _seq_sum([x[:, k] for x in xv_fulls])
            else:
                scores = scores + _seq_sum(
                    [l * vals_c[:, f] for f, l in enumerate(lins)])
        if spec.use_bias:
            scores = scores + w0.to(cd)
        loss, dscores = loss_and_grad(scores, labels, weights)
        lr = lr_at(_step_tensor(step_idx, w0.device))
        neg_lr = -lr
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
                for f in range(len(rows)):
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
            if spec.fused_linear:
                _apply_updates(compact, tables, ids, g_fulls, rows, urows,
                               config, noise_for, step_idx, neg_lr, aux, col)
            else:
                for f, g_full in enumerate(g_fulls):
                    delta = g_full if spec.use_linear else g_full[:, :k]
                    scatter_lib.apply_split_row_updates(
                        params["v"][f],
                        params["w"][f] if spec.use_linear else None,
                        ids[:, f], delta.float() * neg_lr)
        if spec.use_bias:
            _update_bias(w0, lr, dscores, config)
        return params, _fold_overflow(loss, ovf, config)

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
    loss_and_grad = _loss_and_grad_fn(spec.loss)
    cd = spec.cdtype
    F, k = spec.num_fields, spec.rank
    fk = F * k
    lr_at = _lr_at_tensor(config)
    noise_for = _noise_fn(config, sr_noise)
    reg_factors = fused_bwd_lib.round_to(config.reg_factors, cd)
    reg_linear = fused_bwd_lib.round_to(config.reg_linear, cd)

    @torch.no_grad()
    def step(params, step_idx, ids, vals, labels, weights, aux=None):
        if config.host_dedup and aux is None:
            raise ValueError(
                "host_dedup step needs the batch's dedup_aux operand"
            )
        w0 = params["w0"]
        tables = params["vw"]
        vals_c = vals.to(cd)
        urows, rows, aux, ovf = _rows_for(
            compact, tables, aux, cd, ids, config)          # F × [B, F·k+1]
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
        lr = lr_at(_step_tensor(step_idx, w0.device))
        neg_lr = -lr
        touched = weights > 0

        if kernels:
            dvs_stk = ffm_sel_lib.ffm_sel_bwd(rstk, vals_c, dscores.to(cd))
            dvs = [dvs_stk[:, i, :] for i in range(F)]
        elif config.sel_blocked:
            ds_cd = dscores.to(cd)
            dvs = []
            for i in range(F):
                dsel_i = ds_cd[:, None, None] * selt(i)
                dsel_i[:, i, :].zero_()
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
        return params, _fold_overflow(loss, ovf, config)

    return step


def _mlp_forward(spec, mlp, h):
    """The MLP head (``FieldDeepFMSpec.deep_scores``) with what its
    backward needs: ``(kernels, inputs, pre_activations, deep [B])``, the
    kernels cast to the compute dtype."""
    cd = spec.cdtype
    n_hidden = len(spec.mlp_dims)
    kernels, ins, pres = [], [], []
    for li, layer in enumerate(mlp):
        kernel = layer["kernel"].to(cd)
        pre = torch.matmul(h, kernel) + layer["bias"].to(cd)
        kernels.append(kernel)
        ins.append(h)
        pres.append(pre)
        h = torch.relu(pre) if li < n_hidden else pre
    return kernels, ins, pres, h[:, 0]


def _mlp_backward(spec, kernels, ins, pres, g_out):
    """The vjp of the MLP head at the cotangent ``g_out`` [B] (compute
    dtype), as JAX's vjp computes it: per layer ``g_kernel = inᵀ·g`` and
    ``g_bias = Σ_b g`` in the compute dtype, widened to float32 (the vjp
    of the cast), ``g_in = g·kernelᵀ``, and the ReLU's mask. Returns
    ``(per-layer {"kernel", "bias"} gradients, g_h [B, F·k])``. A bf16
    bias sum accumulates in float32 and rounds once (XLA's CPU sums bf16
    in an order of its own)."""
    n_hidden = len(spec.mlp_dims)
    g = g_out[:, None]
    grads = [None] * len(kernels)
    for li in reversed(range(len(kernels))):
        if li < n_hidden:
            g = torch.where(pres[li] > 0, g, torch.zeros_like(g))
        grads[li] = {"kernel": torch.matmul(ins[li].t(), g).float(),
                     "bias": _sum_upcast(g, 0).float()}
        g = torch.matmul(g, kernels[li].t())
    return grads, g


def make_field_deepfm_sparse_body(spec, config: TrainConfig):
    """The fused hybrid step of a FieldDeepFM (the reference's
    ``make_field_deepfm_sparse_body``): ``(body, init_opt_state)`` with
    ``body(params, opt_state, step_idx, ids, vals, labels, weights,
    aux=None) → (params, opt_state, loss)``, updating ``params`` and
    ``opt_state`` in place, and ``init_opt_state(params)`` the dense
    optimizer's state of ``{"w0", "mlp"}``.

    The tables take the analytic sparse rule of the FieldFM body with the
    deep head's pullback added, ``∂L/∂rows_f[:, :k] = ds·x_f·(s − xv_f) +
    g_h[:, f·k:(f+1)·k]·x_f``, through every table form the FieldFM body
    has but the fused backward (``fused_embed='require'`` raises, as in the
    reference). ``w0`` and the MLP are updated by ``config.optimizer``
    (:func:`~fm_spark_tpu_torch.train.make_optimizer`), ``reg_bias·w0``
    and ``reg_factors·p`` added to their gradients. The MLP's backward is
    written out (:func:`_mlp_backward`), its products by ``torch.matmul``.
    Arguments as :func:`make_field_sparse_sgd_body`'s.
    """
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
    from fm_spark_tpu_torch.train import apply_updates, make_optimizer

    if type(spec) is not FieldDeepFMSpec:
        raise ValueError("expected a FieldDeepFMSpec")
    what = "the single-chip FieldDeepFM body"
    _reject_collective_dtype(config, what)
    _reject_score_sharded(config, what)
    _reject_sel_blocked(config, what)
    _reject_deep_sharded(config, what)
    _reject_fused_embed_require(config, what)
    _reject_embed_tier_require(config, what)
    _check_host_dedup(config, spec.loss)
    if config.sparse_update not in scatter_lib.SPARSE_UPDATE_MODES:
        raise ValueError(f"unknown sparse_update mode {config.sparse_update!r}")
    compact = config.compact_cap > 0
    loss_and_grad = _loss_and_grad_fn(spec.loss)
    cd = spec.cdtype
    F, k = spec.num_fields, spec.rank
    lr_at = _lr_at_tensor(config)
    noise_for = _noise_fn(config, None)
    dense_opt = make_optimizer(config)
    reg_factors = fused_bwd_lib.round_to(config.reg_factors, cd)
    reg_linear = fused_bwd_lib.round_to(config.reg_linear, cd)
    # The dense gradients are float32: JAX rounds a Python reg to it.
    reg_bias32 = fused_bwd_lib.round_to(config.reg_bias, torch.float32)
    reg_factors32 = fused_bwd_lib.round_to(config.reg_factors, torch.float32)

    def dense_subtree(params):
        return {"w0": params["w0"], "mlp": params["mlp"]}

    def init_opt_state(params):
        return dense_opt.init(dense_subtree(params))

    @torch.no_grad()
    def body(params, opt_state, step_idx, ids, vals, labels, weights,
             aux=None):
        if config.host_dedup and aux is None:
            raise ValueError(
                "host_dedup step needs the batch's dedup_aux operand"
            )
        w0 = params["w0"]
        tables = params["vw"]
        vals_c = vals.to(cd)
        urows, rows, aux, ovf = _rows_for(compact, tables, aux, cd, ids,
                                          config)             # F × [B, k+1]
        if config.gfull_fused:
            xv_fulls = [r * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
            xvs = [x[:, :k] for x in xv_fulls]
        else:
            xvs = [r[:, :k] * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
        s = _seq_sum(xvs)
        sum_sq = _seq_sum([_sum_upcast(x * x, 1) for x in xvs])
        fm_scores = 0.5 * (_sum_upcast(s * s, 1) - sum_sq)
        if spec.use_linear:
            if config.gfull_fused:
                fm_scores = fm_scores + _seq_sum([x[:, k] for x in xv_fulls])
            else:
                fm_scores = fm_scores + _seq_sum(
                    [r[:, k] * vals_c[:, f] for f, r in enumerate(rows)])
        h = torch.cat(xvs, dim=1)                           # [B, F·k]
        kernels, ins, pres, deep = _mlp_forward(spec, params["mlp"], h)
        scores = fm_scores + deep
        if spec.use_bias:
            scores = scores + w0.to(cd)
        loss, dscores = loss_and_grad(scores, labels, weights)
        g_mlp, g_h = _mlp_backward(spec, kernels, ins, pres, dscores)
        lr = lr_at(_step_tensor(step_idx, w0.device))
        touched = weights > 0

        if config.gfull_fused:
            # The pullback widened to [B, F, k+1] by one zero column (the
            # head never reads the linear weight).
            extra = torch.nn.functional.pad(g_h.reshape(-1, F, k), (0, 1))
            g_fulls = _gfull_grads(dscores, vals_c, s, xv_fulls, rows,
                                   touched.to(cd), k, cd, spec.use_linear,
                                   config, extra=extra)
        else:
            g_fulls = []
            for f in range(F):
                x_f = vals_c[:, f:f + 1]
                g_v = (dscores[:, None] * x_f * (s - xvs[f])
                       + g_h[:, f * k:(f + 1) * k] * x_f)
                if config.reg_factors:
                    g_v = g_v + reg_factors * rows[f][:, :k] * touched[:, None]
                if spec.use_linear:
                    g_l = dscores * vals_c[:, f]
                    if config.reg_linear:
                        g_l = g_l + reg_linear * rows[f][:, k] * touched
                else:
                    g_l = torch.zeros_like(dscores)
                g_fulls.append(torch.cat([g_v, g_l[:, None]], dim=1))
        _apply_updates(compact, tables, ids, g_fulls, rows, urows, config,
                       noise_for, step_idx, -lr, aux)

        # The dense side: the optimizer on {"w0", "mlp"} (+ L2 per group).
        g_w0 = _sum_upcast(dscores).float()
        if config.reg_bias:
            g_w0 = g_w0 + reg_bias32 * w0
        if config.reg_factors:
            g_mlp = [{key: g[key] + reg_factors32 * layer[key] for key in g}
                     for g, layer in zip(g_mlp, params["mlp"])]
        dense = dense_subtree(params)
        apply_updates(dense, dense_opt.update({"w0": g_w0, "mlp": g_mlp},
                                              opt_state, dense))
        return params, opt_state, _fold_overflow(loss, ovf, config)

    return body, init_opt_state


def _deepfm_roll(body, params, opt_state, step0, m: int, ids, vals, labels,
                 weights, aux):
    """:func:`_roll` of the FieldDeepFM body, the optimizer's state
    carried through the steps."""
    def one(p, i, *batch):
        p, _, loss = body(p, opt_state, i, *batch)
        return p, loss

    return _roll(one, params, step0, m, ids, vals, labels, weights, aux)


def make_field_deepfm_sparse_step(spec, config: TrainConfig):
    """The fused hybrid step of a FieldDeepFM as the training loop runs it
    (the reference's jitted step, params and optimizer state donated):
    ``step(params, opt_state, step_idx, ids, vals, labels, weights,
    aux=None) → (params, opt_state, loss)``, with
    ``step.init_opt_state(params)``.

    On the card the body is captured as one CUDA graph per input layout
    over the tree ``{"params", "opt"}`` (:class:`~fm_spark_tpu_torch.graphs
    .CapturedStep`): both are updated in place and bound by storage, so
    other params or state tensors capture anew. On the CPU it runs the
    eager body.
    """
    body, init_opt_state = make_field_deepfm_sparse_body(spec, config)

    def run(state, step, *inputs):
        has_aux = len(inputs) > 4
        return body(state["params"], state["opt"], step,
                    *_unflat(inputs, has_aux))[2]

    captured = graphs.CapturedStep(run)

    def step(params, opt_state, step_idx, ids, vals, labels, weights,
             aux=None):
        if not _on_card(params):
            return body(params, opt_state, step_idx, ids, vals, labels,
                        weights, aux)
        if config.host_dedup and aux is None:
            raise ValueError(
                "host_dedup step needs the batch's dedup_aux operand"
            )
        loss = captured({"params": params, "opt": opt_state}, step_idx,
                        *_flat(ids, vals, labels, weights, aux))
        return params, opt_state, loss

    step.captured = captured
    step.init_opt_state = init_opt_state
    return step


def make_field_deepfm_multistep(spec, config: TrainConfig, n: int):
    """The FieldDeepFM form of :func:`make_field_sparse_multistep`:
    ``mstep(params, opt_state, step0, m, ids, vals, labels, weights,
    aux=None) → (params, opt_state, last_loss)`` over ``[n, ...]``-stacked
    batches, the optimizer's state advanced through the ``m`` steps as in
    ``m`` separate calls; ``mstep.init_opt_state`` as the step's. On the
    card each ``m`` is one CUDA graph over ``{"params", "opt"}``."""
    if n < 1:
        raise ValueError(f"steps per call must be >= 1, got {n}")
    body, init_opt_state = make_field_deepfm_sparse_body(spec, config)

    def run(state, step0, *inputs):
        m = inputs[0].shape[0]
        return _deepfm_roll(body, state["params"], state["opt"], step0, m,
                            *_unflat(inputs, len(inputs) > 4))

    captured = graphs.CapturedStep(run)

    def mstep(params, opt_state, step0, m, ids, vals, labels, weights,
              aux=None):
        m = int(m)
        if not 1 <= m <= n:
            raise ValueError(f"m must be in [1, {n}], got {m}")
        if not _on_card(params):
            loss = _deepfm_roll(body, params, opt_state, int(step0), m, ids,
                                vals, labels, weights, aux)
            return params, opt_state, loss
        stacked = _flat(ids, vals, labels, weights, aux)
        loss = captured({"params": params, "opt": opt_state}, step0,
                        *(t[:m] for t in stacked))
        return params, opt_state, loss

    mstep.captured = captured
    mstep.init_opt_state = init_opt_state
    return mstep


def _body_for(spec, config: TrainConfig, sr_noise=None):
    """The FieldFFM body for a :class:`~fm_spark_tpu_torch.models
    .FieldFFMSpec`, else the FieldFM body."""
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec

    return (make_field_ffm_sparse_sgd_body(spec, config, sr_noise=sr_noise)
            if isinstance(spec, FieldFFMSpec)
            else make_field_sparse_sgd_body(spec, config, sr_noise=sr_noise))


def _flat(ids, vals, labels, weights, aux):
    return (ids, vals, labels, weights, *(aux if aux is not None else ()))


def _unflat(inputs, has_aux: bool):
    ids, vals, labels, weights, *aux = inputs
    return ids, vals, labels, weights, (tuple(aux) if has_aux else None)


def _on_card(params) -> bool:
    return params["w0"].device.type == "cuda"


def _roll(body, params, step0, m: int, ids, vals, labels, weights, aux):
    """Steps ``step0 .. step0 + m - 1`` over the first ``m`` stacked
    batches; the last loss, with a −inf (the compact overflow poison)
    kept once seen, as the reference's roll."""
    loss = torch.zeros((), dtype=torch.float32, device=params["w0"].device)
    for j in range(m):
        a = None if aux is None else tuple(x[j] for x in aux)
        params, lj = body(params, step0 + j, ids[j], vals[j], labels[j],
                          weights[j], a)
        loss = torch.where(torch.isneginf(loss), loss, lj)
    return loss


def make_sgd_step(spec, config: TrainConfig):
    """The captured single step of either family:
    :func:`make_field_ffm_sparse_sgd_step` for a
    :class:`~fm_spark_tpu_torch.models.FieldFFMSpec`, else
    :func:`make_field_sparse_sgd_step`."""
    body = _body_for(spec, config)

    def run(params, step, *inputs):
        has_aux = len(inputs) > 4
        return body(params, step, *_unflat(inputs, has_aux))[1]

    captured = graphs.CapturedStep(run)

    def step(params, step_idx, ids, vals, labels, weights, aux=None):
        if not _on_card(params):
            return body(params, step_idx, ids, vals, labels, weights, aux)
        if config.host_dedup and aux is None:
            raise ValueError(
                "host_dedup step needs the batch's dedup_aux operand"
            )
        return params, captured(params, step_idx,
                                *_flat(ids, vals, labels, weights, aux))

    step.captured = captured
    return step


def make_field_sparse_sgd_step(spec, config: TrainConfig):
    """The fused sparse-SGD step of a FieldFM as the training loop runs it
    (the counterpart of the reference's jitted step, params donated):
    ``step(params, step_idx, ids, vals, labels, weights, aux=None) →
    (params, loss)``.

    On the card the body is captured as one CUDA graph per input layout on
    its first call and replayed after (:class:`~fm_spark_tpu_torch.graphs
    .CapturedStep`): the params are updated in place, the graph is bound
    to their storage (other params tensors capture anew), ``step_idx``
    may be an int or a 0-dim int tensor, and ``loss`` is a fresh tensor.
    It takes no ``sr_noise``: the SR bits come from the device's key
    schedule. On the CPU it runs the eager body.
    """
    from fm_spark_tpu_torch.models.field_fm import FieldFMSpec

    if type(spec) is not FieldFMSpec:
        raise ValueError("expected a FieldFMSpec")
    return make_sgd_step(spec, config)


def make_field_ffm_sparse_sgd_step(spec, config: TrainConfig):
    """:func:`make_field_sparse_sgd_step` for a FieldFFM."""
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec

    if type(spec) is not FieldFFMSpec:
        raise ValueError("expected a FieldFFMSpec")
    return make_sgd_step(spec, config)


def make_field_sparse_multistep(spec, config: TrainConfig, n: int,
                                sr_noise=None):
    """``n`` fused steps per call over batches stacked on a leading
    ``[n, ...]`` axis (the counterpart of the reference's ``fori_loop``
    roll): ``mstep(params, step0, m, ids, vals, labels, weights, aux=None)
    → (params, last_loss)`` runs the first ``m`` of them as steps
    ``step0 .. step0+m-1``, through the FieldFFM body for a
    :class:`~fm_spark_tpu_torch.models.FieldFFMSpec` and the FieldFM body
    otherwise. A −inf loss (the compact overflow poison) sticks once seen.

    On the card each ``m`` (the full roll, and the tail of a run whose
    step count ``n`` does not divide) is one CUDA graph of ``m`` steps over
    ``[m, ...]`` buffers, captured at its first call: ``m`` is static here,
    where the reference's is a traced operand. ``sr_noise`` (the SR bits
    of a test) is taken on the CPU only: a host callable cannot be
    captured. On the CPU the steps run eagerly.
    """
    if n < 1:
        raise ValueError(f"steps per call must be >= 1, got {n}")
    body = _body_for(spec, config, sr_noise=sr_noise)

    def run(params, step0, *inputs):
        m = inputs[0].shape[0]
        return _roll(body, params, step0, m,
                     *_unflat(inputs, len(inputs) > 4))

    captured = graphs.CapturedStep(run)

    def mstep(params, step0, m, ids, vals, labels, weights, aux=None):
        m = int(m)
        if not 1 <= m <= n:
            raise ValueError(f"m must be in [1, {n}], got {m}")
        if not _on_card(params):
            loss = _roll(body, params, int(step0), m, ids, vals, labels,
                         weights, aux)
            return params, loss
        if sr_noise is not None:
            raise ValueError("the captured steps draw their SR bits on the "
                             "device; sr_noise is taken on the CPU only")
        stacked = _flat(ids, vals, labels, weights, aux)
        return params, captured(params, step0, *(t[:m] for t in stacked))

    mstep.captured = captured
    return mstep


def make_sparse_sgd_step(spec, config: TrainConfig):
    """The fused sparse-SGD step of the flat FM (the reference's
    ``make_sparse_sgd_step``): ``step(params, step_idx, ids, vals, labels,
    weights, keys=None) → (params, loss)``, updating ``params`` (``{"w0",
    "w", "v"}`` of an ``FMSpec``) in place. ``keys`` (the tiered store's
    global ids of the batch's hot-local ``ids``) orders the dedup's sums,
    so a tiered step adds on the untiered step's bits
    (``ops.scatter._dedup_by``); untiered callers pass none. Plain SGD with the schedule of
    :func:`~fm_spark_tpu_torch.train.make_optimizer`, read from
    ``step_idx`` (an int or a 0-dim int tensor).

    The analytic row rule ``∂ŷ/∂v[i] = x_i·(s − v[i]·x_i)``,
    ``∂ŷ/∂w[i] = x_i``, with LAZY L2: ``reg_factors`` and ``reg_linear``
    decay only the gathered rows of lanes with ``weight > 0``, and
    ``reg_bias`` the bias. The ``[B·nnz, k+1]`` lanes of ``-lr·[g_v |
    g_w]`` (float32) are summed once per distinct id by the device dedup
    (kernel A at cap = B·nnz on the card) and each total is added once to
    its row, in the table's dtype; ids follow JAX's rules (an id in
    ``[-n, 0)`` counts from the end; any other out-of-range id clamps in
    the gather and is dropped from the write). On the card the body is
    captured as one CUDA graph per input layout; on the CPU it runs
    eagerly."""
    from fm_spark_tpu_torch.models.fm import FMSpec
    from fm_spark_tpu_torch.ops import fm as fm_ops

    if type(spec) is not FMSpec:
        raise ValueError("sparse step supports the plain FM family only")
    if config.optimizer != "sgd":
        raise ValueError("sparse step implements plain SGD only")
    _reject_gfull(config, "the flat-table FM step (it has no fused "
                  "g_full concat to eliminate)")
    _reject_collective_dtype(config, "the single-chip flat-table FM step")
    _reject_score_sharded(config, "the single-chip flat-table FM step")
    _reject_sel_blocked(config, "the single-chip flat-table FM step")
    _reject_deep_sharded(config, "the single-chip flat-table FM step")
    _reject_fused_embed_require(config, "the single-chip flat-table FM step")
    _reject_embed_tier_require(config, "the bare flat-table FM step "
                               "(drive it through embed.TieredTrainer)")
    loss_and_grad = _loss_and_grad_fn(spec.loss)
    cd = spec.cdtype
    lr_at = _lr_at_tensor(config)
    reg_factors = fused_bwd_lib.round_to(config.reg_factors, cd)
    reg_linear = fused_bwd_lib.round_to(config.reg_linear, cd)

    @torch.no_grad()
    def body(params, step_idx, ids, vals, labels, weights, keys=None):
        w0, w, v = params["w0"], params["w"], params["v"]
        n, k = v.shape
        gidx = fm_ops.gather_index(ids, n)
        vals_c = vals.to(cd)
        rows = v[gidx].to(cd)                              # [B, nnz, k]
        xv = rows * vals_c[..., None]
        s = _sum_upcast(xv, 1)                             # [B, k]
        sum_sq = _sum_upcast(xv * xv, (1, 2))
        scores = 0.5 * (_sum_upcast(s * s, 1) - sum_sq)
        if spec.use_linear:
            scores = scores + _sum_upcast(w[gidx].to(cd) * vals_c, 1)
        if spec.use_bias:
            scores = scores + w0.to(cd)
        loss, dscores = loss_and_grad(scores, labels, weights)
        g_rows = dscores[:, None, None] * vals_c[..., None] * (
            s[:, None, :] - xv)
        lr = lr_at(_step_tensor(step_idx, v.device))
        touched = weights > 0
        if config.reg_factors:
            g_rows = g_rows + reg_factors * rows * touched[:, None, None]
        if spec.use_linear:
            g_w = dscores[:, None] * vals_c
            if config.reg_linear:
                g_w = g_w + reg_linear * w[gidx].to(cd) * touched[:, None]
        else:
            g_w = torch.zeros_like(vals_c)
        # -lr·g in float32 (JAX promotes the compute dtype to the float32
        # lr), summed per id in float32 and added once in the table's dtype.
        m = ids.numel()
        delta = torch.cat([g_rows.float().reshape(m, k),
                           g_w.float().reshape(m, 1)], dim=1) * -lr
        d = scatter_lib._dedup_by(fm_ops.write_index(ids, n).reshape(-1),
                                  delta, None if keys is None
                                  else keys.reshape(-1))
        slot = torch.arange(delta.shape[0], device=v.device)
        ok = (slot < d.count) & (d.useg < n)    # one write per distinct id
        # The other slots add zeros, spread over the rows (on one row
        # their atomic adds would queue behind each other).
        tgt = torch.where(ok, d.useg.long(), slot % n)
        scatter_lib._add_rows(v, tgt, ok, d.totals[:, :k])
        if spec.use_linear:
            scatter_lib._add_rows(w[:, None], tgt, ok, d.totals[:, k:])
        if spec.use_bias:
            _update_bias(w0, lr, dscores, config)
        return params, loss

    def run(params, step, *batch):
        return body(params, step, *batch)[1]

    captured = graphs.CapturedStep(run)

    def step(params, step_idx, ids, vals, labels, weights, keys=None):
        if not _on_card(params):
            return body(params, step_idx, ids, vals, labels, weights, keys)
        return params, captured(params, step_idx, ids, vals, labels, weights,
                                keys)

    step.captured = captured
    step.body = body
    return step


def precompile_field_sparse_step(spec, config: TrainConfig, batch_size: int,
                                 steps_per_call: int = 1, *, params,
                                 opt_state=None):
    """Capture the fused step (or the ``steps_per_call`` roll) for
    ``params`` ahead of the data: the counterpart of the reference's
    ``lower().compile()`` warm start, dispatching FieldFM, FieldFFM and
    FieldDeepFM as the training loop does. Returns the step (for
    ``steps_per_call = 1``) or the multistep, already captured for full
    calls on the card, over zero batches shaped as
    ``abstract_field_batch`` and, with ``host_dedup``, the aux of zero ids
    (aux shapes depend on ``(B, F, cap)`` only).

    It takes ``params`` (and for a FieldDeepFM the ``opt_state`` of
    ``step.init_opt_state``), where the reference takes none: a graph binds
    the storage of the tensors it was captured on. The warm-up runs on
    clones, so neither is stepped. On the CPU nothing is captured.
    """
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec

    if steps_per_call < 1:
        raise ValueError(f"steps per call must be >= 1, got {steps_per_call}")
    import numpy as np

    deep = isinstance(spec, FieldDeepFMSpec)
    if deep and opt_state is None:
        raise ValueError("a FieldDeepFM step binds its optimizer state: "
                         "pass opt_state=step.init_opt_state(params)")
    dev = params["w0"].device
    b, f = batch_size, spec.num_fields
    zeros = np.zeros((b, f), np.int32)
    aux = None
    if config.host_dedup:
        aux = (scatter_lib.compact_aux(zeros, config.compact_cap)
               if config.compact_cap else scatter_lib.dedup_aux(zeros))
        aux = tuple(torch.from_numpy(a).to(dev) for a in aux)
    batch = _flat(torch.zeros(b, f, dtype=torch.int32, device=dev),
                  torch.zeros(b, f, dtype=torch.float32, device=dev),
                  torch.zeros(b, dtype=torch.float32, device=dev),
                  torch.zeros(b, dtype=torch.float32, device=dev), aux)
    state = {"params": params, "opt": opt_state} if deep else params
    if steps_per_call == 1:
        step = (make_field_deepfm_sparse_step(spec, config) if deep
                else make_sgd_step(spec, config))
    else:
        step = (make_field_deepfm_multistep if deep
                else make_field_sparse_multistep)(spec, config, steps_per_call)
        n = steps_per_call
        batch = [t.unsqueeze(0).expand(n, *t.shape) for t in batch]
    if _on_card(params):
        step.captured(state, 0, *batch)
    return step
