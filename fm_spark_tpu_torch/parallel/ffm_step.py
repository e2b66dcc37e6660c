"""Field-sharded FieldFFM: the sel-transpose forward, the step and eval
(the port of ``fm_spark_tpu/parallel/ffm_step.py``).

The rank owning field ``i`` holds ``sel[b, i, j] = v[id_i][j]·x_i`` for
every target ``j`` (the packed ``[B, F·k + 1]`` row carries them all); the
pairwise term needs the transposed blocks ``sel[b, j, i]``. ONE
``all_to_all`` of the sel activations over ``feat`` (the target axis split,
the owner axis joined) delivers exactly those: activations move, tables
never do. On a 2-D ``(feat, row)`` mesh each row shard gathers zero rows
for the lanes another shard owns, so ONE ``all_reduce`` of the sel block
over ``row`` completes it before the exchange (sel is linear in the
rows). Writes stay single-owner (the sentinel row or the ownership-masked
device aux, as the FM step's). ``collective_dtype`` casts the sel
exchange and the score sums to the wire dtype and back.

The step computes the single-card sel form's scores and gradients from
other partial sums, so it agrees with it within float32 rounding, not
bit for bit; the rejects are the reference's, with its messages.
"""

from __future__ import annotations

import torch

from fm_spark_tpu_torch.ops import losses as losses_lib
from fm_spark_tpu_torch.ops.fm import seq_sum as _seq_sum
from fm_spark_tpu_torch.ops.fm import sum_upcast as _sum_upcast
from fm_spark_tpu_torch.parallel import field_step as _fs
from fm_spark_tpu_torch.train import TrainConfig


def _ffm_field_forward(spec, g, mesh, vw, w0, ids, vals, labels, weights,
                       caux=None, device_cap: int = 0, wire=None):
    """The shared forward of the FFM train and eval steps (see the module's
    docstring): ``(scores, fwd, sel_loc, selT)``, ``fwd`` carrying the
    rows and write targets as :func:`field_step._field_forward`'s does;
    ``sel_loc``/``selT`` this rank's ``[B, f_local, F_pad, k]`` owner and
    transposed blocks."""
    cd, k, nf = spec.cdtype, spec.rank, spec.num_fields
    fl, f_pad = g["f_local"], g["f_pad"]
    if caux is None:
        ids = _fs._to_fields(mesh, g, ids)
    vals = _fs._to_fields(mesh, g, vals)
    labels = _fs._gather_examples(mesh, g, labels)
    weights = _fs._gather_examples(mesh, g, weights)
    vals_c = vals.to(cd)
    tables = [vw[f] for f in range(fl)]
    rows, urows, uidx, aux, ovf = _fs._table_rows(g, tables, ids, cd, caux,
                                                  device_cap, False)
    b = vals.shape[0]
    sel_loc = torch.stack([
        torch.nn.functional.pad(
            r[:, :nf * k].reshape(b, nf, k) * vals_c[:, p, None, None],
            (0, 0, 0, f_pad - nf))
        for p, r in enumerate(rows)], dim=1)             # [B, fl, F_pad, k]
    if g["two_d"]:
        sel_loc = mesh.all_reduce(sel_loc, "row", wire=wire)
    n = g["n_feat"]
    x = sel_loc.to(wire) if wire is not None else sel_loc
    x = x.reshape(b, fl, n, fl, k).permute(2, 0, 1, 3, 4)
    x = mesh.all_to_all(x, "feat")                       # [n, B, fl, fl, k]
    selT = (x.permute(1, 0, 2, 3, 4).reshape(b, f_pad, fl, k)
            .transpose(1, 2).to(cd))                     # [B, fl, F_pad, k]
    pair_p = _sum_upcast(sel_loc * selT, (1, 2, 3))
    diag_p = _seq_sum([_sum_upcast(sel_loc[:, p, g["feat0"] + p, :] ** 2, -1)
                       for p in range(fl)])
    scores = 0.5 * mesh.all_reduce(pair_p - diag_p, "feat", wire=wire)
    if spec.use_linear:
        lin_p = _seq_sum([r[:, nf * k] * vals_c[:, p]
                          for p, r in enumerate(rows)])
        scores = scores + mesh.all_reduce(lin_p, g["score_axes"], wire=wire)
    if spec.use_bias:
        scores = scores + w0.to(cd)
    fwd = _fs._Fwd(rows=rows, urows=urows, uidx=uidx, aux=aux, ovf=ovf,
                   vals_c=vals_c, labels=labels, weights=weights,
                   tables=tables, scores=scores)
    return fwd, sel_loc, selT


def _check(spec, config: TrainConfig, mesh):
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec
    from fm_spark_tpu_torch.sparse import (_reject_deep_sharded,
                                           _reject_embed_tier_require,
                                           _reject_fused_embed_require,
                                           _reject_gfull,
                                           _reject_score_sharded,
                                           _reject_sel_blocked)

    if type(spec) is not FieldFFMSpec:
        raise ValueError("expected a FieldFFMSpec")
    if config.optimizer != "sgd":
        raise ValueError("sparse step implements plain SGD only")
    _reject_gfull(config, "the field-sharded FFM step")
    _reject_sel_blocked(config, "the field-sharded FFM step (single-chip "
                        "body lever; the sharded sel exchange has its own "
                        "blocking)")
    _reject_score_sharded(config, "the field-sharded FFM step")
    _reject_deep_sharded(config, "the field-sharded FFM step")
    _reject_fused_embed_require(config, "the field-sharded FFM step")
    _reject_embed_tier_require(config, "the field-sharded FFM step")
    if set(mesh.axis_names) not in ({"feat"}, {"feat", "row"}):
        raise ValueError(
            "field-sharded FFM runs on a ('feat',) or ('feat', 'row') "
            "mesh (use make_field_mesh)")
    if config.use_pallas:
        raise ValueError("use_pallas is a single-chip experiment")


def make_field_ffm_sharded_body(spec, config: TrainConfig, mesh,
                                sr_noise=None):
    """The field-sharded fused FFM step, with the signature and in-place
    contract of ``field_step.make_field_sharded_sgd_body``."""
    from fm_spark_tpu_torch.ops import fused_bwd as fused_bwd_lib
    from fm_spark_tpu_torch.sparse import _noise_fn, _step_tensor, _update_bias
    from fm_spark_tpu_torch.train import _lr_at_tensor

    _check(spec, config, mesh)
    wire = _fs._wire(config)
    g = _fs._geometry(spec, mesh)
    compact, device_cap, host_compact = _fs._check_compact(config, spec, g,
                                                           "FFM")
    per_example_loss = losses_lib.loss_fn(spec.loss)
    cd, k, nf = spec.cdtype, spec.rank, spec.num_fields
    fl = g["f_local"]
    lr_at = _lr_at_tensor(config)
    noise_for = _noise_fn(config, sr_noise)
    reg_factors = fused_bwd_lib.round_to(config.reg_factors, cd)
    reg_linear = fused_bwd_lib.round_to(config.reg_linear, cd)

    @torch.no_grad()
    def step(params, step_idx, ids, vals, labels, weights, caux=None):
        if host_compact and caux is None:
            raise ValueError(
                "compact sharded FFM step needs the batch's compact_aux "
                "operand (this rank's [f_local, ...] slices)")
        w0 = params["w0"]
        fwd, _, selT = _ffm_field_forward(
            spec, g, mesh, params["vw"], w0, ids, vals, labels, weights,
            caux=caux if host_compact else None, device_cap=device_cap,
            wire=wire)
        loss, dscores = _fs._batch_loss(mesh, g, fwd, per_example_loss,
                                        False)
        lr = lr_at(_step_tensor(step_idx, w0.device))
        touched = fwd.weights > 0
        # ∂L/∂sel[b, i_p, j] = ds·sel[b, j, i_p] (the diagonal zeroed),
        # then ∂L/∂v[id_p, j] = that · x_p: all local.
        dsel = dscores.to(cd)[:, None, None, None] * selT
        cols = torch.arange(g["f_pad"], device=dsel.device)
        mine = g["feat0"] + torch.arange(fl, device=dsel.device)
        own = (cols[None, :] == mine[:, None]).to(cd)      # [fl, F_pad]
        dsel = dsel * (1.0 - own)[None, :, :, None]
        vals_c, rows = fwd.vals_c, fwd.rows
        g_fulls = []
        for p in range(fl):
            gv = (dsel[:, p, :nf, :] * vals_c[:, p, None, None]).reshape(
                -1, nf * k)
            if config.reg_factors:
                gv = gv + reg_factors * rows[p][:, :nf * k] * touched[:, None]
            if spec.use_linear:
                gl = dscores * vals_c[:, p]
                if config.reg_linear:
                    gl = gl + reg_linear * rows[p][:, nf * k] * touched
            else:
                gl = torch.zeros_like(dscores)
            g_fulls.append(torch.cat([gv, gl[:, None].to(gv.dtype)], dim=1))
        _fs._write(g, fwd, g_fulls, config, noise_for, step_idx, -lr,
                   compact)
        if spec.use_bias:
            _update_bias(w0, lr, dscores, config)
        return params, _fs._fold_mesh_overflow(mesh, g, loss, fwd.ovf,
                                               config)

    step.host_compact = host_compact
    return step


def make_field_ffm_sharded_step(spec, config: TrainConfig, mesh):
    """:func:`make_field_ffm_sharded_body` captured on the card, eager on
    the CPU."""
    return _fs._capture(make_field_ffm_sharded_body(spec, config, mesh))


def make_field_ffm_sharded_eval_step(spec, mesh):
    """Metrics accumulation on the field-sharded FFM layout."""
    from fm_spark_tpu_torch.models import predict_from_scores
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec
    from fm_spark_tpu_torch.utils import metrics as metrics_lib

    if type(spec) is not FieldFFMSpec:
        raise ValueError("expected a FieldFFMSpec")
    if set(mesh.axis_names) not in ({"feat"}, {"feat", "row"}):
        raise ValueError(
            "sharded FFM eval runs on a ('feat',) or ('feat', 'row') mesh")
    per_example_loss = losses_lib.loss_fn(spec.loss)
    g = _fs._geometry(spec, mesh)

    @torch.no_grad()
    def estep(params, mstate, ids, vals, labels, weights):
        fwd, _, _ = _ffm_field_forward(spec, g, mesh, params["vw"],
                                       params["w0"], ids, vals, labels,
                                       weights)
        per = per_example_loss(fwd.scores, fwd.labels)
        return metrics_lib.update_metrics(
            mstate, fwd.scores, fwd.labels, per, fwd.weights,
            predictions=predict_from_scores(spec, fwd.scores))

    return estep
