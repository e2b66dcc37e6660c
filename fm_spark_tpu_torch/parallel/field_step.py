"""Field-sharded fused sparse-SGD of FieldFM: the multi-device layout (the
port of ``fm_spark_tpu/parallel/field_step.py`` on ``torch.distributed``).

Each rank owns ``F_pad/n`` fields' tables outright (``F_pad`` is the field
count rounded up to the ``feat`` extent; padding fields carry zero tables
and ``val = 0`` columns, so they add nothing and are written nowhere
real). A step, per rank:

1. ids and vals arrive example-sharded, ``[B/n, F_pad]``; one
   ``all_to_all`` over ``feat`` turns them field-sharded, ``[B,
   F_pad/n]`` in the global example order; labels and weights are
   gathered (a 2-D mesh then gathers all four over ``row``);
2. local gathers of the owned fields' rows (a 2-D mesh masks the lanes
   whose id another row shard owns to zero), then ONE ``all_reduce`` of
   the packed partial sums ``[s | Σ xv² | lin]`` over the score axes
   reconstructs every example's exact score on every rank;
3. every rank computes the same ``dscores`` and writes only its own
   tables: single-owner writes, no reduction of a table gradient.

The tables never move; only ``[B, k + 2]`` activations do. The forms are
the single-card bodies' (``sparse.make_field_sparse_sgd_body``): the
per-lane gather and write of every ``sparse_update``, ``use_pallas``, the
host-built compact aux (1-D mesh only; the aux of the global batch,
each rank given its fields' slices) and the device-built one
(``compact_device``, both meshes; on 2-D each row shard compacts its
ownership-masked ids, the foreign lanes collapsing into one dropped
segment), ``gfull_fused``, ``segtotal_pallas`` (kernel A), and the
sharded knobs: ``score_sharded`` (each rank reduces the score math of
its example block, one ``[B]`` gather of ``dscores``) and
``collective_dtype`` (the activation collective cast to the wire dtype
and back on arrival). At a mesh of one rank the step computes what the
single-card body computes, in its order, so the two agree bit for bit.

A rank's params are ``{"w0": [], "vw": [f_local, bucket/n_row, width]}``
on its device (:func:`shard_field_params`). On the card the step is
captured as a CUDA graph like the single-card steps (its warm-up runs
every collective once, so NCCL has made its communicators before the
capture records them); on the CPU it runs eagerly under gloo.
"""

from __future__ import annotations

import functools
import json
import os
import shutil
import time

import numpy as np
import torch

from fm_spark_tpu_torch import graphs
from fm_spark_tpu_torch.ops import losses as losses_lib
from fm_spark_tpu_torch.ops import scatter as scatter_lib
from fm_spark_tpu_torch.ops.fm import seq_sum as _seq_sum
from fm_spark_tpu_torch.ops.fm import sum_upcast as _sum_upcast
from fm_spark_tpu_torch.train import TrainConfig

# ----------------------------------------------------------------- layout


def padded_num_fields(num_fields: int, n_feat: int) -> int:
    return -(-num_fields // n_feat) * n_feat


def _check_row_layout(spec):
    if not getattr(spec, "fused_linear", True):
        raise ValueError("field-sharded step requires fused_linear=True")
    if getattr(spec, "table_layout", "row") != "row":
        raise ValueError(
            "the field-sharded layout requires table_layout='row' "
            "(transposed tables are a single-chip compact-path option)")


def stack_field_params(spec, params, n_feat: int) -> dict:
    """Per-field tables → ``{"w0", "vw": [F_pad, bucket, width]}`` (zero
    padding tables)."""
    _check_row_layout(spec)
    tables = list(params["vw"])
    pad = padded_num_fields(spec.num_fields, n_feat) - len(tables)
    tables += [torch.zeros_like(tables[0])] * pad
    return {"w0": params["w0"], "vw": torch.stack(tables, dim=0)}


def unstack_field_params(spec, stacked: dict) -> dict:
    """Inverse of :func:`stack_field_params` (drops padding fields)."""
    return {"w0": stacked["w0"],
            "vw": [stacked["vw"][f] for f in range(spec.num_fields)]}


def _geometry(spec, mesh) -> dict:
    """Layout constants and guards shared by the train and eval steps (the
    reference's ``_mesh_geometry``)."""
    if set(mesh.axis_names) not in ({"feat"}, {"feat", "row"}):
        raise ValueError(
            "field-sharded step runs on a ('feat',) or ('feat', 'row') "
            "mesh; see module docstring (use make_field_mesh)")
    n_feat = mesh.shape["feat"]
    n_row = mesh.shape.get("row", 1)
    two_d = n_row > 1
    if two_d and spec.bucket % n_row:
        raise ValueError(f"bucket={spec.bucket} must divide evenly over "
                         f"n_row={n_row} row shards")
    f_pad = padded_num_fields(spec.num_fields, n_feat)
    f_local = f_pad // n_feat
    return dict(n_feat=n_feat, n_row=n_row, two_d=two_d, f_pad=f_pad,
                f_local=f_local, bucket_local=spec.bucket // n_row,
                feat0=mesh.coord("feat") * f_local, row=mesh.coord("row"),
                score_axes=mesh.axis_names)


def _field_offset(g) -> int:
    """The global field of local field 0 for the SR key stream: one stream
    per (global field, row shard), as the reference's."""
    return g["feat0"] + (g["row"] * g["f_pad"] if g["two_d"] else 0)


def shard_field_params(stacked: dict, mesh, spec=None) -> dict:
    """This rank's block of stacked params on its device: its fields
    (and, 2-D, its rows of each)."""
    vw = stacked["vw"]
    n_feat = mesh.shape["feat"]
    n_row = mesh.shape.get("row", 1)
    fl = vw.shape[0] // n_feat
    bl = vw.shape[1] // n_row
    f0, r0 = mesh.coord("feat") * fl, mesh.coord("row") * bl
    dev = mesh.device or vw.device
    return {"w0": stacked["w0"].to(dev, copy=True),
            "vw": vw[f0:f0 + fl, r0:r0 + bl].to(dev, copy=True)
            .contiguous()}


def gather_field_params(spec, local: dict, mesh, root=None):
    """The canonical per-field params (padding dropped) from every rank's
    block: on every rank's device (``root`` None), or in host memory on
    the mesh's rank ``root`` alone (None on the others). The tables move
    one local field at a time, so no card holds more than one field block
    of every rank beyond its own tables until the copies land. A
    FieldDeepFM's replicated head is copied."""
    vw = local["vw"]
    n_feat = mesh.shape["feat"]
    fl, _, width = vw.shape
    tables = [None] * (n_feat * fl)
    for j in range(fl):
        blocks = (mesh.all_gather(vw[j], mesh.axis_names) if root is None
                  else mesh.gather(vw[j], root))       # [n, bl, w]
        if blocks is None:
            continue
        # Mesh order is (feat, row): a field's row shards are adjacent.
        blocks = blocks.reshape(n_feat, -1, width)
        if root is not None:
            blocks = blocks.cpu()  # fmlint: disable=torch-host-sync -- gather for a save or a model dir, not the step loop: one host copy per field block
        for fi in range(n_feat):
            tables[fi * fl + j] = blocks[fi]
    if root is not None and mesh.index != root:
        return None
    copy = ((lambda t: t.clone()) if root is None
            else (lambda t: t.detach().cpu()))
    out = {"w0": copy(local["w0"]), "vw": tables[:spec.num_fields]}
    if "mlp" in local:                     # a FieldDeepFM's replicated head
        out["mlp"] = [{k: copy(v) for k, v in layer.items()}
                      for layer in local["mlp"]]
    return out


def pad_field_batch(batch, num_fields: int, n_feat: int):
    """Zero-pad ``(ids, vals, labels, weights)`` to ``F_pad`` field slots."""
    ids, vals, labels, weights = (np.asarray(a) for a in batch[:4])
    pad = padded_num_fields(num_fields, n_feat) - ids.shape[1]
    if pad:
        ids = np.concatenate([ids, np.zeros((ids.shape[0], pad), ids.dtype)],
                             axis=1)
        vals = np.concatenate(
            [vals, np.zeros((vals.shape[0], pad), vals.dtype)], axis=1)
    return ids, vals, labels, weights


def local_rows(batch, mesh):
    """This rank's rows of a global batch: the example axis shards over
    every mesh axis, rank ``index`` taking block ``index`` (the
    reference's ``field_batch_specs``)."""
    rows = np.asarray(batch[0]).shape[0]
    n = mesh.size
    if rows % n:
        raise ValueError(f"batch of {rows} rows does not divide over the "
                         f"{n} ranks of the mesh")
    lo = mesh.index * (rows // n)
    return tuple(np.asarray(a)[lo:lo + rows // n] for a in batch)


def shard_field_batch(batch, mesh):
    """A GLOBAL (F_pad-padded) batch → this rank's example block on its
    device."""
    return shard_field_batch_local(local_rows(batch, mesh), mesh)


def shard_field_batch_local(batch, mesh):
    """This process's block of the batch (its rows already) on its
    device: the per-process input shard."""
    dev = mesh.device or torch.device("cpu")
    return tuple(torch.as_tensor(np.ascontiguousarray(a)).to(dev)
                 for a in batch)


def stack_compact_aux(aux, n_feat: int):
    """Pad a global-batch ``scatter.compact_aux`` tuple ([F, ...]) to
    ``F_pad`` field slots: a padding field's aux holds one segment of
    every lane, id 0 (it writes only into its zero table)."""
    useg, segstart, segend, order, inv = (np.asarray(a) for a in aux)
    f, cap = useg.shape
    b = order.shape[1]
    pad = padded_num_fields(f, n_feat) - f
    if not pad:
        return useg, segstart, segend, order, inv
    imax = np.iinfo(np.int32).max
    pu = np.zeros((pad, cap), np.int32)
    pu[:, 1:] = (imax - cap) + np.arange(1, cap, dtype=np.int32)
    ps = np.full((pad, cap), max(b - 1, 0), np.int32)
    pe = ps.copy()
    ps[:, 0] = 0
    po = np.broadcast_to(np.arange(b, dtype=np.int32), (pad, b)).copy()
    pi = np.zeros((pad, b), np.int32)
    return tuple(np.concatenate([a, p]) for a, p in
                 zip((useg, segstart, segend, order, inv),
                     (pu, ps, pe, po, pi)))


def shard_compact_aux(aux, mesh, n_feat: int | None = None):
    """This rank's fields of a global-batch compact aux (padded to
    ``F_pad``), on its device."""
    n_feat = n_feat or mesh.shape["feat"]
    stacked = stack_compact_aux(aux, n_feat)
    fl = stacked[0].shape[0] // n_feat
    f0 = mesh.coord("feat") * fl
    dev = mesh.device or torch.device("cpu")
    return tuple(torch.from_numpy(np.ascontiguousarray(a[f0:f0 + fl]))
                 .to(dev) for a in stacked)


# ----------------------------------------------------------------- forward


def _to_fields(mesh, g, x):
    """``[B/n, F_pad]`` example-sharded → ``[B, f_local]`` field-sharded
    (the all_to_all over ``feat``, then on 2-D the gather over ``row``)."""
    bl = x.shape[0]
    y = x.reshape(bl, g["n_feat"], g["f_local"]).permute(1, 0, 2)
    y = mesh.all_to_all(y, "feat").reshape(-1, g["f_local"])
    if g["two_d"]:
        y = mesh.all_gather(y, "row").reshape(-1, g["f_local"])
    return y


def _gather_examples(mesh, g, x):
    """``[B/n]`` → ``[B]``, in the order :func:`_to_fields` gives."""
    y = mesh.all_gather(x, "feat").reshape(-1)
    if g["two_d"]:
        y = mesh.all_gather(y, "row").reshape(-1)
    return y


def _ownership(g, ids):
    """``(loc, own)``: ids local to this row shard's bucket range, and
    which lanes it owns (the single 2-D ownership contract)."""
    loc = ids - g["row"] * g["bucket_local"]
    return loc, (loc >= 0) & (loc < g["bucket_local"])


def _wire(config: TrainConfig):
    """``config.collective_dtype`` as the activation collectives' wire
    dtype (None: no cast)."""
    if config.collective_dtype == "float32":
        return None
    if config.collective_dtype == "bfloat16":
        return torch.bfloat16
    raise ValueError(f"unknown collective_dtype {config.collective_dtype!r} "
                     "(expected 'float32' or 'bfloat16')")


def _table_rows(g, tables, ids, cd, caux, device_cap, use_pallas):
    """The owned fields' rows: ``(rows, urows, uidx, aux, ovf)`` by the
    device-built compact aux, the host's, or the per-lane gather (2-D:
    ownership-masked, foreign lanes written to the sentinel row
    ``bucket_local``, which every write drops)."""
    from fm_spark_tpu_torch.sparse import _compact_gather_all, _gather_all

    own = None
    if g["two_d"] and caux is None:
        loc, own = _ownership(g, ids)
    if device_cap > 0:
        cids, extra = ids, None
        if own is not None:
            cids = torch.where(own, loc, g["bucket_local"])
            extra = (~own).any(dim=0).to(torch.int32)
        aux, nseg = scatter_lib.device_compact_aux(cids, device_cap)
        if extra is not None:
            nseg = nseg - extra
        ovf = (nseg.max() - device_cap).clamp(min=0)
        urows, rows = _compact_gather_all(tables, aux, cd,
                                          mask_overflow=True)
        if own is not None:
            rows = [r * own[:, f, None].to(cd) for f, r in enumerate(rows)]
        return rows, urows, None, aux, ovf
    if caux is not None:
        urows, rows = _compact_gather_all(tables, caux, cd)
        return rows, urows, None, caux, None
    if own is not None:
        gidx = loc.clamp(0, g["bucket_local"] - 1)
        rows = [r * own[:, f, None].to(cd) for f, r in
                enumerate(_gather_all(tables, gidx, cd, use_pallas))]
        uidx = torch.where(own, loc, g["bucket_local"]).to(ids.dtype)
        return rows, None, uidx, None, None
    return _gather_all(tables, ids, cd, use_pallas), None, ids, None, None


class _Fwd:
    """:func:`_field_forward`'s result."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _field_forward(spec, g, mesh, vw, w0, ids, vals, labels, weights,
                   caux=None, device_cap: int = 0, add_bias: bool = True,
                   gfull: bool = False, wire=None,
                   score_shard: bool = False, use_pallas: bool = False):
    """The shared forward of the train and eval steps: the re-shard, the
    owned fields' rows, and ONE all_reduce of the packed partial sums
    ``[s | Σ xv² | lin]`` over the score axes. ``score_shard``: the score
    math of this rank's example block only (``s`` stays whole)."""
    cd = spec.cdtype
    k = spec.rank
    if caux is None:
        # The host aux carries the gather/scatter targets: no ids needed.
        ids = _to_fields(mesh, g, ids)
    vals = _to_fields(mesh, g, vals)
    labels = _gather_examples(mesh, g, labels)
    weights = _gather_examples(mesh, g, weights)
    vals_c = vals.to(cd)
    tables = [vw[f] for f in range(g["f_local"])]
    rows, urows, uidx, aux, ovf = _table_rows(g, tables, ids, cd, caux,
                                              device_cap, use_pallas)
    xv_fulls = None
    if gfull:
        xv_fulls = [r * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
        xvs = [x[:, :k] for x in xv_fulls]
    else:
        xvs = [r[:, :k] * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
    s_p = _seq_sum(xvs)
    sq_p = _seq_sum([_sum_upcast(x * x, 1) for x in xvs])
    if not spec.use_linear:
        lin_p = torch.zeros_like(sq_p)
    elif gfull:
        lin_p = _seq_sum([x[:, k] for x in xv_fulls])
    else:
        lin_p = _seq_sum([r[:, k] * vals_c[:, f] for f, r in enumerate(rows)])
    packed = mesh.all_reduce(
        torch.cat([s_p, sq_p[:, None], lin_p[:, None]], dim=1),
        g["score_axes"], wire=wire)
    s, sq, lin = packed[:, :k], packed[:, k], packed[:, k + 1]
    if score_shard:
        n, idx = mesh.size, mesh.index
        if s.shape[0] % n:
            raise ValueError(
                f"score_sharded requires the global batch ({s.shape[0]}) "
                f"to divide by the mesh size ({n})")
        bs = s.shape[0] // n
        s_red, sq_red, lin_red = (t[idx * bs:(idx + 1) * bs]
                                  for t in (s, sq, lin))
    else:
        s_red, sq_red, lin_red = s, sq, lin
    scores = 0.5 * (_sum_upcast(s_red * s_red, 1) - sq_red)
    if spec.use_linear:
        scores = scores + lin_red
    if spec.use_bias and add_bias:
        scores = scores + w0.to(cd)
    return _Fwd(scores=scores, s=s, xvs=xvs, xv_fulls=xv_fulls, rows=rows,
                vals_c=vals_c, uidx=uidx, urows=urows, labels=labels,
                weights=weights, aux=aux, ovf=ovf, tables=tables, ids=ids)


def _loss_and_grad(per_example_loss, scores, labels, weights, wsum):
    """``(loss, dscores)`` of ``Σ w·loss / wsum`` at ``scores``."""
    sc = scores.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = (per_example_loss(sc, labels) * weights).sum() / wsum
        (dscores,) = torch.autograd.grad(loss, sc)
    return loss.detach(), dscores


def _batch_loss(mesh, g, fwd, per_example_loss, score_shard: bool):
    """The weighted mean loss and the full ``[B]`` dscores: replicated, or
    (``score_shard``) from this rank's block, the loss summed and dscores
    gathered over the score axes."""
    labels, weights = fwd.labels, fwd.weights
    wsum = torch.clamp(weights.sum(), min=1.0)
    if not score_shard:
        return _loss_and_grad(per_example_loss, fwd.scores, labels, weights,
                              wsum)
    bs = labels.shape[0] // mesh.size
    sl = slice(mesh.index * bs, (mesh.index + 1) * bs)
    loss_l, ds_l = _loss_and_grad(per_example_loss, fwd.scores, labels[sl],
                                  weights[sl], wsum)
    loss = mesh.all_reduce(loss_l, g["score_axes"])
    dscores = mesh.all_gather(ds_l, g["score_axes"]).reshape(-1)
    return loss, dscores


def _shifted_noise(noise_for, offset: int):
    return lambda table, step, f, shape: noise_for(table, step, offset + f,
                                                   shape)


def _write(g, fwd, g_fulls, config, noise_for, step_idx, neg_lr,
           compact: bool):
    """Every owned field's write (compact or per lane), SR keyed by the
    global field."""
    from fm_spark_tpu_torch.sparse import _apply_updates

    _apply_updates(compact, fwd.tables, fwd.uidx, g_fulls, fwd.rows,
                   fwd.urows, config, _shifted_noise(noise_for,
                                                     _field_offset(g)),
                   step_idx, neg_lr, fwd.aux)


def _fold_mesh_overflow(mesh, g, loss, ovf, config):
    """The worst overflow anywhere on the mesh folded into the replicated
    loss (policy 'error')."""
    from fm_spark_tpu_torch.sparse import _fold_overflow

    if ovf is None:
        return loss
    return _fold_overflow(loss, mesh.all_reduce(ovf, g["score_axes"],
                                                op="max"), config)


def _check_compact(config: TrainConfig, spec, g, what: str):
    """The compact-path rules of the sharded steps: ``(compact, device_cap,
    host_compact)``."""
    from fm_spark_tpu_torch.sparse import _check_host_dedup, _reject_host_aux

    _check_host_dedup(config, spec.loss)
    compact = config.compact_cap > 0
    device_cap = config.compact_cap if config.compact_device else 0
    host_compact = compact and not config.compact_device
    if host_compact and g["two_d"]:
        raise ValueError(
            f"host-built compact_cap on the sharded {what} step requires a "
            "1-D ('feat',) mesh; use compact_device=True for 2-D (feat, "
            "row) meshes")
    if not compact and config.host_dedup:
        _reject_host_aux(config, f"the field-sharded {what} step "
                         "(non-compact)")
    return compact, device_cap, host_compact


def make_field_sharded_sgd_body(spec, config: TrainConfig, mesh,
                                sr_noise=None):
    """The field-sharded fused step of a FieldFM, run on every rank of
    ``mesh``: ``step(params, step_idx, ids, vals, labels, weights,
    caux=None) → (params, loss)``, this rank's ``params`` block updated in
    place; ``ids``/``vals`` its ``[B/n, F_pad]`` example rows,
    ``labels``/``weights`` ``[B/n]``, ``caux`` (host compact) its fields'
    slices of the global batch's aux. Same semantics as the single-card
    body; ``loss`` is replicated."""
    from fm_spark_tpu_torch.models.field_fm import FieldFMSpec
    from fm_spark_tpu_torch.ops import fused_bwd as fused_bwd_lib
    from fm_spark_tpu_torch.sparse import (_gfull_grads, _noise_fn,
                                           _reject_deep_sharded,
                                           _reject_embed_tier_require,
                                           _reject_fused_embed_require,
                                           _reject_sel_blocked, _step_tensor,
                                           _update_bias)
    from fm_spark_tpu_torch.train import _lr_at_tensor

    if type(spec) is not FieldFMSpec:
        raise ValueError("expected a FieldFMSpec")
    _check_row_layout(spec)
    if config.optimizer != "sgd":
        raise ValueError("sparse step implements plain SGD only")
    if config.sparse_update not in scatter_lib.SPARSE_UPDATE_MODES:
        raise ValueError(f"unknown sparse_update mode {config.sparse_update!r}")
    what = "the field-sharded FM step"
    _reject_deep_sharded(config, what)
    _reject_sel_blocked(config, what)
    _reject_fused_embed_require(config, what)
    _reject_embed_tier_require(config, what)
    wire = _wire(config)
    g = _geometry(spec, mesh)
    compact, device_cap, host_compact = _check_compact(config, spec, g, "FM")
    per_example_loss = losses_lib.loss_fn(spec.loss)
    cd, k = spec.cdtype, spec.rank
    lr_at = _lr_at_tensor(config)
    noise_for = _noise_fn(config, sr_noise)
    reg_factors = fused_bwd_lib.round_to(config.reg_factors, cd)
    reg_linear = fused_bwd_lib.round_to(config.reg_linear, cd)

    @torch.no_grad()
    def step(params, step_idx, ids, vals, labels, weights, caux=None):
        if host_compact and caux is None:
            raise ValueError(
                "compact sharded step needs the batch's compact_aux operand "
                "(this rank's [f_local, ...] slices)")
        w0 = params["w0"]
        fwd = _field_forward(
            spec, g, mesh, params["vw"], w0, ids, vals, labels, weights,
            caux=caux if host_compact else None, device_cap=device_cap,
            gfull=config.gfull_fused, wire=wire,
            score_shard=config.score_sharded, use_pallas=config.use_pallas)
        loss, dscores = _batch_loss(mesh, g, fwd, per_example_loss,
                                    config.score_sharded)
        lr = lr_at(_step_tensor(step_idx, w0.device))
        touched = fwd.weights > 0
        s, xvs, rows, vals_c = fwd.s, fwd.xvs, fwd.rows, fwd.vals_c
        if config.gfull_fused:
            g_fulls = _gfull_grads(dscores, vals_c, s, fwd.xv_fulls, rows,
                                   touched.to(cd), k, cd, spec.use_linear,
                                   config)
        else:
            g_fulls = []
            for f in range(g["f_local"]):
                # s − xv_f is exactly s without f for owned lanes; a
                # foreign lane's garbage is dropped by its write.
                gv = dscores[:, None] * vals_c[:, f:f + 1] * (s - xvs[f])
                if config.reg_factors:
                    gv = gv + reg_factors * rows[f][:, :k] * touched[:, None]
                if spec.use_linear:
                    gl = dscores * vals_c[:, f]
                    if config.reg_linear:
                        gl = gl + reg_linear * rows[f][:, k] * touched
                else:
                    gl = torch.zeros_like(dscores)
                g_fulls.append(torch.cat([gv, gl[:, None]], dim=1))
        _write(g, fwd, g_fulls, config, noise_for, step_idx, -lr, compact)
        if spec.use_bias:
            _update_bias(w0, lr, dscores, config)
        return params, _fold_mesh_overflow(mesh, g, loss, fwd.ovf, config)

    step.host_compact = host_compact
    return step


def _capture(body, carries_opt: bool = False):
    """The captured form of a sharded body (``sparse.make_sgd_step``'s
    pattern): eager on the CPU, one CUDA graph per input layout on the
    card."""
    from fm_spark_tpu_torch.sparse import _flat, _on_card, _unflat

    if carries_opt:
        def run(state, step, *inputs):
            return body(state["params"], state["opt"], step,
                        *_unflat(inputs, len(inputs) > 4))[2]
    else:
        def run(params, step, *inputs):
            return body(params, step, *_unflat(inputs, len(inputs) > 4))[1]
    captured = graphs.CapturedStep(run)

    if carries_opt:
        def step(params, opt_state, step_idx, ids, vals, labels, weights,
                 caux=None):
            if not _on_card(params):
                return body(params, opt_state, step_idx, ids, vals, labels,
                            weights, caux)
            loss = captured({"params": params, "opt": opt_state}, step_idx,
                            *_flat(ids, vals, labels, weights, caux))
            return params, opt_state, loss
    else:
        def step(params, step_idx, ids, vals, labels, weights, caux=None):
            if not _on_card(params):
                return body(params, step_idx, ids, vals, labels, weights,
                            caux)
            return params, captured(params, step_idx,
                                    *_flat(ids, vals, labels, weights, caux))
    step.captured = captured
    step.body = body
    return step


def make_field_sharded_sgd_step(spec, config: TrainConfig, mesh):
    """:func:`make_field_sharded_sgd_body` as the training loop runs it:
    captured on the card (params updated in place, the graph bound to
    their storage), eager on the CPU."""
    return _capture(make_field_sharded_sgd_body(spec, config, mesh))


def _check_sharded_multistep(config: TrainConfig, n: int):
    if n < 1:
        raise ValueError(f"steps per call must be >= 1, got {n}")
    if config.host_dedup or (config.compact_cap > 0
                             and not config.compact_device):
        raise ValueError(
            "the sharded multistep does not take the host-built "
            "dedup/compact aux (per-batch producer chain); use "
            "compact_device=True")


def make_field_sharded_multistep(spec, config: TrainConfig, mesh, n: int):
    """``n`` field-sharded steps per call (FieldFM or FieldFFM) over
    batches stacked on a leading ``[n, ...]`` axis: ``mstep(params, step0,
    m, ids, vals, labels, weights) → (params, last_loss)``, the first
    ``m`` run; a −inf loss sticks. On the card each ``m`` is one CUDA
    graph of ``m`` steps, collectives included."""
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec
    from fm_spark_tpu_torch.sparse import _on_card, _roll

    _check_sharded_multistep(config, n)
    if isinstance(spec, FieldFFMSpec):
        from fm_spark_tpu_torch.parallel.ffm_step import (
            make_field_ffm_sharded_body)

        body = make_field_ffm_sharded_body(spec, config, mesh)
    else:
        body = make_field_sharded_sgd_body(spec, config, mesh)

    def run(params, step0, *inputs):
        return _roll(body, params, step0, inputs[0].shape[0], *inputs, None)

    captured = graphs.CapturedStep(run)

    def mstep(params, step0, m, ids, vals, labels, weights):
        m = int(m)
        if not 1 <= m <= n:
            raise ValueError(f"m must be in [1, {n}], got {m}")
        if not _on_card(params):
            return params, _roll(body, params, int(step0), m, ids, vals,
                                 labels, weights, None)
        return params, captured(params, step0, *(t[:m] for t in
                                                 (ids, vals, labels,
                                                  weights)))

    mstep.captured = captured
    return mstep


# -------------------------------------------------------------------- eval


def make_field_sharded_eval_step(spec, mesh):
    """Metrics accumulation on the field-sharded layout:
    ``estep(params, mstate, ids, vals, labels, weights) → mstate`` (the
    shared forward, then the replicated metrics update)."""
    from fm_spark_tpu_torch.models import predict_from_scores
    from fm_spark_tpu_torch.models.field_fm import FieldFMSpec
    from fm_spark_tpu_torch.utils import metrics as metrics_lib

    if type(spec) is not FieldFMSpec:
        raise ValueError("expected a FieldFMSpec")
    _check_row_layout(spec)
    per_example_loss = losses_lib.loss_fn(spec.loss)
    g = _geometry(spec, mesh)

    @torch.no_grad()
    def estep(params, mstate, ids, vals, labels, weights):
        fwd = _field_forward(spec, g, mesh, params["vw"], params["w0"], ids,
                             vals, labels, weights)
        per = per_example_loss(fwd.scores, fwd.labels)
        return metrics_lib.update_metrics(
            mstate, fwd.scores, fwd.labels, per, fwd.weights,
            predictions=predict_from_scores(spec, fwd.scores))

    return estep


def evaluate_field_sharded(spec, mesh, params, batches, estep=None) -> dict:
    """Stream global host batches through the sharded eval step →
    finalized metrics (every rank iterates the same batches and feeds its
    rows of each)."""
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec
    from fm_spark_tpu_torch.utils import metrics as metrics_lib

    if estep is None:
        if type(spec) is FieldDeepFMSpec:
            from fm_spark_tpu_torch.parallel.deepfm_step import (
                make_field_deepfm_sharded_eval_step as make)
        elif type(spec) is FieldFFMSpec:
            from fm_spark_tpu_torch.parallel.ffm_step import (
                make_field_ffm_sharded_eval_step as make)
        else:
            make = make_field_sharded_eval_step
        estep = make(spec, mesh)
    n_feat = mesh.shape["feat"]
    mstate = metrics_lib.init_metrics(device=params["w0"].device)
    for batch in batches:
        b = pad_field_batch(tuple(batch), spec.num_fields, n_feat)
        mstate = estep(params, mstate, *shard_field_batch(b, mesh))
    return metrics_lib.finalize_metrics(mstate)


# --------------------------------------------------------- the sharded fit


def _family_parts(spec):
    """``(stack, shard, make_step, make_multistep, carries_opt)`` of a
    field family's sharded layout."""
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec

    if isinstance(spec, FieldDeepFMSpec):
        from fm_spark_tpu_torch.parallel import deepfm_step as d

        return (d.stack_field_deepfm_params, d.shard_field_deepfm_params,
                d.make_field_deepfm_sharded_step,
                d.make_field_deepfm_sharded_multistep, True)
    if isinstance(spec, FieldFFMSpec):
        from fm_spark_tpu_torch.parallel.ffm_step import (
            make_field_ffm_sharded_step)

        return (stack_field_params, shard_field_params,
                make_field_ffm_sharded_step, make_field_sharded_multistep,
                False)
    return (stack_field_params, shard_field_params,
            make_field_sharded_sgd_step, make_field_sharded_multistep, False)


class _HostAux:
    """A batch → ``(its padded rows, the host compact aux padded to
    F_pad)``: the host-compact feed of a mesh of one rank."""

    def __init__(self, source, spec, mesh, cap: int):
        self._source, self._spec, self._mesh, self._cap = (source, spec,
                                                           mesh, cap)
        self.aux_ms: list[float] = []

    def next_batch(self):
        b = self._source.next_batch()
        t0 = time.perf_counter()
        aux = scatter_lib.compact_aux(np.asarray(b[0]), self._cap)
        stacked = stack_compact_aux(aux, self._mesh.shape["feat"])
        self.aux_ms.append((time.perf_counter() - t0) * 1e3)
        rows = pad_field_batch(b, self._spec.num_fields,
                               self._mesh.shape["feat"])
        return (*rows, *(np.ascontiguousarray(a) for a in stacked))

    def state(self):
        return self._source.state()

    def restore(self, st):
        self._source.restore(st)


def fit_field_sharded(spec, config: TrainConfig, batches, mesh, *,
                      steps_per_call: int = 1, prefetch: int = 2,
                      logger=None, stats: dict | None = None,
                      checkpointer=None, ckpt_sharded: bool = False,
                      eval_source=None, preemption_guard=None):
    """Train a FieldFM, FieldFFM or FieldDeepFM for ``config.num_steps``
    steps of its field-sharded step on every rank of ``mesh`` (the
    multi-device core of the reference's ``cli._fit_field_sparse``) and
    return this rank's block of the params (:func:`shard_field_params`'
    layout; :func:`gather_field_params` makes the canonical tables where a
    caller needs them).

    ``batches`` (numpy) yields this rank's rows of each global batch
    (``B/n`` of them, the per-process input shard: each rank reads its
    own slice of the data, its cursor in lockstep with the others'). The
    host compact aux (``host_dedup`` with ``compact_cap``) is built from
    the batch on a mesh of one rank. The params start from ``spec.init``
    seeded by ``config.seed`` (the same canonical tables on every rank),
    stacked and sharded. ``checkpointer``: resume from its newest
    verified step and save on its cadence and at the end, in the
    canonical layout (the tables gathered into rank 0's host memory one
    local field at a time; rank 0 writes) or with ``ckpt_sharded`` each
    rank writing the fields it owns (:func:`save_sharded`); rank 0's
    cursor is saved and every rank restores it. ``eval_source`` (global
    batches) is evaluated on the sharded layout
    (:func:`evaluate_field_sharded`). ``logger``: without one, rank 0 logs
    to ``config.metrics_path`` when that is set. The loop is
    ``train.fit_steps``; ``stats`` as ``train.fit_field_sparse``'s."""
    from fm_spark_tpu_torch.data import StackedBatches
    from fm_spark_tpu_torch.data.pipeline import MappedBatches
    from fm_spark_tpu_torch.train import fit_steps
    from fm_spark_tpu_torch.utils.logging import MetricsLogger

    stack, shard, make_step, make_multistep, deep = _family_parts(spec)
    dev = mesh.device or torch.device("cpu")
    n_feat = mesh.shape["feat"]
    host_compact = config.host_dedup and config.compact_cap > 0 and \
        not config.compact_device
    if host_compact and mesh.size > 1:
        raise ValueError("the host-built compact aux is built from the "
                         "whole batch: a mesh of one rank only (use "
                         "compact_device)")
    if logger is None and config.metrics_path:
        logger = MetricsLogger(path=config.metrics_path if mesh.index == 0
                               else None, n_chips=mesh.size)
    multi = steps_per_call > 1
    step = (make_multistep(spec, config, mesh, steps_per_call) if multi
            else make_step(spec, config, mesh))
    canonical = spec.init(torch.Generator(device=dev).manual_seed(
        config.seed), device=dev)
    opt_state = step.init_opt_state(
        {"w0": canonical["w0"], "mlp": canonical["mlp"]}) if deep else {}
    start, resumed = 0, None
    if checkpointer is not None:
        start, resumed = _resume_sharded(checkpointer, spec, canonical,
                                         opt_state, batches, mesh,
                                         ckpt_sharded)
    params = shard(stack(spec, canonical, n_feat), mesh, spec)
    del canonical
    if host_compact:
        src = aux_src = _HostAux(batches, spec, mesh, config.compact_cap)
    else:
        aux_src = None
        src = MappedBatches(batches, lambda b: pad_field_batch(
            b, spec.num_fields, n_feat))
    if multi:
        src = StackedBatches(src, steps_per_call,
                             total=config.num_steps - start)

    def run(i, m, batch):
        args = (i, m, *batch) if multi else (i, *batch)
        if deep:
            return {"loss": step(params, opt_state, *args)[2]}
        return {"loss": step(params, *args)[1]}

    def save(at, pipeline, force=False):
        opt = _opt_host(opt_state) if deep else None
        if ckpt_sharded:
            save_sharded(checkpointer, at, spec, params, mesh, pipeline,
                         opt_state=opt, force=force)
            return
        canon = gather_field_params(spec, params, mesh, root=0)
        if canon is not None:                  # rank 0 writes
            checkpointer.save(at, canon, pipeline, force=force,
                              opt_state=opt)
            checkpointer.wait()
        mesh.barrier()

    out = fit_steps(config, src, run, device=dev, start=start,
                    steps_per_call=steps_per_call, prefetch=prefetch,
                    logger=logger, rows_scale=mesh.size, evaluate=(
                        None if eval_source is None else
                        lambda: evaluate_field_sharded(spec, mesh, params,
                                                       eval_source())),
                    checkpointer=checkpointer, save=save,
                    preemption_guard=preemption_guard)
    if stats is not None:
        stats.update(out, aux_ms=list(aux_src.aux_ms) if aux_src else [],
                     capture_s=list(step.captured.capture_s), start=start,
                     resumed=resumed, opt_state=opt_state,
                     saves=list(checkpointer.timings) if checkpointer
                     else [])
    return params


def _opt_host(opt_state):
    from fm_spark_tpu_torch.train import _tree_map

    return _tree_map(lambda t: t.detach(), opt_state)


# ------------------------------------------------------------- checkpoints

#: The layout a ``--ckpt-sharded`` step records (``state.json``).
SHARDED_LAYOUT = "sharded"


def save_sharded(checkpointer, step: int, spec, params, mesh,
                 pipeline_state=None, *, opt_state=None,
                 force: bool = False) -> None:
    """Save a sharded run's step on every rank (a collective call): each
    rank writes the fields it owns (2-D: its rows of each) into the
    step's staging directory under their canonical keys (``vw/<field>``,
    a row shard as ``vw/<field>@<row>``), the commit follows the
    reference's: after a barrier rank 0 checks every rank's files against
    the crc32s they gathered, then writes ``state.json`` (layout
    ``sharded``, the mesh's shape), renames the step into place, and
    publishes its manifest and ``last_good``; a final collective orders
    every rank after the commit. Every file and the publish go through
    the durable seam (``durable.write_staged``, ``durable.publish_dir``,
    path class ``ckpt``) under the chain's write policy
    (``Checkpointer._with_io_policy``); a write that still fails on any
    rank removes the staging dir and raises ``CheckpointIOError`` on
    every rank. A sharded step reads back as canonical per-field tables
    (``Checkpointer.restore`` joins the row shards), so ``eval``,
    ``predict`` and ``serve --checkpoint-dir`` take it."""
    _commit_sharded(checkpointer, step, spec, params, mesh, pipeline_state,
                    opt_state, force)


def _owned_arrays(spec, params, mesh, opt_state):
    """``{canonical key: host tensor}`` of the fields this rank owns (and
    rank 0 the replicated ``w0``, MLP and optimizer state)."""
    from fm_spark_tpu_torch.models.io import flatten

    g = {"n_feat": mesh.shape["feat"], "n_row": mesh.shape.get("row", 1)}
    vw = params["vw"]
    f0 = mesh.coord("feat") * vw.shape[0]
    out = {}
    for f in range(vw.shape[0]):
        if f0 + f >= spec.num_fields:
            continue                       # padding fields are not saved
        key = f"vw/{f0 + f}"
        if g["n_row"] > 1:
            key += f"@{mesh.coord('row')}"
        out[key] = vw[f].detach().cpu()  # fmlint: disable=torch-host-sync -- checkpoint path, not the step loop: each owned shard is copied to the host once per save
    if mesh.index == 0:
        out["w0"] = params["w0"].detach().cpu()
        for k, v in flatten(params.get("mlp") or []).items():
            out[f"mlp/{k}"] = v.detach().cpu()  # fmlint: disable=torch-host-sync -- checkpoint path, not the step loop: each owned shard is copied to the host once per save
        for k, v in flatten(opt_state or {}).items():
            out[f"opt/{k}"] = v.detach().cpu()  # fmlint: disable=torch-host-sync -- checkpoint path, not the step loop: each owned shard is copied to the host once per save
    return out


def _commit_sharded(checkpointer, step, spec, params, mesh, pipeline_state,
                    opt_state, force):
    from fm_spark_tpu_torch import checkpoint as ck
    from fm_spark_tpu_torch.utils import durable

    step = int(step)
    final = checkpointer._step_dir(step)
    tmp = f"{final}.tmp-sharded"
    skip = torch.zeros((), dtype=torch.int32)
    if mesh.index == 0:
        checkpointer.wait()
        live = checkpointer.all_steps()
        if os.path.isdir(final) or (not force and live and step < live[-1]):
            skip.fill_(1)
        else:
            os.makedirs(tmp, exist_ok=True)
    skip = mesh.all_reduce(skip.to(mesh.device or "cpu"), mesh.axis_names,
                           op="max")
    if int(skip):
        return
    mesh.barrier()                       # tmp exists before anyone writes
    t0 = time.perf_counter()
    mine, err = {}, None
    try:
        for key, t in _owned_arrays(spec, params, mesh, opt_state).items():
            dtype = ck._dtype_name(t.dtype)
            arr = (t.view(torch.int16).numpy().view(np.uint16)  # fmlint: disable=torch-host-sync -- checkpoint path: the shard is already on the host (_owned_arrays copied it), .numpy() is a view
                   if t.dtype == torch.bfloat16 else t.numpy())  # fmlint: disable=torch-host-sync -- checkpoint path: the shard is already on the host (_owned_arrays copied it), .numpy() is a view
            path = os.path.join(tmp, key + ".npy")
            checkpointer._with_io_policy(
                final, functools.partial(durable.write_staged, path,
                                         ck._npy_writer(arr),
                                         path_class="ckpt"))
            mine[key] = {"file": key + ".npy", "dtype": dtype,
                         "shape": list(arr.shape),
                         "crc": ck._checksum(dtype, arr)}
    except ck.CheckpointIOError as e:
        err = e
    _agree(mesh, final, tmp, err)         # every rank's files, or none
    everyone = _gather_objects(mesh, mine)
    mesh.barrier()
    if mesh.index == 0:
        try:
            _publish_sharded(checkpointer, step, final, tmp, everyone,
                             mesh, pipeline_state, force, t0)
        except ck.CheckpointIOError as e:
            err = e
    _agree(mesh, final, tmp, err)         # every rank after the commit


def _agree(mesh, final, tmp, err) -> None:
    """A collective check: when any rank's write failed (``err`` on it),
    rank 0 removes the staging dir and every rank raises
    :class:`~fm_spark_tpu_torch.checkpoint.CheckpointIOError` (its own,
    or one naming a peer's failure), so no rank waits on a save that
    cannot commit."""
    from fm_spark_tpu_torch import checkpoint as ck

    bad = torch.tensor(int(err is not None), dtype=torch.int32)
    bad = mesh.all_reduce(bad.to(mesh.device or "cpu"), mesh.axis_names,
                          op="max")
    if not int(bad):
        return
    if mesh.index == 0:
        shutil.rmtree(tmp, ignore_errors=True)
    mesh.barrier()
    raise err or ck.CheckpointIOError(
        final, OSError("a peer rank's checkpoint write failed"))


def _publish_sharded(checkpointer, step, final, tmp, everyone, mesh,
                     pipeline_state, force, t0) -> None:
    """Rank 0's commit of a sharded step: check each rank's files against
    the crc32s it gathered, publish the staging dir with ``state.json``
    through the durable seam under the chain's write policy, then the
    manifest and ``last_good``."""
    from fm_spark_tpu_torch import checkpoint as ck
    from fm_spark_tpu_torch.utils import durable

    arrays, checksums = {}, {}
    for part in everyone:
        for key, info in part.items():
            # The commit checks each rank's bytes as they landed.
            arr = np.load(os.path.join(tmp, info["file"]),
                          allow_pickle=False)
            if ck._checksum(info["dtype"], arr) != info["crc"]:
                raise ck.CheckpointIOError(
                    final, OSError(f"shard {key} does not match the crc "
                                   "its rank computed"))
            checksums[key] = info["crc"]
            arrays[key] = {k: info[k] for k in ("file", "dtype", "shape")}
    meta = {"pipeline": pipeline_state, "extra": None}
    layout = {"feat": mesh.shape["feat"], "row": mesh.shape.get("row", 1)}
    state = json.dumps({"step": step, "layout": SHARDED_LAYOUT,
                        "mesh": layout, "arrays": arrays, **meta}).encode()
    checkpointer._with_io_policy(final, functools.partial(
        durable.publish_dir, final, [("state.json", lambda f: f.write(state))],
        path_class="ckpt", staging=tmp))
    manifest = {"step": step, "checksums": checksums,
                "meta_crc": ck._meta_crc(meta), "ts": round(time.time(), 3)}
    os.makedirs(checkpointer._manifest_dir, exist_ok=True)
    checkpointer._durable_json(checkpointer._manifest_path(step), manifest)
    prev = checkpointer.last_good_step()
    if prev is None or step > prev:
        checkpointer._durable_json(
            checkpointer._last_good_path,
            {"step": step, "ts": round(time.time(), 3)})
    checkpointer.timings.append(
        {"step": step, "write_ms": (time.perf_counter() - t0) * 1e3,
         "bytes": int(sum(np.prod(a["shape"]) for a in arrays.values())),
         "forced": bool(force), "sharded": True})
    checkpointer._emit("checkpoint_verified", step=step,
                       last_good=max(step, prev or step))
    checkpointer._collect()


def _gather_objects(mesh, obj) -> list:
    """Every rank's small JSON object, in mesh order."""
    import torch.distributed as dist

    if not mesh._groups:
        return [obj]
    out = [None] * mesh.size
    group, _ = mesh.group(mesh.axis_names)
    dist.all_gather_object(out, obj, group=group)
    return out


def _resume_sharded(checkpointer, spec, canonical, opt_state, batches, mesh,
                    ckpt_sharded: bool):
    """Restore the newest verified step into the canonical params (in
    place) and the cursor into ``batches``; a ``--ckpt-sharded`` run
    resumes only a sharded step saved on the same mesh, and a canonical
    run only a canonical step (the reference's rule, with its hints).
    Returns ``(start, info)``."""
    from fm_spark_tpu_torch.checkpoint import copy_into

    t0 = time.perf_counter()
    restored = checkpointer.restore(canonical)
    if restored is None:
        return 0, None
    layout = restored["layout"]
    want = SHARDED_LAYOUT if ckpt_sharded else "canonical"
    if layout != want:
        hint = ("add --ckpt-sharded to resume it (or point --checkpoint-dir "
                "at a fresh directory)" if want == "canonical" else
                "drop --ckpt-sharded to resume it (or point "
                "--checkpoint-dir at a fresh directory)")
        raise SystemExit(f"could not restore the checkpoint as {want}-layout "
                         f"— the directory holds {layout}-layout steps "
                         f"(then: {hint})")
    if ckpt_sharded:
        saved = restored.get("mesh")
        here = {"feat": mesh.shape["feat"], "row": mesh.shape.get("row", 1)}
        if saved != here:
            raise SystemExit(
                f"a sharded checkpoint resumes only onto the mesh it was "
                f"saved on: saved {saved}, this run {here} (drop "
                "--ckpt-sharded and restart from a canonical checkpoint, or "
                "run on the saved mesh)")
    copy_into(canonical, restored["params"])
    if opt_state:
        copy_into(opt_state, restored["opt_state"])
    if restored["pipeline"] is not None:
        batches.restore(restored["pipeline"])
    return restored["step"], {
        "step": restored["step"], "pipeline": restored["pipeline"],
        "restore_ms": (time.perf_counter() - t0) * 1e3,
        **(checkpointer.restore_timing or {})}



def precompile_field_sharded_step(spec, config: TrainConfig, mesh,
                                  batch_size: int, steps_per_call: int = 1,
                                  *, params, opt_state=None):
    """Capture the field-sharded step (FieldFM, FieldFFM, FieldDeepFM) or
    its ``steps_per_call`` roll for this rank's ``params`` ahead of the
    data (the reference's ``lower().compile()`` warm start), over zero
    batches of this rank's ``[B/n, F_pad]`` rows. Every rank calls it: the
    warm-up runs the collectives, so NCCL makes its communicators before
    the capture. Returns the step; on the CPU nothing is captured. The
    host-built aux is refused (it ships with each batch)."""
    if steps_per_call < 1:
        raise ValueError(f"steps per call must be >= 1, got {steps_per_call}")
    if config.host_dedup:
        raise ValueError(
            "the AOT entry cannot precompile a host-built aux step (the aux "
            "ships with each batch); use compact_device=True")
    if batch_size % mesh.size:
        raise ValueError(f"batch_size={batch_size} must divide by the mesh "
                         f"size ({mesh.size})")
    *_, make_step, make_multistep, deep = _family_parts(spec)
    if deep and opt_state is None:
        raise ValueError("a FieldDeepFM step binds its optimizer state: "
                         "pass opt_state=step.init_opt_state(params)")
    multi = steps_per_call > 1
    step = (make_multistep(spec, config, mesh, steps_per_call) if multi
            else make_step(spec, config, mesh))
    dev = params["w0"].device
    b = batch_size // mesh.size
    f_pad = padded_num_fields(spec.num_fields, mesh.shape["feat"])
    batch = [torch.zeros(b, f_pad, dtype=torch.int32, device=dev),
             torch.zeros(b, f_pad, device=dev), torch.zeros(b, device=dev),
             torch.zeros(b, device=dev)]
    if multi:
        batch = [t.unsqueeze(0).expand(steps_per_call, *t.shape)
                 for t in batch]
    if dev.type == "cuda":
        state = {"params": params, "opt": opt_state} if deep else params
        step.captured(state, 0, *batch)
    return step
