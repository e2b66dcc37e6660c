"""Field-sharded FieldDeepFM: the params layout, the hybrid step, its roll
and eval (the port of ``fm_spark_tpu/parallel/deepfm_step.py``).

The tables are single-owner per field exactly as in the FM step (the same
shared forward, so 2-D ownership masking and the device-built compact aux
compose unchanged); the head needs ``h = concat(xv)``:

- replicated head (default): one gather of the local xv columns over
  ``feat`` (2-D: first one ``all_reduce`` over ``row`` completes each
  row shard's masked columns), the MLP on all ``B`` examples on every
  rank, so its gradient is replicated by construction;
- ``deep_sharded``: one ``all_to_all`` turns the field-sharded ``h``
  columns into example-sharded full rows (``[B/n, F_pad·k]``), the MLP
  runs on ``B/n`` examples, a ``[B]`` gather replicates the deep scores,
  the pullback returns by the reverse ``all_to_all`` into each owner's
  columns, and the MLP's gradient is completed by one ``all_reduce`` over
  ``feat``.

``w0`` and the MLP take the dense optimizer (``config.optimizer``, Adam
for config 5) on every rank, with state kept as the single-card step
keeps it. ``collective_dtype`` casts the ``h`` collectives to the wire
dtype.
"""

from __future__ import annotations

import torch

from fm_spark_tpu_torch import graphs
from fm_spark_tpu_torch.ops import losses as losses_lib
from fm_spark_tpu_torch.parallel import field_step as _fs
from fm_spark_tpu_torch.train import TrainConfig


def stack_field_deepfm_params(spec, params, n_feat: int) -> dict:
    """Per-field list → the stacked layout, keeping the dense head."""
    stacked = _fs.stack_field_params(spec, {"w0": params["w0"],
                                            "vw": params["vw"]}, n_feat)
    stacked["mlp"] = params["mlp"]
    return stacked


def unstack_field_deepfm_params(spec, stacked: dict) -> dict:
    out = _fs.unstack_field_params(spec, stacked)
    out["mlp"] = stacked["mlp"]
    return out


def shard_field_deepfm_params(stacked: dict, mesh, spec=None) -> dict:
    """This rank's tables (as ``field_step.shard_field_params``) and its
    copy of the replicated head."""
    out = _fs.shard_field_params(stacked, mesh)
    dev = out["w0"].device
    out["mlp"] = [{k: v.to(dev, copy=True) for k, v in layer.items()}
                  for layer in stacked["mlp"]]
    return out


def gather_field_deepfm_params(spec, local: dict, mesh, root=None):
    """``field_step.gather_field_params``, which copies the head too."""
    return _fs.gather_field_params(spec, local, mesh, root)


def _flat_grads(tree):
    return torch.cat([g[k].reshape(-1) for g in tree for k in sorted(g)])


def _unflat_grads(vec, like):
    out, i = [], 0
    for g in like:
        layer = {}
        for k in sorted(g):
            n = g[k].numel()
            layer[k] = vec[i:i + n].view_as(g[k])
            i += n
        out.append(layer)
    return out


def make_field_deepfm_sharded_body(spec, config: TrainConfig, mesh):
    """``(body, init_opt_state)``: ``body(params, opt_state, step_idx, ids,
    vals, labels, weights, caux=None) → (params, opt_state, loss)``, this
    rank's tables, head and optimizer state updated in place; the host aux
    is refused (the device-built one composes)."""
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
    from fm_spark_tpu_torch.ops import fused_bwd as fused_bwd_lib
    from fm_spark_tpu_torch.sparse import (_gfull_grads, _mlp_backward,
                                           _mlp_forward, _noise_fn,
                                           _reject_embed_tier_require,
                                           _reject_fused_embed_require,
                                           _reject_host_aux,
                                           _reject_score_sharded,
                                           _reject_sel_blocked, _step_tensor)
    from fm_spark_tpu_torch.ops.fm import sum_upcast
    from fm_spark_tpu_torch.train import (_lr_at_tensor, apply_updates,
                                          make_optimizer)

    if type(spec) is not FieldDeepFMSpec:
        raise ValueError("expected a FieldDeepFMSpec")
    what = "the field-sharded DeepFM step"
    _reject_score_sharded(config, what)
    _reject_sel_blocked(config, what)
    _reject_fused_embed_require(config, what)
    _reject_embed_tier_require(config, what)
    g = _fs._geometry(spec, mesh)
    from fm_spark_tpu_torch.sparse import _check_host_dedup

    _check_host_dedup(config, spec.loss)
    if config.host_dedup:
        _reject_host_aux(config, what)
    device_cap = config.compact_cap if config.compact_device else 0
    wire = _fs._wire(config)
    per_example_loss = losses_lib.loss_fn(spec.loss)
    cd, k, nf = spec.cdtype, spec.rank, spec.num_fields
    fl, f_pad, n = g["f_local"], g["f_pad"], g["n_feat"]
    lr_at = _lr_at_tensor(config)
    noise_for = _noise_fn(config, None)
    dense_opt = make_optimizer(config)
    reg_factors = fused_bwd_lib.round_to(config.reg_factors, cd)
    reg_linear = fused_bwd_lib.round_to(config.reg_linear, cd)
    reg_bias32 = fused_bwd_lib.round_to(config.reg_bias, torch.float32)
    reg_factors32 = fused_bwd_lib.round_to(config.reg_factors, torch.float32)

    def dense_subtree(params):
        return {"w0": params["w0"], "mlp": params["mlp"]}

    def init_opt_state(params):
        return dense_opt.init(dense_subtree(params))

    @torch.no_grad()
    def body(params, opt_state, step_idx, ids, vals, labels, weights,
             caux=None):
        w0, mlp = params["w0"], params["mlp"]
        fwd = _fs._field_forward(
            spec, g, mesh, params["vw"], w0, ids, vals, labels, weights,
            device_cap=device_cap, add_bias=False, gfull=config.gfull_fused,
            wire=wire)
        b = fwd.vals_c.shape[0]
        h_loc = torch.cat(fwd.xvs, dim=1)                # [B, fl·k]
        if wire is not None:
            h_loc = h_loc.to(wire)
        if g["two_d"]:
            h_loc = mesh.all_reduce(h_loc, "row")
        labels, weights = fwd.labels, fwd.weights
        wsum = torch.clamp(weights.sum(), min=1.0)
        if config.deep_sharded:
            if b % n:
                raise ValueError(
                    f"deep_sharded requires the global batch ({b}) to "
                    f"divide by the feat mesh extent ({n})")
            bl = b // n
            h_ex = mesh.all_to_all(h_loc.reshape(n, bl, fl * k), "feat")
            h_ex = h_ex.permute(1, 0, 2).reshape(bl, f_pad * k)[:, :nf * k]
            kernels, ins, pres, deep_l = _mlp_forward(spec, mlp, h_ex.to(cd))
            # The [B] deep scores gather in full precision even under a
            # bf16 wire (the reference's rule).
            deep = mesh.all_gather(deep_l, "feat").reshape(-1).to(cd)
            scores = fwd.scores + deep
            if spec.use_bias:
                scores = scores + w0.to(cd)
            loss, dscores = _fs._loss_and_grad(per_example_loss, scores,
                                               labels, weights, wsum)
            i0 = mesh.coord("feat") * bl
            g_mlp, g_h_ex = _mlp_backward(spec, kernels, ins, pres,
                                          dscores[i0:i0 + bl].to(cd))
            g_mlp = _unflat_grads(mesh.all_reduce(_flat_grads(g_mlp),
                                                  "feat"), g_mlp)
            g_h_ex = torch.nn.functional.pad(g_h_ex, (0, (f_pad - nf) * k))
            if wire is not None:
                g_h_ex = g_h_ex.to(wire)
            back = mesh.all_to_all(
                g_h_ex.reshape(bl, n, fl * k).permute(1, 0, 2), "feat")
            g_h_loc = back.reshape(b, fl * k).to(cd)
        else:
            h = mesh.all_gather(h_loc, "feat")           # [n, B, fl·k]
            h = h.permute(1, 0, 2).reshape(b, f_pad * k)[:, :nf * k].to(cd)
            kernels, ins, pres, deep = _mlp_forward(spec, mlp, h)
            scores = fwd.scores + deep
            if spec.use_bias:
                scores = scores + w0.to(cd)
            loss, dscores = _fs._loss_and_grad(per_example_loss, scores,
                                               labels, weights, wsum)
            g_mlp, g_h = _mlp_backward(spec, kernels, ins, pres, dscores)
            g_h = torch.nn.functional.pad(g_h, (0, (f_pad - nf) * k))
            c0 = g["feat0"] * k
            g_h_loc = g_h[:, c0:c0 + fl * k]
        lr = lr_at(_step_tensor(step_idx, w0.device))
        touched = weights > 0
        s, xvs, rows, vals_c = fwd.s, fwd.xvs, fwd.rows, fwd.vals_c
        if config.gfull_fused:
            extra = torch.nn.functional.pad(g_h_loc.reshape(-1, fl, k),
                                            (0, 1))
            g_fulls = _gfull_grads(dscores, vals_c, s, fwd.xv_fulls, rows,
                                   touched.to(cd), k, cd, spec.use_linear,
                                   config, extra=extra)
        else:
            g_fulls = []
            for f in range(fl):
                x_f = vals_c[:, f:f + 1]
                gv = (dscores[:, None] * x_f * (s - xvs[f])
                      + g_h_loc[:, f * k:(f + 1) * k] * x_f)
                if config.reg_factors:
                    gv = gv + reg_factors * rows[f][:, :k] * touched[:, None]
                if spec.use_linear:
                    gl = dscores * vals_c[:, f]
                    if config.reg_linear:
                        gl = gl + reg_linear * rows[f][:, k] * touched
                else:
                    gl = torch.zeros_like(dscores)
                g_fulls.append(torch.cat([gv, gl[:, None]], dim=1))
        _fs._write(g, fwd, g_fulls, config, noise_for, step_idx, -lr,
                   device_cap > 0)
        g_w0 = sum_upcast(dscores).float()
        if config.reg_bias:
            g_w0 = g_w0 + reg_bias32 * w0
        if config.reg_factors:
            g_mlp = [{key: gr[key] + reg_factors32 * layer[key] for key in gr}
                     for gr, layer in zip(g_mlp, mlp)]
        dense = dense_subtree(params)
        apply_updates(dense, dense_opt.update({"w0": g_w0, "mlp": g_mlp},
                                              opt_state, dense))
        loss = _fs._fold_mesh_overflow(mesh, g, loss, fwd.ovf, config)
        return params, opt_state, loss

    return body, init_opt_state


def make_field_deepfm_sharded_step(spec, config: TrainConfig, mesh):
    """The sharded hybrid step as the training loop runs it, captured on
    the card over ``{"params", "opt"}`` (eager on the CPU): ``step(params,
    opt_state, step_idx, ids, vals, labels, weights) → (params, opt_state,
    loss)`` with ``step.init_opt_state``."""
    body, init_opt_state = make_field_deepfm_sharded_body(spec, config, mesh)
    step = _fs._capture(body, carries_opt=True)
    step.init_opt_state = init_opt_state
    return step


def make_field_deepfm_sharded_multistep(spec, config: TrainConfig, mesh,
                                        n: int):
    """``n`` sharded DeepFM steps per call over ``[n, ...]``-stacked
    batches, the optimizer's state carried: ``mstep(params, opt_state,
    step0, m, ids, vals, labels, weights) → (params, opt_state,
    last_loss)``; ``mstep.init_opt_state``."""
    from fm_spark_tpu_torch.sparse import _deepfm_roll, _on_card

    _fs._check_sharded_multistep(config, n)
    body, init_opt_state = make_field_deepfm_sharded_body(spec, config, mesh)

    def run(state, step0, *inputs):
        return _deepfm_roll(body, state["params"], state["opt"], step0,
                            inputs[0].shape[0], *inputs, None)

    captured = graphs.CapturedStep(run)

    def mstep(params, opt_state, step0, m, ids, vals, labels, weights):
        m = int(m)
        if not 1 <= m <= n:
            raise ValueError(f"m must be in [1, {n}], got {m}")
        if not _on_card(params):
            return params, opt_state, _deepfm_roll(
                body, params, opt_state, int(step0), m, ids, vals, labels,
                weights, None)
        loss = captured({"params": params, "opt": opt_state}, step0,
                        *(t[:m] for t in (ids, vals, labels, weights)))
        return params, opt_state, loss

    mstep.captured = captured
    mstep.init_opt_state = init_opt_state
    return mstep


def make_field_deepfm_sharded_eval_step(spec, mesh,
                                        deep_sharded: bool = False):
    """Metrics accumulation on the sharded DeepFM layout: the FM forward
    and the head, replicated or (``deep_sharded``) on each rank's example
    block with the ``[B]`` deep scores gathered."""
    from fm_spark_tpu_torch.models import predict_from_scores
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
    from fm_spark_tpu_torch.sparse import _mlp_forward
    from fm_spark_tpu_torch.utils import metrics as metrics_lib

    if type(spec) is not FieldDeepFMSpec:
        raise ValueError("expected a FieldDeepFMSpec")
    per_example_loss = losses_lib.loss_fn(spec.loss)
    g = _fs._geometry(spec, mesh)
    cd, k, nf = spec.cdtype, spec.rank, spec.num_fields
    fl, f_pad, n = g["f_local"], g["f_pad"], g["n_feat"]

    @torch.no_grad()
    def estep(params, mstate, ids, vals, labels, weights):
        fwd = _fs._field_forward(spec, g, mesh, params["vw"], params["w0"],
                                 ids, vals, labels, weights, add_bias=False)
        b = fwd.vals_c.shape[0]
        h_loc = torch.cat(fwd.xvs, dim=1)
        if g["two_d"]:
            h_loc = mesh.all_reduce(h_loc, "row")
        if deep_sharded:
            if b % n:
                raise ValueError(
                    f"deep_sharded eval requires the batch ({b}) to divide "
                    f"by the feat mesh extent ({n})")
            h_ex = mesh.all_to_all(h_loc.reshape(n, b // n, fl * k), "feat")
            h_ex = h_ex.permute(1, 0, 2).reshape(b // n, f_pad * k)
            deep_l = _mlp_forward(spec, params["mlp"], h_ex[:, :nf * k])[3]
            deep = mesh.all_gather(deep_l, "feat").reshape(-1).to(cd)
        else:
            h = mesh.all_gather(h_loc, "feat").permute(1, 0, 2)
            h = h.reshape(b, f_pad * k)[:, :nf * k]
            deep = _mlp_forward(spec, params["mlp"], h)[3]
        scores = fwd.scores + deep
        if spec.use_bias:
            scores = scores + params["w0"].to(cd)
        per = per_example_loss(scores, fwd.labels)
        return metrics_lib.update_metrics(
            mstate, scores, fwd.labels, per, fwd.weights,
            predictions=predict_from_scores(spec, scores))

    return estep
