"""The dense strategies over a ``(data, feat)`` mesh: ``dp`` and ``row``
(the port of ``fm_spark_tpu/parallel/step.py``).

- ``dp`` — every family (the flat ones and the field families' generic
  dense step): the batch split over ``data``, the model replicated; each
  rank takes the gradient of its rows (the loss divided by the weight
  total of the whole batch) and one ``all_reduce`` over ``data`` sums the
  gradients (the reference's ``psum``, Spark's ``treeAggregate``), packed
  into one buffer per dtype. Every rank then applies the same update.
- ``row`` — the flat FM only: ``w`` and ``v`` row-sharded over ``feat``.
  Each rank forms the masked partial sums ``(lin, s, Σ xv²)`` of the ids
  in its rows; one ``all_reduce`` over ``feat`` gives the exact scores;
  the gradient of its own rows follows from the scores' cotangents
  (``∂/∂lin = ds``, ``∂/∂s = ds·s``, ``∂/∂Σxv² = −ds/2``), each id's
  lanes summed once by the device dedup; the gradients are then summed
  over ``data``. It materializes a dense gradient of each rank's rows
  every step (the reference's SCALE CAVEAT: ``field_sparse`` is the
  path for CTR tables; ``cli.check_row_scale`` warns past 1M features).

The optimizer (``config.optimizer``) runs on each rank's params after
the reduction, as XLA keeps each update local to the rows' owner. On the
card the step is captured as one CUDA graph over ``{"params", "opt"}``;
on the CPU it runs eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from fm_spark_tpu_torch import graphs
from fm_spark_tpu_torch.train import TrainConfig

def _is_plain_fm(spec) -> bool:
    from fm_spark_tpu_torch.models.fm import FMSpec

    return type(spec) is FMSpec


def param_specs(spec, strategy: str) -> dict:
    """Each top-level param group's placement: ``None`` replicated,
    ``"feat"`` row-sharded over ``feat``."""
    if strategy == "dp":
        return {}
    if strategy == "row":
        if not _is_plain_fm(spec):
            raise ValueError(
                "row-sharded strategy supports the FM family only; "
                "use strategy='dp' for FFM/DeepFM")
        return {"w0": None, "w": "feat", "v": "feat"}
    raise ValueError(f"unknown strategy {strategy!r}")


def _check_divisibility(spec, mesh, strategy):
    if strategy == "row" and spec.num_features % mesh.shape["feat"]:
        raise ValueError(
            f"num_features={spec.num_features} must be divisible by the "
            f"feat mesh axis ({mesh.shape['feat']}); pad the hash space up")


def _rows_per(spec, mesh) -> int:
    return spec.num_features // mesh.shape["feat"]


def shard_params(params, mesh, spec, strategy: str) -> dict:
    """This rank's params on its device: a copy of every replicated group
    and, under ``row``, its rows of ``w`` and ``v``."""
    from fm_spark_tpu_torch.train import _tree_map

    specs = param_specs(spec, strategy)
    _check_divisibility(spec, mesh, strategy)
    dev = mesh.device
    out = {}
    for key, tree in params.items():
        if specs.get(key) == "feat":
            n = _rows_per(spec, mesh)
            lo = mesh.coord("feat") * n
            out[key] = tree[lo:lo + n].to(dev, copy=True).contiguous()
        else:
            out[key] = _tree_map(lambda t: t.to(dev, copy=True), tree)
    return out


def gather_tree(tree, mesh, spec, strategy: str, root=None):
    """The whole tree from every rank's (:func:`shard_params`' inverse):
    the params, or a tree shaped like them (an optimizer state's
    moments). Every leaf under a ``w``/``v`` key of a ``row`` run is
    gathered over ``feat``, the rest copied: on every rank's device
    (``root`` None), or in host memory on the mesh's rank ``root`` alone
    (None on the others)."""
    specs = param_specs(spec, strategy)
    n_feat = mesh.shape["feat"]

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, key) for v in t]
        if specs.get(key) == "feat":
            if root is None:
                return mesh.all_gather(t, "feat").reshape(-1, *t.shape[1:])
            # Over the whole mesh; data row 0 holds every feat shard once.
            g = mesh.gather(t, root)
            return None if g is None else \
                g[:n_feat].reshape(-1, *t.shape[1:]).cpu()
        if root is None:
            return t.clone()
        return t.detach().cpu() if mesh.index == root else None

    out = walk(tree)
    return out if root is None or mesh.index == root else None


def shard_tree(tree, mesh, spec, strategy: str):
    """:func:`gather_tree`'s inverse: this rank's rows of every ``w``/``v``
    leaf, on its device."""
    specs = param_specs(spec, strategy)
    dev = mesh.device

    def walk(t, key=None):
        if isinstance(t, dict):
            return {k: walk(v, k) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [walk(v, key) for v in t]
        if specs.get(key) == "feat":
            n = t.shape[0] // mesh.shape["feat"]
            lo = mesh.coord("feat") * n
            return t[lo:lo + n].to(dev, copy=True).contiguous()
        return t.to(dev, copy=True)

    return walk(tree)


def shard_batch(batch, mesh):
    """This rank's rows of a global ``(ids, vals, labels, weights)``: the
    batch shards over ``data`` (every ``feat`` rank of a data row gets the
    same rows)."""
    rows = np.asarray(batch[0]).shape[0]
    nd = mesh.shape["data"]
    if rows % nd:
        raise ValueError(f"batch of {rows} rows does not divide over the data "
                         f"mesh axis ({nd})")
    lo = mesh.coord("data") * (rows // nd)
    dev = mesh.device or torch.device("cpu")
    return tuple(torch.as_tensor(np.ascontiguousarray(
        np.asarray(a)[lo:lo + rows // nd])).to(dev) for a in batch)


def _sum_over(mesh, tree, axes):
    """Every leaf of ``tree`` summed over ``axes``: one all_reduce per
    dtype of the leaves packed together."""
    from fm_spark_tpu_torch.graphs import _leaves
    from fm_spark_tpu_torch.lbfgs import _rebuild

    leaves = _leaves(tree)
    out = list(leaves)
    for dtype in sorted({t.dtype for t in leaves}, key=str):
        idx = [i for i, t in enumerate(leaves) if t.dtype == dtype]
        packed = mesh.all_reduce(torch.cat([leaves[i].reshape(-1)
                                            for i in idx]), axes)
        for i, part in zip(idx, torch.split(packed, [leaves[i].numel()
                                                     for i in idx])):
            out[i] = part.view_as(leaves[i])
    return _rebuild(tree, iter(out))


def _row_partials(spec, params, ids, vals, row0: int, n: int):
    """The rank's masked partial sums and what the backward needs:
    ``(lin_p, s_p, sq_p, own, loc, xv, vals_c)``."""
    from fm_spark_tpu_torch.ops.fm import sum_upcast

    cd = spec.cdtype
    vals_c = vals.to(cd)
    loc = ids.long() - row0
    own = (loc >= 0) & (loc < n)
    safe = torch.where(own, loc, 0)
    mask = own.to(cd)
    xv = params["v"][safe].to(cd) * (vals_c * mask)[..., None]  # [B, nnz, k]
    s_p = sum_upcast(xv, 1)
    sq_p = sum_upcast(xv * xv, (1, 2))
    if spec.use_linear:
        lin_p = sum_upcast(params["w"][safe].to(cd) * vals_c * mask, 1)
    else:
        lin_p = torch.zeros_like(sq_p)
    return lin_p, s_p, sq_p, own, loc, xv, vals_c


def _row_scores(spec, mesh, params, ids, vals):
    """The row strategy's exact scores (one all_reduce over ``feat`` of
    the packed partials) and the pieces its backward needs."""
    from fm_spark_tpu_torch.ops.fm import sum_upcast

    n = _rows_per(spec, mesh)
    lin_p, s_p, sq_p, own, loc, xv, vals_c = _row_partials(
        spec, params, ids, vals, mesh.coord("feat") * n, n)
    k = s_p.shape[1]
    packed = mesh.all_reduce(torch.cat([lin_p[:, None], s_p, sq_p[:, None]],
                                       dim=1), "feat")
    lin, s, sq = packed[:, 0], packed[:, 1:k + 1], packed[:, k + 1]
    w0 = (params["w0"] if spec.use_bias
          else torch.zeros((), device=lin.device)).to(spec.cdtype)
    scores = w0 + lin + 0.5 * (sum_upcast(s * s, 1) - sq)
    return scores, s, own, loc, xv, vals_c, n


def _grads_fn(spec, mesh, strategy: str):
    """``fn(params, ids, vals, labels, weights) → (loss, grads)`` of the
    rank's rows, summed over ``data`` (and the loss too)."""
    from fm_spark_tpu_torch.sparse import _loss_and_grad_fn
    from fm_spark_tpu_torch.train import _dense_grads_fn, _summed_rows

    def wsum_of(weights):
        return torch.clamp(mesh.all_reduce(weights.sum(), "data"), min=1.0)

    if strategy == "dp":
        local = _dense_grads_fn(spec)

        def grads(params, ids, vals, labels, weights):
            loss, g = local(params, ids, vals, labels, weights,
                            wsum=wsum_of(weights))
            return mesh.all_reduce(loss, "data"), _sum_over(mesh, g, "data")

        return grads

    loss_and_grad = _loss_and_grad_fn(spec.loss)

    def grads(params, ids, vals, labels, weights):
        scores, s, own, loc, xv, vals_c, n = _row_scores(
            spec, mesh, params, ids, vals)
        loss, dscores = loss_and_grad(scores, labels, weights,
                                      wsum_of(weights))
        k = s.shape[1]
        mask = own.to(vals_c.dtype)
        g_v = (dscores[:, None, None] * (vals_c * mask)[..., None]
               * (s[:, None, :] - xv))
        g_w = (dscores[:, None] * vals_c * mask if spec.use_linear
               else torch.zeros_like(vals_c))
        m = ids.numel()
        wid = torch.where(own, loc, n)                  # foreign ids drop
        gv, gw = _summed_rows(wid, n, torch.cat(
            [g_v.float().reshape(m, k), g_w.float().reshape(m, 1)], dim=1),
            (k, 1))
        pd = spec.pdtype
        g_w0 = (dscores.float().sum() if spec.use_bias
                else torch.zeros((), device=dscores.device))
        out = {"w0": g_w0, "w": gw.reshape(n).to(pd), "v": gv.to(pd)}
        return mesh.all_reduce(loss, "data"), _sum_over(mesh, out, "data")

    return grads


def _global_norm(mesh, grads, strategy: str):
    """optax's ``global_norm`` of the whole gradient: a row-sharded
    leaf's squares summed over ``feat`` too."""
    from fm_spark_tpu_torch.ops.fm import sum_upcast

    if strategy == "dp":
        from fm_spark_tpu_torch.train import _global_norm as norm

        return norm(grads)
    sharded = sum_upcast(grads["w"] * grads["w"]).float() + sum_upcast(
        grads["v"] * grads["v"]).float()
    total = mesh.all_reduce(sharded, "feat") + (grads["w0"] ** 2).float()
    return torch.sqrt(total)


def make_parallel_train_step(spec, config: TrainConfig, mesh,
                             strategy: str = "dp", optimizer=None):
    """The dense step over ``mesh``: ``step(params, opt_state, ids, vals,
    labels, weights) → (params, opt_state, {"loss", "grad_norm"})``, this
    rank's params (:func:`shard_params`) and state updated in place, its
    batch rows (:func:`shard_batch`)."""
    from fm_spark_tpu_torch.sparse import (_reject_collective_dtype,
                                           _reject_deep_sharded,
                                           _reject_fused_embed_require,
                                           _reject_host_aux,
                                           _reject_score_sharded,
                                           _reject_sel_blocked)
    from fm_spark_tpu_torch.train import (_group_reg, apply_updates,
                                          make_optimizer)

    _reject_host_aux(config, "the dense optax parallel step")
    _reject_score_sharded(config, "the dense optax parallel step")
    _reject_sel_blocked(config, "the dense optax parallel step")
    _reject_deep_sharded(config, "the dense optax parallel step")
    _reject_fused_embed_require(config, "the dense optax parallel step")
    # The gradient's reduction feeds the optimizer directly (no later
    # float32 re-derivation): a wire dtype here is another precision
    # contract, refused as the reference refuses it.
    _reject_collective_dtype(config, "the dense optax parallel step")
    param_specs(spec, strategy)
    if set(mesh.axis_names) != {"data", "feat"}:
        raise ValueError("the dense parallel step runs on a (data, feat) "
                         "mesh (use make_mesh)")
    _check_divisibility(spec, mesh, strategy)
    optimizer = optimizer or make_optimizer(config)
    add_reg = _group_reg(config)
    grads_fn = _grads_fn(spec, mesh, strategy)

    @torch.no_grad()
    def body(params, opt_state, ids, vals, labels, weights):
        loss, grads = grads_fn(params, ids, vals, labels, weights)
        grads = add_reg(grads, params)
        norm = _global_norm(mesh, grads, strategy)
        apply_updates(params, optimizer.update(grads, opt_state, params))
        return loss.float(), norm

    def run(state, _step, *batch):
        return torch.stack(body(state["params"], state["opt"], *batch))

    captured = graphs.CapturedStep(run)

    def step(params, opt_state, ids, vals, labels, weights):
        if params["w0"].device.type != "cuda":
            loss, norm = body(params, opt_state, ids, vals, labels, weights)
        else:
            loss, norm = captured({"params": params, "opt": opt_state}, 0,
                                  ids, vals, labels, weights)
        return params, opt_state, {"loss": loss, "grad_norm": norm}

    step.captured = captured
    step.body = body
    step.optimizer = optimizer
    return step


def make_parallel_eval_step(spec, mesh, strategy: str = "dp"):
    """Sharded metrics accumulation: ``estep(params, mstate, ids, vals,
    labels, weights) → mstate`` (each rank's batch rows; the metrics'
    sums reduced over ``data``, so the state stays replicated)."""
    from fm_spark_tpu_torch.models import predict_from_scores
    from fm_spark_tpu_torch.ops import losses
    from fm_spark_tpu_torch.utils import metrics as metrics_lib

    _check_divisibility(spec, mesh, strategy)
    param_specs(spec, strategy)
    per_example_loss = losses.loss_fn(spec.loss)

    @torch.no_grad()
    def estep(params, mstate, ids, vals, labels, weights):
        if strategy == "dp":
            scores = spec.scores(params, ids, vals)
        else:
            scores = _row_scores(spec, mesh, params, ids, vals)[0]
        per = per_example_loss(scores, labels)
        d = metrics_lib.update_metrics(
            metrics_lib.init_metrics(device=scores.device), scores, labels,
            per, weights, predictions=predict_from_scores(spec, scores))
        fields = [mesh.all_reduce(t, "data") for t in d]
        return type(mstate)(*(a + b for a, b in zip(mstate, fields)))

    return estep


def precompile_parallel_train_step(spec, config: TrainConfig, mesh,
                                   strategy: str = "dp", *, batch_size: int,
                                   nnz: int | None = None, params,
                                   opt_state, optimizer=None):
    """Capture the dense parallel step for ``params``/``opt_state`` ahead
    of the data (the reference's ``lower().compile()`` warm start), over
    zero batches of this rank's rows; on the CPU nothing is captured.
    Every rank calls it (its warm-up runs the collectives)."""
    nnz = nnz if nnz is not None else getattr(spec, "num_fields", None)
    if not nnz:
        raise ValueError("nnz (ids per example) is required for a model "
                         "without num_fields")
    nd = mesh.shape["data"]
    if batch_size % nd:
        raise ValueError(f"batch_size={batch_size} must divide by the data "
                         f"mesh axis ({nd})")
    step = make_parallel_train_step(spec, config, mesh, strategy, optimizer)
    dev = params["w0"].device
    b = batch_size // nd
    batch = (torch.zeros(b, nnz, dtype=torch.int32, device=dev),
             torch.zeros(b, nnz, device=dev), torch.zeros(b, device=dev),
             torch.zeros(b, device=dev))
    if dev.type == "cuda":
        step.captured({"params": params, "opt": opt_state}, 0, *batch)
    return step


def evaluate_parallel(spec, mesh, params, batches, strategy: str = "dp",
                      estep=None) -> dict:
    """Stream global host batches through :func:`make_parallel_eval_step`
    (every rank feeds its rows of each) → finalized metrics, the same on
    every rank."""
    from fm_spark_tpu_torch.utils import metrics as metrics_lib

    estep = estep or make_parallel_eval_step(spec, mesh, strategy)
    mstate = metrics_lib.init_metrics(device=params["w0"].device)
    for batch in batches:
        mstate = estep(params, mstate, *shard_batch(tuple(batch)[:4], mesh))
    return metrics_lib.finalize_metrics(mstate)


def fit_parallel(spec, config: TrainConfig, batches, mesh,
                 strategy: str = "dp", *, prefetch: int = 0, logger=None,
                 checkpointer=None, preemption_guard=None,
                 stats: dict | None = None, eval_source=None) -> dict:
    """Train ``spec`` by the dense ``dp``/``row`` step on every rank of
    ``mesh`` for ``config.num_steps`` steps (the reference CLI's
    ``_fit_parallel``) and return this rank's params
    (:func:`shard_params`' layout: the whole model under ``dp``;
    :func:`gather_tree` joins a ``row`` run's rows).

    ``batches`` (numpy) yields this rank's rows of each global batch
    (``B / n_data``: the per-process input shard; the ranks of one data
    row read the same rows). The params start from ``spec.init`` seeded
    by ``config.seed``. ``checkpointer``: the run resumes from its newest
    verified step and saves on its cadence and at the end, in the
    canonical layout (params and optimizer state gathered into rank 0's
    host memory; rank 0 writes with its cursor, which every rank
    restores). ``eval_source`` (global batches) is evaluated every
    ``config.eval_every`` steps on the sharded params
    (:func:`evaluate_parallel`). The loop is ``train.fit_steps``
    (``prefetch``, the log lines with ``loss`` and ``grad_norm``, the obs
    plane); ``stats``: its result and ``capture_s``, ``start``,
    ``resumed``."""
    from fm_spark_tpu_torch.data.pipeline import MappedBatches
    from fm_spark_tpu_torch.train import _resume, fit_steps, make_optimizer

    dev = mesh.device or torch.device("cpu")
    canonical = spec.init(torch.Generator(device=dev).manual_seed(
        config.seed), device=dev)
    optimizer = make_optimizer(config)
    opt_canonical = optimizer.init(canonical)
    start, resumed = 0, None
    if checkpointer is not None:
        start, resumed, _ = _resume(checkpointer, canonical, opt_canonical,
                                    batches)
    params = shard_params(canonical, mesh, spec, strategy)
    opt_state = shard_tree(opt_canonical, mesh, spec, strategy)
    del canonical, opt_canonical
    step = make_parallel_train_step(spec, config, mesh, strategy, optimizer)
    src = MappedBatches(batches, lambda b: tuple(b)[:4])

    def run(_i, _m, batch):
        return step(params, opt_state, *batch)[2]

    def save(at, pipeline, force=False):
        whole = gather_tree(params, mesh, spec, strategy, root=0)
        opt = gather_tree(opt_state, mesh, spec, strategy, root=0)
        if mesh.index == 0:
            checkpointer.save(at, whole, pipeline, force=force,
                              opt_state=opt)
            checkpointer.wait()
        mesh.barrier()

    out = fit_steps(config, src, run, device=dev, start=start,
                    prefetch=prefetch, logger=logger,
                    rows_scale=mesh.shape["data"], evaluate=(
                        None if eval_source is None else
                        lambda: evaluate_parallel(spec, mesh, params,
                                                  eval_source(), strategy)),
                    checkpointer=checkpointer, save=save,
                    preemption_guard=preemption_guard)
    if stats is not None:
        stats.update(out, capture_s=list(step.captured.capture_s),
                     start=start, resumed=resumed)
    return params
