"""Training of the port: the config dataclass, the learning-rate schedule,
the dense optimizers, the single-card field-sparse training loop and
evaluation (the port of ``TrainConfig``, ``make_optimizer`` and
``evaluate_params`` in ``fm_spark_tpu/train.py``, and of the single-chip
core of ``fm_spark_tpu/cli.py::_fit_field_sparse``).

The tables' update rule is the reference's plain SGD,
``weights ← weights − lr_t · (grad + reg · weights)``, with
``lr_t = stepSize/√(t+1)`` or constant. FieldDeepFM's MLP and bias take
``config.optimizer`` (:func:`make_optimizer`: optax's sgd, adam or
adagrad, computed as optax computes them).
"""

from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters: field for field those of the JAX
    package's ``TrainConfig``, so a config reads the same in both. The
    levers of steps the port does not have yet (the sharded knobs,
    ``embed_tier``) are accepted here and refused by the step that would
    need them."""

    num_steps: int = 100                   # numIterations
    batch_size: int = 1024
    learning_rate: float = 0.1             # stepSize
    lr_schedule: str = "inv_sqrt"          # stepSize/√iter | 'constant'
    optimizer: str = "sgd"
    reg_bias: float = 0.0                  # regParam triple (r0, r1, r2)
    reg_linear: float = 0.0
    reg_factors: float = 0.0
    seed: int = 0
    log_every: int = 100
    eval_every: int = 0                    # 0 = only at the end
    metrics_path: str | None = None
    # Sparse-row write strategy: 'scatter_add' | 'dedup' | 'dedup_sr'.
    sparse_update: str = "scatter_add"
    # Row gathers and scatter_add/dedup writes by the row kernels (ops/rows).
    use_pallas: bool = False
    # Host-built aux: ops/scatter.compact_aux with a static cap > 0, else
    # ops/scatter.dedup_aux.
    host_dedup: bool = False
    compact_cap: int = 0
    compact_device: bool = False
    compact_overflow: str = "error"        # 'error' | 'drop' | 'split'
    # One elementwise g_full expression per field (sparse._gfull_grads).
    gfull_fused: bool = False
    collective_dtype: str = "float32"
    score_sharded: bool = False
    deep_sharded: bool = False
    # Segment sums by kernel A (ops/segsum) instead of the blocked prefix.
    segtotal_pallas: bool = False
    # FieldFFM: the per-owner-field loop in place of the sel tensor.
    sel_blocked: bool = False
    # Fused kernels (FieldFM: kernel B, ops/fused_bwd; FieldFFM with
    # sel_blocked: ops/ffm_sel): 'off' | 'auto' | 'require'.
    fused_embed: str = "off"
    embed_tier: str = "off"
    hot_rows: int = 0
    embed_bucket_rows: int = 512


def _lr_at(config: TrainConfig):
    """The reference's 1-based ``stepSize/√iter`` schedule (or constant),
    as ``step → float32 learning rate``, computed in float32 as the
    reference's traced schedule is."""
    lr = np.float32(config.learning_rate)
    if config.lr_schedule == "inv_sqrt":
        return lambda i: lr / np.sqrt(np.float32(i) + np.float32(1.0))
    if config.lr_schedule == "constant":
        return lambda i: lr
    raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")


def _lr_at_tensor(config: TrainConfig):
    """:func:`_lr_at` on the device: ``step`` (a 0-dim integer tensor) →
    the float32 learning rate as a 0-dim tensor on its device, in the
    reference's float32 order, ``lr / sqrt(float32(step) + 1)``, each
    operation rounded once as IEEE float32 (numpy's value bit for bit).
    The square root and the division run in float64 and round to float32,
    which is exact for both (53 ≥ 2·24 + 2 bits): the CPU's float32
    ``torch.sqrt`` is not always correctly rounded. A captured step reads
    its step from the device, so no host value is baked in."""
    lr = float(np.float32(config.learning_rate))
    if config.lr_schedule == "inv_sqrt":
        def lr_at(i):
            root = torch.sqrt((i.to(torch.float32) + 1.0).double()).float()
            return torch.div(torch.full((), lr, dtype=torch.float64,
                                        device=i.device),
                             root.double()).float()
        return lr_at
    if config.lr_schedule == "constant":
        return lambda i: torch.full((), lr, dtype=torch.float32,
                                    device=i.device)
    raise ValueError(f"unknown lr_schedule {config.lr_schedule!r}")


def _tree_map(fn, tree, *rest):
    """``fn`` over the tensors of a pytree of dicts and lists (and of the
    trees in ``rest``, which share its structure)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def _count(device) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _advance(count: torch.Tensor) -> None:
    """optax's ``safe_increment``, in place: ``count + 1`` below the int32
    maximum, else the maximum."""
    count.copy_(torch.where(count < 2**31 - 1, count + 1, count))


def _bias_correction(moment, decay: float, count):
    """optax's ``bias_correction``: ``moment / (1 - decay**count)`` in
    float32, ``decay`` taken as the float32 JAX makes of it.
    ``decay**count`` is float32's correctly rounded power (in float64,
    rounded once), read from the count on the device."""
    power = torch.pow(torch.full((), float(np.float32(decay)),
                                 dtype=torch.float64, device=count.device),
                      count.double()).float()
    return moment / (1.0 - power)


class Optimizer:
    """An optax ``GradientTransformation`` of the dense parameters, in
    place: :meth:`init` makes the state (a dict of tensors on the params'
    device, every count a 0-dim int32), :meth:`update` advances it and
    returns the updates, which :func:`apply_updates` adds to the params.
    Nothing is read on the host, so a captured step may run it: the
    learning rate and the bias corrections are computed on the device
    from the counts."""

    def __init__(self, name: str, config: TrainConfig):
        self.name = name
        self._config = config
        self._lr_at = _lr_at_tensor(config)

    def init(self, params) -> dict:
        from fm_spark_tpu_torch.graphs import _leaves

        dev = _leaves(params)[0].device
        state = {}
        if self.name == "adam":
            state["count"] = _count(dev)
            state["mu"] = _tree_map(torch.zeros_like, params)
            state["nu"] = _tree_map(torch.zeros_like, params)
        elif self.name == "adagrad":
            state["sum_of_squares"] = _tree_map(
                lambda p: torch.full_like(p, 0.1), params)
        if self._config.lr_schedule == "inv_sqrt":
            # optax.scale_by_schedule's own count.
            state["schedule_count"] = _count(dev)
        return state

    def _neg_lr(self, state):
        """The factor of optax's ``scale_by_learning_rate``: ``-lr`` in
        float32, by the schedule's own count for ``inv_sqrt``."""
        if self._config.lr_schedule == "constant":
            return float(np.float32(-self._config.learning_rate))
        return -self._lr_at(state["schedule_count"])

    def update(self, grads, state, params=None):
        """The updates of ``grads`` (float32, the tree of the params),
        with ``state`` advanced in place, in optax's order of operations."""
        del params
        neg_lr = self._neg_lr(state)
        if self.name == "adam":
            b1, b2, eps = 0.9, 0.999, float(np.float32(1e-8))
            c1, c2 = float(np.float32(1 - b1)), float(np.float32(1 - b2))
            d1, d2 = float(np.float32(b1)), float(np.float32(b2))
            _tree_map(lambda g, m: m.mul_(d1).add_(c1 * g), grads,
                      state["mu"])
            _tree_map(lambda g, v: v.mul_(d2).add_(c2 * (g * g)), grads,
                      state["nu"])
            _advance(state["count"])
            count = state["count"]
            updates = _tree_map(
                lambda m, v: neg_lr * (_bias_correction(m, b1, count) / (
                    torch.sqrt(_bias_correction(v, b2, count)) + eps)),
                state["mu"], state["nu"])
        elif self.name == "adagrad":
            eps = float(np.float32(1e-7))
            _tree_map(lambda g, s: s.add_(g * g), grads,
                      state["sum_of_squares"])
            updates = _tree_map(
                lambda g, s: neg_lr * (torch.where(
                    s > 0, torch.rsqrt(s + eps), torch.zeros_like(s)) * g),
                grads, state["sum_of_squares"])
        else:
            updates = _tree_map(lambda g: neg_lr * g, grads)
        if "schedule_count" in state:
            _advance(state["schedule_count"])
        return updates


def apply_updates(params, updates) -> None:
    """``optax.apply_updates`` in place: ``p ← p + u``."""
    _tree_map(lambda p, u: p.add_(u), params, updates)


def make_optimizer(config: TrainConfig) -> Optimizer:
    """The dense optimizer of ``config`` (the reference's
    ``train.make_optimizer``): ``sgd``, ``adam`` or ``adagrad`` with the
    ``constant`` or ``inv_sqrt`` schedule, as optax 0.2.6 computes them
    (Adam: b1 0.9, b2 0.999, eps 1e-8; AdaGrad: accumulators from 0.1,
    eps 1e-7)."""
    if config.optimizer == "ftrl":
        raise ValueError(
            "optimizer 'ftrl' is not ported yet: FTRL-Proximal lives in the "
            "reference's optim/ package, queued as ROADMAP Queue 1 item 9")
    if config.optimizer not in ("sgd", "adam", "adagrad"):
        raise ValueError(f"unknown optimizer {config.optimizer!r}")
    return Optimizer(config.optimizer, config)


def _batch_to(batch, device):
    """A numpy batch (nested tuples allowed) as tensors on ``device``."""
    from fm_spark_tpu_torch.data.pipeline import host_tensor

    if isinstance(batch, (tuple, list)):
        return tuple(_batch_to(b, device) for b in batch)
    return host_tensor(batch).to(device)


def _stack(group):
    """Batches (tuples of tensors, nested tuples allowed) stacked on a new
    leading axis; one batch is viewed, not copied."""
    if isinstance(group[0], (tuple, list)):
        return tuple(_stack(parts) for parts in zip(*group))
    if len(group) == 1:
        return group[0].unsqueeze(0)
    return torch.stack(group)


@torch.no_grad()
def evaluate_params(spec, params, batches) -> dict:
    """Stream numpy ``(ids, vals, labels, weights)`` batches through the
    model on its params' device → finalized metrics (``auc``, ``logloss``,
    ``rmse``, ``count``) as floats. Scores go through ``spec.scores`` (for
    a FieldFM the fused forward kernel on CUDA)."""
    from fm_spark_tpu_torch.models import predict_from_scores
    from fm_spark_tpu_torch.ops import losses
    from fm_spark_tpu_torch.utils import metrics as metrics_lib

    dev = params["w0"].device
    per_example_loss = losses.loss_fn(spec.loss)
    mstate = metrics_lib.init_metrics(device=dev)
    for batch in batches:
        ids, vals, labels, weights = _batch_to(tuple(batch)[:4], dev)
        scores = spec.scores(params, ids, vals)
        per = per_example_loss(scores, labels)
        preds = predict_from_scores(spec, scores)
        mstate = metrics_lib.update_metrics(mstate, scores, labels, per,
                                            weights, predictions=preds)
    return metrics_lib.finalize_metrics(mstate)


def _resume(checkpointer, params, opt_state, batches
            ) -> tuple[int, dict | None]:
    """Restore the newest verified checkpoint into ``params`` and
    ``opt_state`` (in place, before any step is captured, so the graph
    binds the restored tensors: Adam's moments and counts included) and
    its cursor into ``batches``, the innermost source (under the aux
    wrapper and the prefetcher). Returns ``(start step, restore info)``,
    ``(0, None)`` on a fresh chain (the reference's ``cli._resume``)."""
    from fm_spark_tpu_torch.checkpoint import copy_into

    t0 = time.perf_counter()
    restored = checkpointer.restore(params)
    if restored is None:
        return 0, None
    copy_into(params, restored["params"])
    copy_into(opt_state, restored["opt_state"])
    if restored["pipeline"] is not None:
        if not hasattr(batches, "restore"):
            raise ValueError(
                f"the checkpoint holds a pipeline cursor and the batch "
                f"source {type(batches).__name__} cannot restore one")
        batches.restore(restored["pipeline"])
    info = {"step": restored["step"], "pipeline": restored["pipeline"],
            "restore_ms": (time.perf_counter() - t0) * 1e3,
            **(checkpointer.restore_timing or {})}
    return restored["step"], info


def fit_field_sparse(spec, config: TrainConfig, batches, *, device=None,
                     steps_per_call: int = 1, prefetch: int = 2, logger=None,
                     stats: dict | None = None, checkpointer=None,
                     eval_source=None, preemption_guard=None):
    """Train ``spec`` (a FieldFM, FieldFFM or FieldDeepFM) for
    ``config.num_steps`` steps of the fused sparse step on one card and
    return the parameters (the single-card, canonical-layout counterpart
    of the reference's ``cli._fit_field_sparse``). A FieldDeepFM's step
    carries the dense optimizer's state (``config.optimizer`` on
    ``{"w0", "mlp"}``), initialised beside the params, passed through
    every step and roll, saved and restored with them.

    ``batches`` yields numpy ``(ids, vals, labels, weights)`` batches
    (:class:`~fm_spark_tpu_torch.data.Batches`,
    :class:`~fm_spark_tpu_torch.data.PackedBatches`); with ``host_dedup``
    the aux (compact at ``compact_cap > 0``, else the per-lane dedup aux)
    is built on the host in the prefetch thread
    (:class:`~fm_spark_tpu_torch.data.DedupAuxBatches`, which halves a
    batch past the cap under ``compact_overflow='split'``); with
    ``compact_device`` the step builds it. The parameters start from
    ``spec.init`` seeded by ``config.seed`` and are updated in place. The
    steps run one per call through
    :func:`~fm_spark_tpu_torch.sparse.make_field_sparse_sgd_step` (or its
    FieldFFM and FieldDeepFM twins), or in groups of ``steps_per_call > 1``
    through :func:`~fm_spark_tpu_torch.sparse.make_field_sparse_multistep`
    (or :func:`~fm_spark_tpu_torch.sparse.make_field_deepfm_multistep`): on the
    card always as captured CUDA graphs (one per group length, captured at
    its first call), as the reference's loop always runs its jitted step.
    ``logger`` (a ``MetricsLogger``) gets a loss line every
    ``config.log_every`` steps and at the last. Under ``compact_device``
    with ``compact_overflow='error'`` a running ``fmin`` of every call's
    loss stays on the device (a later NaN cannot hide the −inf overflow
    poison) and is read at each log line, before every checkpoint save
    and once at the end: a −inf there raises, so a poisoned table is
    never saved.

    ``checkpointer`` (a :class:`~fm_spark_tpu_torch.checkpoint
    .Checkpointer`): the run resumes from its newest verified step (the
    params and optimizer state copied into the initialised tensors before
    the first capture,
    the pipeline cursor restored into ``batches``, the step index, and
    with it the learning rate and the SR bits, continuing from the
    restored step), saves whenever a multiple of its ``save_every`` falls
    in a call's steps, and saves at the last step. The saved cursor is
    the prefetcher's: that of the last batch a step consumed.
    ``preemption_guard`` (a :class:`~fm_spark_tpu_torch.checkpoint
    .PreemptionGuard`) is polled between calls: once it is set the loop
    saves the step it reached and returns. ``eval_source``, a callable
    returning an iterable of eval batches, is evaluated and logged
    (``eval_*`` keys) whenever a multiple of ``config.eval_every > 0``
    falls in a call's steps.

    ``stats``, when given, is filled with ``loss`` (per call),
    ``step_ms`` (per call: CUDA-event time on the card, capture included
    in a group's first call; host time on the CPU), ``aux_ms`` (host time
    of each aux build), ``capture_s`` (each capture's seconds, warm-up
    included), ``start`` and ``end`` (the steps the run began and
    stopped at), ``resumed`` (the restore: its step, cursor and ms; None
    on a fresh start), ``saves`` (each save's snapshot, crc and write ms
    and bytes) and ``opt_state`` (the optimizer's state at the end; ``{}``
    but for a FieldDeepFM).
    """
    from fm_spark_tpu_torch import resolve_device
    from fm_spark_tpu_torch.data import DedupAuxBatches, Prefetcher
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
    from fm_spark_tpu_torch.sparse import (fused_embed_plan,
                                           make_field_deepfm_multistep,
                                           make_field_deepfm_sparse_step,
                                           make_field_sparse_multistep,
                                           make_sgd_step)

    dev = resolve_device(device)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if config.fused_embed == "auto":
        family, reason = fused_embed_plan(spec, config)
        name = type(spec).__name__
        print(f"fused-embed: {name} served by kernel family {family!r}"
              if family else
              f"fused-embed: {name} on the plain torch path ({reason})",
              file=sys.stderr)
    deep = isinstance(spec, FieldDeepFMSpec)
    if steps_per_call == 1:
        step = (make_field_deepfm_sparse_step(spec, config) if deep
                else make_sgd_step(spec, config))
    else:
        step = (make_field_deepfm_multistep if deep
                else make_field_sparse_multistep)(spec, config, steps_per_call)

    def run(p, i, group):
        args = ((i, *group[0]) if steps_per_call == 1
                else (i, len(group), *_stack(group)))
        if deep:
            p, _, loss = step(p, opt_state, *args)     # in place
            return p, loss
        return step(p, *args)
    # The 'error' policy's sticky detector (the reference's note_loss /
    # check_poison): fmin, so a NaN loss after the poison keeps the −inf.
    guard = config.compact_device and config.compact_overflow == "error"
    worst = None

    def check_poison():
        if worst is not None and float(worst) == float("-inf"):
            raise RuntimeError(
                "compact_cap overflow poisoned the loss: a field's per-batch "
                f"unique-id count exceeded compact_cap {config.compact_cap} "
                "at some step (the 'error' policy); raise compact_cap or "
                "use compact_overflow='drop'")
    params = spec.init(torch.Generator(device=dev).manual_seed(config.seed),
                       device=dev)
    opt_state = step.init_opt_state(params) if deep else {}
    start, resumed = 0, None
    if checkpointer is not None:
        start, resumed = _resume(checkpointer, params, opt_state, batches)
    aux_src = None
    if config.host_dedup:
        batches = aux_src = DedupAuxBatches(
            batches, cap=config.compact_cap,
            overflow="split" if config.compact_overflow == "split"
            else "error")
    pf = Prefetcher(batches, depth=prefetch, device=dev) if prefetch > 0 \
        else None
    cursor = pf if pf is not None else batches
    on_card = dev.type == "cuda"
    losses, marks = [], []
    log_every = max(config.log_every, 1)
    since = 0
    i = start
    try:
        while i < config.num_steps:
            if preemption_guard is not None and preemption_guard.should_stop:
                break
            m = min(steps_per_call, config.num_steps - i)
            group = [pf.next_batch() if pf else _batch_to(batches.next_batch(), dev)
                     for _ in range(m)]
            if on_card:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
            else:
                t0 = time.perf_counter()
            params, loss = run(params, i, group)
            if on_card:
                t1.record()
                marks.append((t0, t1))
            else:
                marks.append(time.perf_counter() - t0)
            losses.append(loss)      # a fresh tensor per call
            if guard:
                worst = loss if worst is None else torch.fmin(worst, loss)
            i += m
            since += sum(int(b[2].shape[0]) for b in group)
            if logger is not None and (
                    i // log_every > (i - m) // log_every
                    or i >= config.num_steps):
                check_poison()
                logger.log(i, samples=since, loss=float(loss))
                since = 0
            if (eval_source is not None and config.eval_every > 0
                    and i // config.eval_every
                    > (i - m) // config.eval_every):
                metrics = evaluate_params(spec, params, eval_source())
                if logger is not None:
                    logger.log(i, **{f"eval_{k}": v
                                     for k, v in metrics.items()})
            if checkpointer is not None and checkpointer.due_window(i, m):
                check_poison()
                checkpointer.save(i, params, cursor.state(),
                                  opt_state=opt_state)
        if checkpointer is not None:
            if i > start:
                check_poison()
            # The last step's save, or the preemption flush.
            checkpointer.save(i, params, cursor.state(), force=True,
                              opt_state=opt_state)
            checkpointer.wait()
        check_poison()
    finally:
        if pf is not None:
            pf.close()
    if stats is not None:
        if on_card:
            torch.cuda.synchronize(dev)
            stats["step_ms"] = [a.elapsed_time(b) for a, b in marks]
        else:
            stats["step_ms"] = [s * 1e3 for s in marks]
        stats["loss"] = [float(x) for x in losses]
        stats["aux_ms"] = list(aux_src.aux_ms) if aux_src else []
        stats["capture_s"] = list(step.captured.capture_s)
        stats["start"], stats["end"] = start, i
        stats["resumed"] = resumed
        stats["saves"] = list(checkpointer.timings) if checkpointer else []
        stats["opt_state"] = opt_state
    return params
