"""Training of the port: the config dataclass, the learning-rate schedule,
the single-card field-sparse training loop and evaluation (the port of
``TrainConfig`` and ``evaluate_params`` in ``fm_spark_tpu/train.py``, and
of the single-chip core of ``fm_spark_tpu/cli.py::_fit_field_sparse``).

The update rule is the reference's plain SGD,
``weights ← weights − lr_t · (grad + reg · weights)``, with
``lr_t = stepSize/√(t+1)`` or constant.
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
    levers of steps the port does not have yet (the sharded and DeepFM
    knobs, ``embed_tier``) are accepted here and refused by the step that
    would need them."""

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
    ``rmse``, ``count``) as floats. Scores go through ``spec.scores`` (the
    fused forward kernel on CUDA)."""
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


def _resume(checkpointer, params, batches) -> tuple[int, dict | None]:
    """Restore the newest verified checkpoint into ``params`` (in place,
    before any step is captured, so the graph binds the restored tensors)
    and its cursor into ``batches``, the innermost source (under the aux
    wrapper and the prefetcher). Returns ``(start step, restore info)``,
    ``(0, None)`` on a fresh chain (the reference's ``cli._resume``)."""
    from fm_spark_tpu_torch.checkpoint import copy_into

    t0 = time.perf_counter()
    restored = checkpointer.restore(params)
    if restored is None:
        return 0, None
    copy_into(params, restored["params"])
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
    """Train ``spec`` (a FieldFM or FieldFFM) for ``config.num_steps``
    steps of the fused sparse-SGD step on one card and return the
    parameters (the single-card, canonical-layout counterpart of the
    reference's ``cli._fit_field_sparse``).

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
    FieldFFM twin), or in groups of ``steps_per_call > 1`` through
    :func:`~fm_spark_tpu_torch.sparse.make_field_sparse_multistep`: on the
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
    params copied into the initialised tensors before the first capture,
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
    on a fresh start) and ``saves`` (each save's
    snapshot, crc and write ms and bytes).
    """
    from fm_spark_tpu_torch import resolve_device
    from fm_spark_tpu_torch.data import DedupAuxBatches, Prefetcher
    from fm_spark_tpu_torch.sparse import (fused_embed_plan,
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
    if steps_per_call == 1:
        step = make_sgd_step(spec, config)
    else:
        step = make_field_sparse_multistep(spec, config, steps_per_call)

    def run(p, i, group):
        if steps_per_call == 1:
            return step(p, i, *group[0])
        return step(p, i, len(group), *_stack(group))
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
    start, resumed = 0, None
    if checkpointer is not None:
        start, resumed = _resume(checkpointer, params, batches)
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
                checkpointer.save(i, params, cursor.state())
        if checkpointer is not None:
            if i > start:
                check_poison()
            # The last step's save, or the preemption flush.
            checkpointer.save(i, params, cursor.state(), force=True)
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
    return params
