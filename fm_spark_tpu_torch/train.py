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
    levers of steps this slice does not port (``use_pallas``,
    ``compact_device``, the sharded and FFM/DeepFM knobs, ``embed_tier``)
    are accepted here and refused by the step that would need them."""

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
    use_pallas: bool = False
    # Host-built compact aux (ops/scatter.compact_aux) with a static cap.
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
    sel_blocked: bool = False
    # Fused backward (kernel B, ops/fused_bwd): 'off' | 'auto' | 'require'.
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


def _batch_to(batch, device):
    """A numpy batch (nested tuples allowed) as tensors on ``device``."""
    if isinstance(batch, (tuple, list)):
        return tuple(_batch_to(b, device) for b in batch)
    return torch.from_numpy(np.ascontiguousarray(batch)).to(device)


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


def fit_field_sparse(spec, config: TrainConfig, batches, *, device=None,
                     steps_per_call: int = 1, prefetch: int = 2, logger=None,
                     stats: dict | None = None):
    """Train ``spec`` for ``config.num_steps`` steps of the fused
    sparse-SGD step on one card and return the parameters.

    ``batches`` yields numpy ``(ids, vals, labels, weights)`` batches
    (:class:`~fm_spark_tpu_torch.data.Batches`); with ``host_dedup`` the
    compact aux is built on the host in the prefetch thread
    (:class:`~fm_spark_tpu_torch.data.DedupAuxBatches`). The parameters
    start from ``spec.init`` seeded by ``config.seed`` and are updated in
    place. ``steps_per_call > 1`` runs the steps in groups through
    :func:`~fm_spark_tpu_torch.sparse.make_field_sparse_multistep`.
    ``logger`` (a ``MetricsLogger``) gets a loss line every
    ``config.log_every`` steps and at the last. ``stats``, when given, is
    filled with ``loss`` (per call), ``step_ms`` (per call: CUDA-event
    time on the card, host time on the CPU) and ``aux_ms`` (host time of
    each aux build).
    """
    from fm_spark_tpu_torch import resolve_device
    from fm_spark_tpu_torch.data import DedupAuxBatches, Prefetcher
    from fm_spark_tpu_torch.sparse import (fused_embed_plan,
                                           make_field_sparse_multistep)

    dev = resolve_device(device)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if config.fused_embed == "auto":
        family, reason = fused_embed_plan(spec, config)
        print(f"fused-embed: serving kernel family {family!r}" if family
              else f"fused-embed: plain torch path ({reason})",
              file=sys.stderr)
    mstep = make_field_sparse_multistep(spec, config, steps_per_call)
    params = spec.init(torch.Generator(device=dev).manual_seed(config.seed),
                       device=dev)
    aux_src = None
    if config.host_dedup:
        batches = aux_src = DedupAuxBatches(
            batches, cap=config.compact_cap, overflow=config.compact_overflow)
    pf = Prefetcher(batches, depth=prefetch, device=dev) if prefetch > 0 \
        else None
    on_card = dev.type == "cuda"
    losses, marks = [], []
    log_every = max(config.log_every, 1)
    since = 0
    try:
        i = 0
        while i < config.num_steps:
            m = min(steps_per_call, config.num_steps - i)
            group = [pf.next_batch() if pf else _batch_to(batches.next_batch(), dev)
                     for _ in range(m)]
            stacked = _stack(group)
            if on_card:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
            else:
                t0 = time.perf_counter()
            params, loss = mstep(params, i, m, *stacked)
            if on_card:
                t1.record()
                marks.append((t0, t1))
            else:
                marks.append(time.perf_counter() - t0)
            losses.append(loss)
            i += m
            since += m * stacked[2].shape[1]
            if logger is not None and (
                    i // log_every > (i - m) // log_every
                    or i >= config.num_steps):
                loss_f = float(loss)
                if loss_f == float("-inf"):
                    raise RuntimeError("compact_cap overflow poisoned the loss")
                logger.log(i, samples=since, loss=loss_f)
                since = 0
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
    return params
