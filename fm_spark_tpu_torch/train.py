"""Training of the port: the config dataclass, the learning-rate schedule,
the dense optimizers, the single-card field-sparse training loop and
evaluation (the port of ``TrainConfig``, ``make_optimizer`` and
``evaluate_params`` in ``fm_spark_tpu/train.py``, and of the single-chip
core of ``fm_spark_tpu/cli.py::_fit_field_sparse``).

The field tables' update rule is the reference's plain SGD,
``weights ← weights − lr_t · (grad + reg · weights)``, with
``lr_t = stepSize/√(t+1)`` or constant. The flat families' dense step
(FM, FFM, DeepFM; :func:`make_train_step`, driven by :class:`FMTrainer`)
and FieldDeepFM's MLP and bias take ``config.optimizer``
(:func:`make_optimizer`: optax's sgd, adam or adagrad, computed as optax
computes them, or FTRL-Proximal, ``optim``'s rule).
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import time

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters: field for field those of the JAX
    package's ``TrainConfig``, so a config reads the same in both. A
    lever is refused by every step that does not take it (the sharded
    knobs ``collective_dtype``, ``score_sharded`` and ``deep_sharded`` by
    the single-card steps; ``parallel/`` takes them)."""

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


#: FTRL-Proximal's beta in the dense form (the reference's ``optim.ftrl``
#: default, which its ``make_optimizer`` keeps).
FTRL_BETA = 1.0


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
    device, every count a 0-dim int32; FTRL's ``z`` and ``n`` float32 and
    shaped like the params), :meth:`update` advances it and returns the
    updates, which :func:`apply_updates` adds to the params. Nothing is
    read on the host, so a captured step may run it: the learning rate and
    the bias corrections are computed on the device from the counts."""

    def __init__(self, name: str, config: TrainConfig):
        self.name = name
        self._config = config
        # FTRL has no schedule: an lr_schedule beside it is ignored.
        self._lr_at = None if name == "ftrl" else _lr_at_tensor(config)

    def init(self, params) -> dict:
        from fm_spark_tpu_torch.graphs import _leaves

        dev = _leaves(params)[0].device
        state = {}
        if self.name == "ftrl":
            # z seeded so the closed form gives back the params; no
            # schedule: (beta + √n)/alpha is FTRL's own, per coordinate.
            from fm_spark_tpu_torch.optim import ftrl_init_z

            alpha = float(self._config.learning_rate)
            state["z"] = _tree_map(
                lambda p: ftrl_init_z(p, alpha, FTRL_BETA), params)
            state["n"] = _tree_map(
                lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                      device=p.device), params)
            return state
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

    def _ftrl_update(self, grads, state, params):
        """FTRL's deltas, optax's convention: ``(new − p)`` in float32 cast
        to the gradient's dtype, which :func:`apply_updates` adds to ``p``;
        ``z`` and ``n`` advanced in place. The ``reg_*`` triple is FTRL's
        proximal l2 per group (``w0`` → ``reg_bias``, ``w`` →
        ``reg_linear``, ``v``/``mlp`` → ``reg_factors``); an unknown group
        raises."""
        from fm_spark_tpu_torch.optim import ftrl_rows

        if params is None:
            raise ValueError("ftrl is a proximal rule; it needs params")
        cfg = self._config
        alpha = float(cfg.learning_rate)
        l2_by_group = {"w0": cfg.reg_bias, "w": cfg.reg_linear,
                       "v": cfg.reg_factors, "mlp": cfg.reg_factors}
        l2s = {k: float(v) + 0.0 for k, v in l2_by_group.items()}
        out = {}
        for key, g in grads.items():
            if key not in l2_by_group:
                raise ValueError(f"no FTRL l2 group for param {key!r} "
                                 f"(know {sorted(l2_by_group)})")
            l2 = l2s[key]

            def one(g, z, n, p, l2=l2):
                new, z_new, n_new = ftrl_rows(p, z, n, g, alpha, FTRL_BETA,
                                              0.0, l2)
                z.copy_(z_new)
                n.copy_(n_new)
                return (new - p.float()).to(g.dtype)

            out[key] = _tree_map(one, g, state["z"][key], state["n"][key],
                                 params[key])
        return out

    def update(self, grads, state, params=None):
        """The updates of ``grads`` (float32, the tree of the params),
        with ``state`` advanced in place, in optax's order of operations.
        FTRL needs ``params`` (its update is proximal); the others ignore
        them."""
        if self.name == "ftrl":
            return self._ftrl_update(grads, state, params)
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
            # optax's scale casts the learning rate to each update's dtype.
            updates = _tree_map(lambda g: _scaled(neg_lr, g), grads)
        if "schedule_count" in state:
            _advance(state["schedule_count"])
        return updates


def _scaled(factor, g: torch.Tensor) -> torch.Tensor:
    """``factor · g`` in ``g``'s dtype, ``factor`` (a Python float or a
    0-dim float32 tensor) first rounded to that dtype, as JAX treats the
    scale of a bf16 update."""
    if isinstance(factor, float):
        from fm_spark_tpu_torch.ops.fused_bwd import round_to

        factor = round_to(factor, g.dtype)
    return factor * g


def apply_updates(params, updates) -> None:
    """``optax.apply_updates`` in place: ``p ← p + u``."""
    _tree_map(lambda p, u: p.add_(u), params, updates)


def make_optimizer(config: TrainConfig) -> Optimizer:
    """The dense optimizer of ``config`` (the reference's
    ``train.make_optimizer``): ``sgd``, ``adam`` or ``adagrad`` with the
    ``constant`` or ``inv_sqrt`` schedule, as optax 0.2.6 computes them
    (Adam: b1 0.9, b2 0.999, eps 1e-8; AdaGrad: accumulators from 0.1,
    eps 1e-7), or ``ftrl``: FTRL-Proximal (``optim.ftrl_rows``, alpha the
    learning rate, beta 1, l1 0) with the ``reg_*`` triple as its
    proximal l2 per group and no schedule (its ``(beta + √n)/alpha`` is
    one per coordinate), the state ``{"z", "n"}`` shaped like the
    params."""
    if config.optimizer not in ("sgd", "adam", "adagrad", "ftrl"):
        raise ValueError(f"unknown optimizer {config.optimizer!r}")
    return Optimizer(config.optimizer, config)


def _batch_to(batch, device):
    """A batch of numpy arrays or tensors (nested tuples allowed) as
    tensors on ``device``."""
    from fm_spark_tpu_torch.data.pipeline import host_tensor

    if isinstance(batch, (tuple, list)):
        return tuple(_batch_to(b, device) for b in batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(device)
    return host_tensor(batch).to(device)


def ingest_counts(source) -> dict | None:
    """``{"bad_records", "good_records", "dead_letter"}`` of a raw-text
    source (``data/stream``; a wrapper passes its ``guard`` through), or
    None for a source without a guard. The counts are those of the cursor
    as of the last CONSUMED batch (a prefetcher's read-ahead is not
    counted), so a resumed run ends on the uninterrupted run's counts."""
    guard = getattr(source, "guard", None)
    if guard is None:
        return None
    state = source.state() if hasattr(source, "state") else {}
    return {"bad_records": int(state.get("bad", guard.n_bad)),
            "good_records": int(state.get("ok", guard.n_ok)),
            "dead_letter": guard.dead_letter_path}


def _log_ingest(logger, step: int, counts) -> None:
    """The reference's quarantine summary line of :func:`ingest_counts`:
    logged when the source's guard quarantined anything."""
    if logger is not None and counts is not None and counts["bad_records"]:
        logger.log(step, bad_records=counts["bad_records"],
                   good_records=counts["good_records"])


def make_eval_step(spec):
    """The metrics-accumulation step: ``step(params, mstate, ids, vals,
    labels, weights) → mstate``. RMSE is computed from the model's
    predictions (the regression clip applied, as ``FMModel.predict``),
    AUC and logloss from the raw scores. Scores go through
    ``spec.scores`` (for a FieldFM the fused forward kernel on CUDA)."""
    from fm_spark_tpu_torch.models import predict_from_scores
    from fm_spark_tpu_torch.ops import losses
    from fm_spark_tpu_torch.utils import metrics as metrics_lib

    per_example_loss = losses.loss_fn(spec.loss)

    @torch.no_grad()
    def step(params, mstate, ids, vals, labels, weights):
        scores = spec.scores(params, ids, vals)
        per = per_example_loss(scores, labels)
        preds = predict_from_scores(spec, scores)
        return metrics_lib.update_metrics(mstate, scores, labels, per,
                                          weights, predictions=preds)

    return step


def evaluate_params(spec, params, batches, max_batches: int | None = None,
                    step=None) -> dict:
    """Stream ``(ids, vals, labels, weights)`` batches (numpy, or tensors)
    through the model on its params' device → finalized metrics (``auc``,
    ``logloss``, ``rmse``, ``count``) as floats, over at most
    ``max_batches`` batches. ``step`` is a :func:`make_eval_step` to reuse
    (the trainer's periodic eval passes its own)."""
    from fm_spark_tpu_torch.utils import metrics as metrics_lib

    if step is None:
        step = make_eval_step(spec)
    dev = params["w0"].device
    mstate = metrics_lib.init_metrics(device=dev)
    for i, batch in enumerate(batches):
        if max_batches is not None and i >= max_batches:
            break
        mstate = step(params, mstate, *_batch_to(tuple(batch)[:4], dev))
    return metrics_lib.finalize_metrics(mstate)


def _group_reg(config: TrainConfig):
    """Per-group L2 added to the gradient, MLlib's squared-L2 updater
    (the reference's ``_group_reg``): ``w0`` → ``reg_bias``, ``w`` →
    ``reg_linear``, ``v`` and ``mlp`` → ``reg_factors``; a FieldFM ``vw``
    table takes a per-column vector (factor columns ``reg_factors``, the
    last column ``reg_linear``). An unknown group raises: a parameter
    silently left unregularized is worse than a crash. Each reg is
    rounded to the gradient's dtype first, as JAX treats a Python float
    beside an array (the ``vw`` vector is float32, as the reference's)."""
    from fm_spark_tpu_torch.ops.fused_bwd import round_to

    if config.optimizer == "ftrl":
        # FTRL carries L2 in its proximal closed form: (g + λw) folded
        # into n would corrupt the per-coordinate schedule.
        return lambda grads, params: grads
    known = {"w0": config.reg_bias, "w": config.reg_linear,
             "v": config.reg_factors, "mlp": config.reg_factors}

    def one(key, g, p):
        if key == "vw":
            if config.reg_factors == 0.0 and config.reg_linear == 0.0:
                return g
            w = p.shape[-1]
            col = torch.arange(w, device=p.device)
            # Filled on the device (a captured step copies nothing in).
            r = torch.where(col == w - 1,
                            round_to(config.reg_linear, torch.float32),
                            round_to(config.reg_factors, torch.float32)
                            ).to(torch.float32)
            return g + r * p.to(g.dtype)
        if key not in known:
            raise ValueError(f"no regularization group for param {key!r}")
        r = known[key]
        if r == 0.0:
            return g
        return g + round_to(r, g.dtype) * p.to(g.dtype)

    def add_reg(grads, params):
        return {key: _tree_map(lambda g, p, key=key: one(key, g, p),
                               g, params[key])
                for key, g in grads.items()}

    return add_reg


def _global_norm(tree) -> torch.Tensor:
    """``optax.global_norm``: the square root of the sum of every leaf's
    sum of squares (each leaf's sum in its dtype, bf16 accumulated in
    float32 and rounded once; the leaves added in float32 in key order)."""
    from fm_spark_tpu_torch.graphs import _leaves
    from fm_spark_tpu_torch.ops.fm import sum_upcast

    total = None
    for g in _leaves(tree):
        sq = sum_upcast(g * g).float()
        total = sq if total is None else total + sq
    return torch.sqrt(total)


#: Rows past the table in the dense step's gradient buffers, which the
#: dedup's unused segment slots write to.
_SPARE_ROWS = 4096


def _summed_rows(ids, n: int, lanes, widths):
    """Each distinct id's ``lanes`` (``[B·nnz, Σ widths]`` float32) summed
    once, as dense float32 gradients ``[n, w]`` (one per width, zero on
    the rows no id touches), JAX's scatter-add of the lanes.

    The sums are the device dedup's (``ops.scatter._dedup``: a stable sort
    and kernel A at cap = B·nnz on the card, no atomics, so a repeat gives
    the same bits), each total written into its row of a zero buffer whose
    :data:`_SPARE_ROWS` rows past the table take what JAX's scatter drops
    (ids outside ``[-n, n)``) and the unused segment slots."""
    from fm_spark_tpu_torch.ops import fm as fm_ops
    from fm_spark_tpu_torch.ops import scatter as scatter_lib

    dev = lanes.device
    wid = fm_ops.write_index(ids, n).reshape(-1)
    d = scatter_lib._dedup(wid, lanes)
    slot = torch.arange(wid.shape[0], device=dev)
    # A slot past the segment count holds no total: it writes to one of
    # the spare rows past the table, spread over them (the stores of every
    # unused slot to one row would queue behind each other).
    tgt = torch.where(slot < d.count, d.useg.long(), n + slot % _SPARE_ROWS)
    out, col = [], 0
    for w in widths:
        buf = torch.zeros(n + _SPARE_ROWS, w, dtype=torch.float32,
                          device=dev).index_copy_(0, tgt,
                                                  d.totals[:, col:col + w])
        out.append(buf[:n])
        col += w
    return out


def _check_slots(spec, ids):
    if ids.shape[1] != spec.num_fields:
        raise ValueError(
            f"batch has nnz={ids.shape[1]} slots but the spec was sized for "
            f"num_fields={spec.num_fields}")


def _dense_grads_fn(spec):
    """The loss and the gradient of a flat family's parameters, written
    out (the reference takes ``jax.value_and_grad`` of ``spec.scores``):
    ``fn(params, ids, vals, labels, weights, wsum=None) → (loss, grads)``
    (``wsum``: the loss's divisor, by default ``max(Σ weights, 1)``), the table
    gradients in the table's dtype, ``w0``'s and the MLP's float32, a
    term gated off (``use_bias``/``use_linear`` False) a zero gradient.

    Each family takes the gradient with respect to the gathered rows, and
    :func:`_summed_rows` sums each id's ``[row gradient | linear
    gradient]`` lanes once:

    - ``FMSpec``: ``∂ŷ/∂v[i] = x_i·(s − v[i]·x_i)``, ``∂ŷ/∂w[i] = x_i``;
    - ``FFMSpec`` (nnz = F, slot ``i`` in field ``i``): the rows ``v[ids]``
      ``[B, F, F·k]`` are the ffm_sel kernels' layout; the scores'
      pairwise term is ``ffm_sel_scores`` and the row gradient exactly
      ``ffm_sel_bwd`` (the kernels on the card, their plain versions on
      the CPU), lanes ``F·k + 1`` wide;
    - ``DeepFMSpec``: the FM part ``x_i·(ds·(s − xv_i) + g_h_i)``, with
      ``g_h`` the MLP's input gradient (``sparse._mlp_backward``, its
      products ``torch.matmul``), and the MLP's own gradients.

    The field families (``FieldFMSpec``, ``FieldFFMSpec``,
    ``FieldDeepFMSpec``; the reference's ``--strategy single|dp`` on a
    field config) take :func:`_field_dense_grads`: the same rules per
    field, each field's lanes summed once per id in its own table."""
    from fm_spark_tpu_torch.models.deepfm import DeepFMSpec
    from fm_spark_tpu_torch.models.ffm import FFMSpec
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec
    from fm_spark_tpu_torch.models.field_fm import FieldFMSpec
    from fm_spark_tpu_torch.models.fm import FMSpec
    from fm_spark_tpu_torch.ops import ffm_sel
    from fm_spark_tpu_torch.ops import fm as fm_ops
    from fm_spark_tpu_torch.sparse import (_loss_and_grad_fn, _mlp_backward,
                                           _mlp_forward)

    family = type(spec)
    if family in (FieldFMSpec, FieldFFMSpec, FieldDeepFMSpec):
        return _field_dense_grads(spec)
    if family not in (FMSpec, FFMSpec, DeepFMSpec):
        raise ValueError(
            f"no dense train step for {family.__name__}; the port's takes "
            "FMSpec, FFMSpec, DeepFMSpec and the field families")
    loss_and_grad = _loss_and_grad_fn(spec.loss)
    cd, pd = spec.cdtype, spec.pdtype
    sum_upcast = fm_ops.sum_upcast

    def linear_and_bias(params, gidx, vals_c, zero):
        linear = (sum_upcast(params["w"][gidx].to(cd) * vals_c, 1)
                  if spec.use_linear else zero)
        return linear, (params["w0"].to(cd) if spec.use_bias else zero)

    def grads(params, ids, vals, labels, weights, wsum=None):
        v = params["v"]
        n = v.shape[0]
        dev = v.device
        b = ids.shape[0]
        gidx = fm_ops.gather_index(ids, n)                 # [B, nnz]
        vals_c = vals.to(cd)
        zero = torch.zeros((), dtype=cd, device=dev)
        linear, bias = linear_and_bias(params, gidx, vals_c, zero)
        extra = {}
        if family is FFMSpec:
            _check_slots(spec, ids)
            fk = v.shape[1] * v.shape[2]
            rows = v[gidx].to(cd).reshape(b, ids.shape[1], fk)
            inter = 0.5 * ffm_sel.ffm_sel_scores(rows, vals_c)
            loss, dscores = loss_and_grad(bias + linear + inter, labels,
                                          weights, wsum)
            g_rows = ffm_sel.ffm_sel_bwd(rows, vals_c, dscores)
        else:
            if family is DeepFMSpec:
                _check_slots(spec, ids)
            xv = v[gidx].to(cd) * vals_c[..., None]        # [B, nnz, k]
            s = sum_upcast(xv, 1)                          # [B, k]
            inter = 0.5 * (sum_upcast(s * s, 1)
                           - sum_upcast(xv * xv, (1, 2)))
            if family is FMSpec:
                loss, dscores = loss_and_grad(bias + linear + inter, labels,
                                              weights, wsum)
                g_rows = (dscores[:, None, None] * vals_c[..., None]
                          * (s[:, None, :] - xv))
            else:
                # DeepFM's order: ((interaction + linear) + bias) + deep.
                kernels, ins, pres, deep = _mlp_forward(
                    spec, params["mlp"], xv.reshape(b, -1))
                loss, dscores = loss_and_grad(inter + linear + bias + deep,
                                              labels, weights, wsum)
                g_mlp, g_h = _mlp_backward(spec, kernels, ins, pres, dscores)
                g_xv = (dscores[:, None, None] * (s[:, None, :] - xv)
                        + g_h.reshape(xv.shape))
                g_rows = g_xv * vals_c[..., None]
                extra["mlp"] = g_mlp
        g_w = (dscores[:, None] * vals_c if spec.use_linear
               else torch.zeros_like(vals_c))
        m = ids.numel()
        width = v[0].numel()
        g_v, g_w = _summed_rows(ids, n, torch.cat(
            [g_rows.float().reshape(m, width), g_w.float().reshape(m, 1)],
            dim=1), (width, 1))
        g_w0 = (sum_upcast(dscores).float() if spec.use_bias
                else torch.zeros((), dtype=torch.float32, device=dev))
        return loss, {"w0": g_w0, "w": g_w.reshape(n).to(pd),
                      "v": g_v.reshape(v.shape).to(pd), **extra}

    return grads


def _field_dense_grads(spec):
    """:func:`_dense_grads_fn` of a field family: ``fn(params, ids, vals,
    labels, weights) → (loss, grads)`` over field-local ids ``[B, F]``,
    the gradient of each field's table in its layout and dtype (``vw``
    fused, ``v``/``w`` unfused, transposed under ``table_layout='col'``).

    Per field ``f`` the lanes are ``[∂L/∂rows_f | ∂L/∂w_f]`` (FieldFM
    ``ds·x_f·(s − xv_f)``; FieldFFM the ``ffm_sel_bwd`` rows of the
    stacked ``[B, F, F·k]`` rows, the kernel on the card; FieldDeepFM
    with the head's pullback ``g_h_f·x_f`` added, ``sparse._mlp_backward``),
    summed once per id by the device dedup (:func:`_summed_rows`: the sort
    and kernel A at cap = B on the card) into a float32 buffer of the
    field's rows."""
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
    from fm_spark_tpu_torch.models.field_ffm import FieldFFMSpec
    from fm_spark_tpu_torch.ops import ffm_sel
    from fm_spark_tpu_torch.ops import fm as fm_ops
    from fm_spark_tpu_torch.sparse import (_loss_and_grad_fn, _mlp_backward,
                                           _mlp_forward)

    loss_and_grad = _loss_and_grad_fn(spec.loss)
    cd, pd = spec.cdtype, spec.pdtype
    nf, k = spec.num_fields, spec.rank
    ffm = isinstance(spec, FieldFFMSpec)
    deep = isinstance(spec, FieldDeepFMSpec)
    fused = getattr(spec, "fused_linear", True)
    col = getattr(spec, "table_layout", "row") == "col"
    width = nf * k if ffm else k
    sum_upcast, seq_sum = fm_ops.sum_upcast, fm_ops.seq_sum

    def gather(t, idx):
        return (t[:, idx].t() if col else t[idx]).to(cd)

    def grads(params, ids, vals, labels, weights, wsum=None):
        _check_slots(spec, ids)
        n = spec.bucket
        dev = params["w0"].device
        vals_c = vals.to(cd)
        gidx = [fm_ops.gather_index(ids[:, f], n) for f in range(nf)]
        tables = params["vw"] if fused else params["v"]
        rows = [gather(tables[f], gidx[f]) for f in range(nf)]
        if fused:
            lins = [r[:, width] for r in rows]
        elif spec.use_linear:
            lins = [params["w"][f][gidx[f]].to(cd) for f in range(nf)]
        score = None
        extra = {}
        if ffm:
            rstk = torch.stack([r[:, :width] for r in rows], dim=1)
            score = 0.5 * ffm_sel.ffm_sel_scores(rstk, vals_c)
        else:
            xvs = [r[:, :k] * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
            s = seq_sum(xvs)
            sum_sq = seq_sum([sum_upcast(x * x, 1) for x in xvs])
            score = 0.5 * (sum_upcast(s * s, 1) - sum_sq)
        if spec.use_linear:
            score = score + seq_sum([l * vals_c[:, f]
                                     for f, l in enumerate(lins)])
        if spec.use_bias:
            score = score + params["w0"].to(cd)
        if deep:
            kernels, ins, pres, deep_out = _mlp_forward(
                spec, params["mlp"], torch.cat(xvs, dim=1))
            score = score + deep_out
        loss, dscores = loss_and_grad(score, labels, weights, wsum)
        if ffm:
            g_rows = ffm_sel.ffm_sel_bwd(rstk, vals_c, dscores)
            g_rows = [g_rows[:, f] for f in range(nf)]
        else:
            g_rows = [dscores[:, None] * vals_c[:, f:f + 1] * (s - xvs[f])
                      for f in range(nf)]
            if deep:
                g_mlp, g_h = _mlp_backward(spec, kernels, ins, pres, dscores)
                g_rows = [g + g_h[:, f * k:(f + 1) * k] * vals_c[:, f:f + 1]
                          for f, g in enumerate(g_rows)]
                extra["mlp"] = g_mlp
        g_tab, g_lin = [], []
        for f in range(nf):
            g_l = (dscores * vals_c[:, f] if spec.use_linear
                   else torch.zeros_like(dscores))
            lanes = torch.cat([g_rows[f].float(), g_l.float()[:, None]],
                              dim=1)
            ws = (width + 1,) if fused else (width, 1)
            out = _summed_rows(ids[:, f:f + 1], n, lanes, ws)
            g = out[0].to(pd)
            g_tab.append(g.t().contiguous() if col else g)
            if not fused:
                g_lin.append(out[1].reshape(n).to(pd))
        g_w0 = (sum_upcast(dscores).float() if spec.use_bias
                else torch.zeros((), dtype=torch.float32, device=dev))
        out = {"w0": g_w0, **extra}
        if fused:
            out["vw"] = g_tab
        else:
            out["v"] = g_tab
            out["w"] = g_lin
        return loss, out

    return grads


def _dense_body(spec, config: TrainConfig, optimizer):
    """One dense step of a flat family (the computation of the reference's
    ``make_train_step``): ``body(params, opt_state, ids, vals, labels,
    weights) → (loss, grad_norm)``, updating ``params`` and ``opt_state``
    in place. The gradient is :func:`_dense_grads_fn`'s (written out, each
    id summed once by the device dedup), then ``_group_reg``'s dense L2
    and ``config.optimizer`` over the whole table, in place, as XLA
    updates it: every row decays every step, touched or not."""
    grads_fn = _dense_grads_fn(spec)
    add_reg = _group_reg(config)

    @torch.no_grad()
    def body(params, opt_state, ids, vals, labels, weights):
        loss, grads = grads_fn(params, ids, vals, labels, weights)
        grads = add_reg(grads, params)
        norm = _global_norm(grads)
        apply_updates(params, optimizer.update(grads, opt_state, params))
        return loss.float(), norm

    return body


def make_train_step(spec, config: TrainConfig, optimizer=None):
    """The single-device dense train step of a flat family (``FMSpec``,
    ``FFMSpec``, ``DeepFMSpec``; the reference's ``make_train_step``):
    ``step(params, opt_state, ids, vals, labels, weights) → (params,
    opt_state, {"loss", "grad_norm"})``, the params and the optimizer's
    state updated in place (the counterpart of their donation), the
    metrics 0-dim float32 tensors on the params' device. ``optimizer``
    defaults to :func:`make_optimizer` of ``config``.

    On the card the body (:func:`_dense_body`) is captured as one CUDA
    graph over ``{"params", "opt"}`` (:class:`~fm_spark_tpu_torch.graphs
    .CapturedStep`, the counterpart of ``jax.jit``): the schedule's count
    stays on the card, and other params or state tensors capture anew. On
    the CPU it runs the eager body. The field families take the same step
    through :func:`_field_dense_grads` (the reference's ``--strategy
    single|dp`` on a field config)."""
    from fm_spark_tpu_torch import graphs
    from fm_spark_tpu_torch.sparse import (_reject_collective_dtype,
                                           _reject_deep_sharded,
                                           _reject_embed_tier_require,
                                           _reject_fused_embed_require,
                                           _reject_host_aux,
                                           _reject_score_sharded,
                                           _reject_sel_blocked)

    what = "the dense single-device train step"
    _reject_host_aux(config, "the dense optax train step")
    _reject_collective_dtype(config, what)
    _reject_score_sharded(config, what)
    _reject_deep_sharded(config, what)
    _reject_sel_blocked(config, what)
    _reject_fused_embed_require(config, what)
    _reject_embed_tier_require(config, what)
    body = _dense_body(spec, config, optimizer or make_optimizer(config))

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
    return step


class FMTrainer:
    """End-to-end trainer of a flat family (FM, FFM, DeepFM) on one
    device, the rebuild's ``FMWithSGD`` (the port of the reference's
    ``FMTrainer``)::

        trainer = FMTrainer(spec, TrainConfig(num_steps=1000, ...))
        params = trainer.fit(train_batches)
        metrics = trainer.evaluate(eval_batches)

    The params start from ``spec.init`` seeded by ``config.seed`` on
    ``device`` (the card unless ``device="cpu"``); copy other values into
    them in place before :meth:`fit` to start elsewhere (the captured
    step binds their storage). Each step is :func:`make_train_step`'s.
    """

    def __init__(self, spec, config: TrainConfig, device=None,
                 n_chips: int = 1):
        from fm_spark_tpu_torch import resolve_device
        from fm_spark_tpu_torch.utils.logging import MetricsLogger

        self.spec = spec
        self.config = config
        self.device = resolve_device(device)
        self.optimizer = make_optimizer(config)
        self._train_step = make_train_step(spec, config, self.optimizer)
        self._eval_step = make_eval_step(spec)
        self.params = spec.init(
            torch.Generator(device=self.device).manual_seed(config.seed),
            device=self.device)
        self.opt_state = self.optimizer.init(self.params)
        self.step_count = 0
        self.logger = MetricsLogger(path=config.metrics_path,
                                    n_chips=n_chips)
        self.loss_history: list[float] = []
        self.last_eval: dict | None = None   # the newest in-fit eval
        self.resumed: dict | None = None     # the last fit's restore
        self.ingest: dict | None = None      # the last fit's ingest_counts

    def fit(self, batches, num_steps: int | None = None, checkpointer=None,
            preemption_guard=None, eval_batches=None, prefetch: int = 0,
            supervisor=None, elastic=None, divergence_guard=None):
        """Run the training loop over ``batches``, which yields ``(ids,
        vals, labels, weights)`` (numpy arrays or tensors), and return the
        params.

        With a :class:`~fm_spark_tpu_torch.checkpoint.Checkpointer`,
        ``num_steps`` is a GLOBAL step target: the run resumes from the
        newest verified step (params, optimizer state with the schedule's
        count, the step, ``loss_history``, and the cursor of ``batches``,
        which must have ``state()``/``restore()``), saves on the
        checkpointer's cadence and at the end; a ``preemption_guard`` that
        is set flushes a save and returns. Without one, ``fit`` runs
        ``num_steps`` more steps (default ``config.num_steps``).

        ``eval_batches`` (a zero-argument callable returning a finite
        batch iterable) is evaluated every ``config.eval_every`` steps and
        after the last, logged with an ``eval_`` prefix. ``prefetch > 0``
        moves batches to the device in a background
        :class:`~fm_spark_tpu_torch.data.Prefetcher` of that depth, made
        after the resume so it reads from the restored cursor. A raw-text
        stream (``data/stream``) is a source like any other; when its
        guard quarantined anything, a ``bad_records``/``good_records``
        line is logged at the end (``self.ingest``, :func:`ingest_counts`).
        ``divergence_guard`` (a :class:`~fm_spark_tpu_torch.resilience
        .divergence.DivergenceGuard`, which needs the checkpointer) checks
        every step's loss (one fetch per step) before it can be logged or
        saved; on a detection the newest verified step is restored into
        the params and optimizer state in place (the captured step stays
        bound to them; a chain without a step re-initialises them from the
        seed and rewinds ``batches``), and the run continues toward the
        reduced target ``note_rollback`` returns: a numeric blowup costs
        one checkpoint window.

        ``supervisor`` (a :class:`~fm_spark_tpu_torch.resilience
        .Supervisor`, which needs the checkpointer) turns a device loss
        (``resilience.is_device_loss``) into a recovery: the loss is
        journaled, the supervisor probes and backs off (raising
        :class:`~fm_spark_tpu_torch.resilience.CircuitOpen` after its
        threshold of consecutive losses), and the newest verified step is
        restored in place as a rollback's is (an empty chain re-initialises
        from the seed and rewinds ``batches``), so the run ends bit for
        bit where the uninterrupted one does; the recovery's wall clock
        is a pause of the logger's window. Other errors propagate.
        ``elastic`` (an :class:`~fm_spark_tpu_torch.resilience
        .ElasticController`, which needs the supervisor): when the breaker
        opens on a PERMANENT fault, the controller sheds capacity instead
        (journaled), the logger's per-chip rate re-normalizes where it
        tracked the controller's chips, the breaker re-arms and the run
        resumes; a mixed-mode circuit open still raises.
        """
        if supervisor is not None and checkpointer is None:
            raise ValueError(
                "supervised training needs a checkpointer: device-loss "
                "recovery without committed state to resume from would "
                "silently restart the run from scratch")
        if elastic is not None and supervisor is None:
            raise ValueError(
                "elastic degraded mode needs a supervisor: the shrink "
                "trigger is the supervisor's permanent-fault verdict")
        if divergence_guard is not None and checkpointer is None:
            raise ValueError(
                "divergence-guard training needs a checkpointer: "
                "rollback without committed good state to restore would "
                "silently restart the run from scratch")
        from fm_spark_tpu_torch.data import wrap_prefetch
        from fm_spark_tpu_torch.resilience.divergence import \
            DivergenceDetected

        total = num_steps if num_steps is not None else self.config.num_steps
        if checkpointer is not None and not (
                hasattr(batches, "state") and hasattr(batches, "restore")):
            raise ValueError(
                "checkpointed training needs a resumable batch source "
                "with state()/restore() (e.g. data.Batches); a plain "
                "iterator would silently replay data after resume")
        # A retry or rollback with no step in the chain yet rewinds the
        # source to its pre-run cursor: at the top of the next pass, once
        # the prefetcher, which reads the source, is closed.
        initial_cursor = (batches.state() if checkpointer is not None
                          else None)
        rewind = False
        while True:
            if rewind:
                self._reinit()
                batches.restore(initial_cursor)
                rewind = False
            start = 0
            if checkpointer is not None:
                start, self.resumed, extra = _resume(
                    checkpointer, self.params, self.opt_state, batches)
                if start:
                    self.step_count = start
                    self.loss_history = list(
                        (extra or {}).get("loss_history", []))
            source, close_prefetch = wrap_prefetch(batches, prefetch,
                                                   device=self.device)

            def save(force: bool = False) -> None:
                if checkpointer is None:
                    return
                if not force and not checkpointer.due(self.step_count):
                    return
                checkpointer.save(self.step_count, self.params,
                                  source.state(),
                                  {"loss_history": list(self.loss_history)},
                                  force=force, opt_state=self.opt_state)
                if force:
                    checkpointer.wait()
                if supervisor is not None:
                    # A committed step is real progress: the breaker
                    # counts CONSECUTIVE losses, never lifetime ones.
                    supervisor.note_success("train")

            try:
                params = self._fit_loop(source, start, total,
                                        preemption_guard, eval_batches, save,
                                        divergence_guard)
                if supervisor is not None:
                    supervisor.note_success("train")
                self.ingest = ingest_counts(source)
                _log_ingest(self.logger, self.step_count, self.ingest)
                return params
            except DivergenceDetected as e:
                # Stop just short of the diverging step: a deterministic
                # pipeline would replay the same poison. note_rollback
                # re-raises once its budget is spent.
                self._join_writer(checkpointer, supervisor, elastic)
                restored = checkpointer.last_good_step() or 0
                total = min(total, divergence_guard.note_rollback(
                    e, restored))
                rewind = checkpointer.latest_step() is None
            except Exception as e:  # noqa: BLE001 — classified below
                from fm_spark_tpu_torch.resilience import is_device_loss

                if supervisor is None or not is_device_loss(e):
                    raise
                self._recover(e, supervisor, elastic)
                self._join_writer(checkpointer, supervisor, elastic)
                rewind = checkpointer.latest_step() is None
            finally:
                close_prefetch()

    def _recover(self, exc, supervisor, elastic) -> None:
        """One device loss under a supervisor: journal, probe and back off
        (``CircuitOpen`` at the threshold, unless a permanent verdict lets
        ``elastic`` shed capacity); the loop then resumes in place."""
        from fm_spark_tpu_torch.resilience import CircuitOpen

        t0 = time.perf_counter()
        try:
            supervisor.recover("train", exc)
        except CircuitOpen:
            if (elastic is None or not supervisor.permanent()
                    or not elastic.can_shrink()):
                raise
            prev_chips = elastic.n_chips
            elastic.shrink("train")
            # Re-normalize only a logger that tracked the controller's
            # chips: a one-card trainer under a fleet-wide controller
            # keeps its one-card rate.
            if self.logger._n_chips == prev_chips:
                self.logger.set_n_chips(elastic.n_chips)
            supervisor.reset("train")
        self.logger.add_pause(time.perf_counter() - t0)

    def _join_writer(self, checkpointer, supervisor, elastic) -> None:
        """Join the save in flight before a recovery restores (the step
        it commits is the newest to restore). Its file write runs in the
        background, so a device loss inside its commit window surfaces
        here, after the loss that started this recovery: under a
        supervisor it is recovered from like any other (one more failure
        on the breaker); anything else propagates."""
        from fm_spark_tpu_torch.resilience import is_device_loss

        try:
            checkpointer.wait()
        except Exception as e:  # noqa: BLE001 — classified below
            if supervisor is None or not is_device_loss(e):
                raise
            self._recover(e, supervisor, elastic)

    def _reinit(self) -> None:
        """The params and optimizer state back at ``spec.init`` of the
        seed, in place (a rollback with no step in the chain)."""
        from fm_spark_tpu_torch.checkpoint import copy_into

        fresh = self.spec.init(
            torch.Generator(device=self.device).manual_seed(self.config.seed),
            device=self.device)
        copy_into(self.params, fresh)
        copy_into(self.opt_state, self.optimizer.init(fresh))
        self.step_count = 0
        self.loss_history = []

    def _fit_loop(self, batches, start, total, preemption_guard,
                  eval_batches, save, divergence_guard=None):
        from fm_spark_tpu_torch import obs
        from fm_spark_tpu_torch.obs import introspect
        from fm_spark_tpu_torch.resilience import faults, watchdog

        it = iter(batches)
        log_every = max(self.config.log_every, 1)
        eval_every = self.config.eval_every
        since = 0
        # The planes, latched once: an unobserved run pays one check per
        # step. Step time is a log window's mean on the host clock, read
        # after the window's loss fetch (the fence: every step of the
        # window has run), never inside the captured step; the first
        # step of a fit (kernel builds, the capture) opens no window.
        obs_on = obs.enabled()
        hist_step = obs.histogram("step_time_ms") if obs_on else None
        win = None
        first = True
        for step_i in range(start, total):
            if preemption_guard is not None and preemption_guard.should_stop:
                save(force=True)
                return self.params
            # The step's host-observable window (the fault point, the
            # batch fetch where a stalled producer hangs, the dispatch)
            # runs under the step_window deadline, but for the first
            # step, which carries the builds and the capture.
            with (watchdog.phase("step_window") if not first
                  else contextlib.nullcontext()):
                faults.inject("train_step")
                try:
                    batch = next(it)
                except StopIteration:
                    raise ValueError(
                        f"batch iterable exhausted after {step_i} of "
                        f"{total} steps; pass an epoch-cycling iterator "
                        "(data.Batches) or lower num_steps") from None
                ids, vals, labels, weights = _batch_to(tuple(batch)[:4],
                                                       self.device)
                _, _, m = self._train_step(self.params, self.opt_state, ids,
                                           vals, labels, weights)
            if obs_on:
                if first:
                    float(m["loss"])      # the first step's fence  # fmlint: disable=torch-host-sync -- the first step's fence: the window's clock starts once the first step (and its capture) has run
                    win = [time.time(), time.perf_counter(), 0]
                else:
                    win[2] += 1
            first = False
            self.step_count += 1
            since += 1
            if divergence_guard is not None:
                # Before the step's state can be logged, evaluated or
                # saved: a poisoned step must never reach the chain.
                divergence_guard.check(self.step_count, float(m["loss"]))  # fmlint: disable=torch-host-sync -- opt-in per-step sync: the divergence guard must see the loss before the step can be logged, evaluated or saved
            if self.step_count % log_every == 0 or step_i == total - 1:
                loss = float(m["loss"])  # fmlint: disable=torch-host-sync -- the window fence: the log-boundary loss fetch IS the measurement boundary
                self.loss_history.append(loss)
                self.logger.log(self.step_count,
                                samples=since * labels.shape[0], loss=loss,
                                grad_norm=float(m["grad_norm"]))  # fmlint: disable=torch-host-sync -- log-boundary fetch, already behind the window fence above
                since = 0
                if obs_on:
                    _close_window(win, hist_step, self.step_count, loss,
                                  self.device)
            introspect.tick()
            if eval_batches is not None and (
                    (eval_every > 0 and self.step_count % eval_every == 0)
                    or step_i == total - 1):
                t_eval = time.perf_counter()
                with obs.span("train/eval", step=self.step_count) as sp:
                    self.last_eval = self.evaluate(eval_batches())
                    sp.set(**{f"eval_{k}": round(float(v), 6)
                              for k, v in self.last_eval.items()})
                self.logger.log(self.step_count, **{
                    f"eval_{k}": v for k, v in self.last_eval.items()})
                self.logger.add_pause(time.perf_counter() - t_eval)
                if win is not None:
                    win[1] += time.perf_counter() - t_eval
            save()
        save(force=True)
        return self.params

    def evaluate(self, batches, max_batches: int | None = None) -> dict:
        """Metrics of the current params over ``batches`` through the
        trainer's eval step."""
        return evaluate_params(self.spec, self.params, batches, max_batches,
                               step=self._eval_step)


def _close_window(win, hist_step, step: int, loss: float, device) -> None:
    """End a log window ``[t_wall, t_perf, steps]`` just after its loss
    fetch (the fence): its mean step ms goes to the ``step_time_ms``
    histogram and the spike detector, a retroactive ``train/steps`` span
    records it, the card's memory watermarks ride the registry, and the
    next window starts."""
    from fm_spark_tpu_torch import obs
    from fm_spark_tpu_torch.obs import introspect

    dur = time.perf_counter() - win[1]
    if win[2]:
        mean_ms = dur * 1e3 / win[2]
        hist_step.observe(mean_ms)
        introspect.observe_step_time(mean_ms)
    obs.emit_span("train/steps", win[0], dur, steps=win[2], step=step,
                  loss=loss)
    obs.device_memory_snapshot(device if device.type == "cuda" else None)
    win[:] = [time.time(), time.perf_counter(), 0]


def _resume(checkpointer, params, opt_state, batches
            ) -> tuple[int, dict | None, dict | None]:
    """Restore the newest verified checkpoint into ``params`` and
    ``opt_state`` (in place, before any step is captured, so the graph
    binds the restored tensors: Adam's moments and counts included) and
    its cursor into ``batches``, the innermost source (under the aux
    wrapper and the prefetcher). Returns ``(start step, restore info, the
    step's extra)``, ``(0, None, None)`` on a fresh chain (the reference's
    ``cli._resume`` and ``checkpoint.resume_or_init``)."""
    from fm_spark_tpu_torch.checkpoint import copy_into

    t0 = time.perf_counter()
    restored = checkpointer.restore(params)
    if restored is None:
        return 0, None, None
    if restored["layout"] != "canonical":
        raise SystemExit(
            f"could not restore the checkpoint as canonical-layout — the "
            f"directory holds {restored['layout']}-layout steps (then: add "
            "--ckpt-sharded to resume it, or point --checkpoint-dir at a "
            "fresh directory)")
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
    return restored["step"], info, restored["extra"]


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
    :class:`~fm_spark_tpu_torch.data.PackedBatches`, a raw-text stream of
    ``data/stream`` or ``data/native_stream``); with ``host_dedup``
    the aux (compact at ``compact_cap > 0``, else the per-lane dedup aux)
    is built on the host in the prefetch thread
    (:class:`~fm_spark_tpu_torch.data.DedupAuxBatches`, which halves a
    batch past the cap under ``compact_overflow='split'``); with
    ``compact_device`` the step builds it. The parameters start from
    ``spec.init`` seeded by ``config.seed`` and are updated in place. The
    steps run one per call through
    :func:`~fm_spark_tpu_torch.sparse.make_field_sparse_sgd_step` (or its
    FieldFFM and FieldDeepFM twins), or in groups of ``steps_per_call > 1``
    (stacked on the producer thread by
    :class:`~fm_spark_tpu_torch.data.StackedBatches`, its ``total`` the
    steps left) through
    :func:`~fm_spark_tpu_torch.sparse.make_field_sparse_multistep`
    (or :func:`~fm_spark_tpu_torch.sparse.make_field_deepfm_multistep`): on the
    card always as captured CUDA graphs (one per group length, captured at
    its first call), as the reference's loop always runs its jitted step.
    ``logger`` (a ``MetricsLogger``; without one, a ``MetricsLogger`` on
    ``config.metrics_path`` when that is set) gets a loss line every
    ``config.log_every`` steps and at the last. Each call passes the
    ``train_step`` fault point first; with the obs plane on, each log
    window (closed by the log line's loss fetch) is a ``train/steps``
    span and a ``step_time_ms`` observation. Under ``compact_device``
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
    and bytes), ``opt_state`` (the optimizer's state at the end; ``{}``
    but for a FieldDeepFM) and ``ingest`` (:func:`ingest_counts` of the
    source, None without a guard; when it quarantined anything,
    ``logger`` gets the ``bad_records``/``good_records`` line).
    """
    from fm_spark_tpu_torch import resolve_device
    from fm_spark_tpu_torch.data import DedupAuxBatches, StackedBatches
    from fm_spark_tpu_torch.models.field_deepfm import FieldDeepFMSpec
    from fm_spark_tpu_torch.sparse import (fused_embed_plan,
                                           make_field_deepfm_multistep,
                                           make_field_deepfm_sparse_step,
                                           make_field_sparse_multistep,
                                           make_sgd_step)
    from fm_spark_tpu_torch.utils.logging import MetricsLogger

    dev = resolve_device(device)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if logger is None and config.metrics_path:
        logger = MetricsLogger(path=config.metrics_path)
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
    params = spec.init(torch.Generator(device=dev).manual_seed(config.seed),
                       device=dev)
    opt_state = step.init_opt_state(params) if deep else {}

    def run(i, m, batch):
        args = (i, *batch) if steps_per_call == 1 else (i, m, *batch)
        if deep:
            return {"loss": step(params, opt_state, *args)[2]}   # in place
        return {"loss": step(params, *args)[1]}

    start, resumed = 0, None
    if checkpointer is not None:
        start, resumed, _ = _resume(checkpointer, params, opt_state,
                                    batches)
    aux_src = None
    if config.host_dedup:
        batches = aux_src = DedupAuxBatches(
            batches, cap=config.compact_cap,
            overflow="split" if config.compact_overflow == "split"
            else "error")
    if steps_per_call > 1:
        # Stacked on the producer thread; ``total`` bounds what the
        # stacker reads, so the saved cursor stays exact.
        batches = StackedBatches(batches, steps_per_call,
                                 total=config.num_steps - start)

    def save(at, pipeline, force=False):
        checkpointer.save(at, params, pipeline, force=force,
                          opt_state=opt_state)

    out = fit_steps(config, batches, run, device=dev, start=start,
                    steps_per_call=steps_per_call, prefetch=prefetch,
                    logger=logger, evaluate=(
                        None if eval_source is None else
                        lambda: evaluate_params(spec, params, eval_source())),
                    checkpointer=checkpointer, save=save,
                    preemption_guard=preemption_guard)
    if stats is not None:
        stats.update(out, aux_ms=list(aux_src.aux_ms) if aux_src else [],
                     capture_s=list(step.captured.capture_s), start=start,
                     resumed=resumed, opt_state=opt_state,
                     saves=list(checkpointer.timings) if checkpointer
                     else [])
    return params


def fit_steps(config: TrainConfig, source, run, *, device, start: int = 0,
              steps_per_call: int = 1, prefetch: int = 0, logger=None,
              rows_scale: int = 1, evaluate=None, checkpointer=None,
              save=None, preemption_guard=None) -> dict:
    """The training loop the fused fits share (:func:`fit_field_sparse`,
    ``parallel.fit_field_sharded`` and ``parallel.fit_parallel``), from
    step ``start`` to ``config.num_steps``.

    ``source`` yields numpy or tensor batches (moved to ``device`` by a
    :class:`~fm_spark_tpu_torch.data.Prefetcher` of depth ``prefetch``,
    made here, after the caller's resume); ``run(i, m, batch)`` takes the
    ``m`` steps from step ``i`` in place and returns its metrics as
    tensors, ``"loss"`` among them. Each call passes the ``train_step``
    fault point first. ``logger`` gets every metric every
    ``config.log_every`` steps and at the last, with the samples since its
    previous line (a batch's rows times ``rows_scale``: the ranks that
    each fed as many); with the obs plane on, each log window (closed by
    the log line's loss fetch, the first call fenced so its builds and
    capture open none) is a ``train/steps`` span and a ``step_time_ms``
    observation, and ``introspect.tick()`` runs after every call.
    ``evaluate()`` → metrics runs and is logged (``eval_*``) whenever a
    multiple of ``config.eval_every > 0`` falls in a call's steps.
    ``save(step, cursor, force=False)`` writes a checkpoint whenever
    ``checkpointer.due_window`` says so and once at the end (``force``:
    the last step's save, or the preemption flush), with the cursor of
    the last batch a step consumed. ``preemption_guard`` is polled
    between calls. Under ``compact_device`` with
    ``compact_overflow='error'`` a running ``fmin`` of every call's loss
    stays on the device and is read at each log line, before every save
    and at the end: a −inf there (the overflow poison) raises, so a
    poisoned table is never saved.

    Returns ``{"end", "loss", "step_ms", "ingest"}``: the step reached,
    each call's loss, its ms (CUDA events on the card, capture included
    in a group's first call; host time on the CPU) and
    :func:`ingest_counts` of the source (when it quarantined anything,
    ``logger`` gets the ``bad_records``/``good_records`` line)."""
    from fm_spark_tpu_torch import obs
    from fm_spark_tpu_torch.data import Prefetcher
    from fm_spark_tpu_torch.obs import introspect
    from fm_spark_tpu_torch.resilience import faults

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
    pf = Prefetcher(source, depth=prefetch, device=device) if prefetch > 0 \
        else None
    cursor = pf if pf is not None else source
    on_card = device.type == "cuda"
    losses, marks = [], []
    log_every = max(config.log_every, 1)
    since = 0
    i = start
    obs_on = obs.enabled()
    hist_step = obs.histogram("step_time_ms") if obs_on else None
    win = None
    try:
        while i < config.num_steps:
            if preemption_guard is not None and preemption_guard.should_stop:
                break
            faults.inject("train_step")
            m = min(steps_per_call, config.num_steps - i)
            batch = (pf.next_batch() if pf
                     else _batch_to(source.next_batch(), device))
            if on_card:
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
            else:
                t0 = time.perf_counter()
            out = run(i, m, batch)
            if on_card:
                t1.record()
                marks.append((t0, t1))
            else:
                marks.append(time.perf_counter() - t0)
            loss = out["loss"]
            losses.append(loss)      # a fresh tensor per call
            if guard:
                worst = loss if worst is None else torch.fmin(worst, loss)
            i += m
            since += m * batch[2].shape[-1] * rows_scale
            if obs_on:
                if win is None:
                    float(loss)           # the first call's fence  # fmlint: disable=torch-host-sync -- the first call's fence: the window's clock starts once the first call (and its capture) has run
                    win = [time.time(), time.perf_counter(), 0]
                else:
                    win[2] += m
            if logger is not None and (
                    i // log_every > (i - m) // log_every
                    or i >= config.num_steps):
                check_poison()
                values = {k: float(v) for k, v in out.items()}
                logger.log(i, samples=since, **values)
                since = 0
                if obs_on:
                    _close_window(win, hist_step, i, values["loss"], device)
            introspect.tick()
            if (evaluate is not None and config.eval_every > 0
                    and i // config.eval_every
                    > (i - m) // config.eval_every):
                metrics = evaluate()
                if logger is not None:
                    logger.log(i, **{f"eval_{k}": v
                                     for k, v in metrics.items()})
            if checkpointer is not None and checkpointer.due_window(i, m):
                check_poison()
                save(i, cursor.state())
        if checkpointer is not None:
            check_poison()
            # The last step's save, or the preemption flush.
            save(i, cursor.state(), force=True)
            checkpointer.wait()
        check_poison()
        ingest = ingest_counts(cursor)
        _log_ingest(logger, i, ingest)
    finally:
        if pf is not None:
            pf.close()
    if on_card:
        torch.cuda.synchronize(device)
        step_ms = [a.elapsed_time(b) for a, b in marks]
    else:
        step_ms = [s * 1e3 for s in marks]
    return {"end": i, "loss": [float(x) for x in losses], "step_ms": step_ms,
            "ingest": ingest}
