"""Per-coordinate adaptive optimizers for hashed-sparse CTR training (the
port of ``fm_spark_tpu/optim/__init__.py``).

Hashed feature frequencies span orders of magnitude, so one global
learning rate burns the head ids or never moves the tail. Per-coordinate
AdaGrad and FTRL-Proximal (McMahan et al., "Ad Click Prediction: a View
from the Trenches") keep one or two float32 slots per coordinate and
derive each coordinate's step from its own gradient history. One set of
row rules serves two forms:

- **Dense form**: FTRL as ``train.Optimizer('ftrl')`` (``TrainConfig(
  optimizer='ftrl')``), for every dense step (the flat families'
  ``train.make_train_step`` and FieldDeepFM's dense head). Its ``z``/``n``
  slots are the optimizer's state, saved under ``opt/`` in a checkpoint.
- **Sparse row form** (:func:`make_sparse_adaptive_step`): the flat FM's
  adaptive sibling of ``sparse.make_sparse_sgd_step``. Each id's lanes
  are summed once (``ops.scatter._dedup``, kernel A on the card), the
  touched rows and their slot rows are gathered once, updated by the
  rule and written back with one set per distinct id; the slot tables
  never see a dense gradient. ``w0`` keeps plain constant-lr SGD.

Both rules are exactly lazy: a coordinate whose batch gradient is zero
keeps ``n`` (and ``z``), and FTRL's closed form is a function of them
alone; :func:`ftrl_init_z` picks the initial ``z`` so that the closed form
gives back the spec's init. FTRL ignores ``lr_schedule``: its
per-coordinate ``(beta + √n)/alpha`` is the schedule (``alpha`` is the
configured learning rate).

Python scalars enter as JAX's weak types do: rounded to float32 once
(``ops.fused_bwd.round_to``). A division by one is taken by a 0-dim
tensor on the operand's device, never a host scalar: on the card PyTorch
multiplies by the reciprocal of a host scalar divisor, which rounds
otherwise than the reference's division.
"""

from __future__ import annotations

import torch

__all__ = [
    "ADAGRAD_EPS",
    "ADAPTIVE_OPTIMIZERS",
    "adagrad_rows",
    "ftrl_init_z",
    "ftrl_rows",
    "init_adaptive_slots",
    "make_sparse_adaptive_step",
    "seed_ftrl_slots",
]

ADAPTIVE_OPTIMIZERS = ("ftrl", "adagrad")

#: AdaGrad's denominator floor (outside the square root, the McMahan
#: paper's form, not optax.adagrad's initial accumulator).
ADAGRAD_EPS = 1e-8


def _f32(value: float) -> float:
    from fm_spark_tpu_torch.ops.fused_bwd import round_to

    return round_to(float(value), torch.float32)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root: the card's ``sqrtf``;
    on the CPU, whose vectorised float32 ``torch.sqrt`` is not always
    correctly rounded, through float64 (exact to round once, 53 ≥ 2·24 +
    2 bits)."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _scalar(value: float, like: torch.Tensor) -> torch.Tensor:
    """``value`` as a float32 0-dim tensor on ``like``'s device (a fill:
    a captured step may make it)."""
    return torch.full((), _f32(value), dtype=torch.float32,
                      device=like.device)


# ------------------------------------------------------ per-row update rules


def adagrad_rows(rows, n, g, lr: float):
    """Per-coordinate AdaGrad on gathered rows: ``rows``, ``n`` (the
    accumulated squared gradients) and ``g`` (this batch's summed gradient)
    of one shape. Returns ``(new_rows, new_n)`` in float32."""
    g = g.float()
    n_new = n.float() + g * g
    step = (g * _f32(lr)) / (_sqrt(n_new) + _f32(ADAGRAD_EPS))
    return rows.float() - step, n_new


def ftrl_init_z(w0, alpha: float, beta: float):
    """The initial ``z`` with which FTRL's closed form gives back the
    spec's init (``n = 0``, ``l1 = 0``): ``z = -w·(beta/alpha)``, the
    quotient rounded to float32 once. Without it FTRL zeroes every
    coordinate it first touches, and zero factors never recover."""
    return -w0.float() * _f32(beta / alpha)


def ftrl_rows(rows, z, n, g, alpha: float, beta: float, l1: float,
              l2: float):
    """Per-coordinate FTRL-Proximal on gathered rows: ``σ = (√(n+g²) −
    √n)/α``, ``z += g − σ·w``, ``n += g²``, and the weight is the
    closed-form proximal solution ``−sign(z)·max(|z| − l1, 0) / ((β +
    √n)/α + l2)``. Returns ``(new_rows, new_z, new_n)`` in float32."""
    w = rows.float()
    g = g.float()
    z = z.float()
    n = n.float()
    a = _scalar(alpha, w)
    n_new = n + g * g
    root = _sqrt(n_new)
    sigma = (root - _sqrt(n)) / a
    z_new = z + g - sigma * w
    shrunk = torch.sign(z_new) * torch.clamp(torch.abs(z_new) - _f32(l1),
                                             min=0.0)
    denom = (root + _f32(beta)) / a + _f32(l2)
    return -shrunk / denom, z_new, n_new


# ------------------------------------------------------------ sparse form


def init_adaptive_slots(optimizer: str, spec, params) -> dict:
    """The slots of :func:`make_sparse_adaptive_step`: one float32 table
    per sparse table (``v``, and ``w`` when the spec uses the linear
    term), on the params' device, ``{"n"}`` for AdaGrad and ``{"z",
    "n"}`` (zero; :func:`seed_ftrl_slots` seeds ``z``) for FTRL. ``w0`` has
    none by design. Checkpoint this dict as the step's optimizer state."""
    if optimizer not in ADAPTIVE_OPTIMIZERS:
        raise ValueError(
            f"unknown adaptive optimizer {optimizer!r} "
            f"(know {ADAPTIVE_OPTIMIZERS})")
    names = ["v", "w"] if spec.use_linear else ["v"]
    keys = ("n",) if optimizer == "adagrad" else ("z", "n")
    return {name: {key: torch.zeros(params[name].shape, dtype=torch.float32,
                                    device=params[name].device)
                   for key in keys}
            for name in names}


def seed_ftrl_slots(slots: dict, params, alpha: float, beta: float) -> dict:
    """FTRL's ``z`` slots seeded from the current tables (a fresh start
    only: restored slots carry their history), in place; returns
    ``slots``."""
    for name, slot in slots.items():
        slot["z"].copy_(ftrl_init_z(params[name], alpha, beta))
    return slots


def _unique_writes(d, n: int):
    """Where each slot of a device dedup ``d`` (over ids in ``[0, n]``, id
    ``n`` the dropped ones) reads and writes: ``(src, keep, idx)``, ``idx``
    the row each slot gathers and writes and ``src`` the slot whose new
    row it writes there (``keep`` False: every slot writes row 0's old
    value back, for a batch with no id in the table).

    The segment ids are sorted and distinct below the segment count, and
    the dropped id ``n`` sorts last. The ``c`` live segments (those below
    ``n``) read and write their own rows; every other slot ``j`` repeats
    live slot ``j mod c``'s read and write, so the extra writers of a row
    write its bits, spread over all the live rows (on one row their
    stores would queue behind each other), and no slot reads an unset
    segment id: one write per distinct id, deterministic, ``O(B·nnz)``."""
    m = d.useg.shape[0]
    slot = torch.arange(m, device=d.useg.device)
    count = d.count.long()
    last = d.useg[(count - 1).clamp(min=0)]
    live = count - (last >= n).long()
    src = torch.remainder(slot, live.clamp(min=1))
    keep = live > 0
    idx = torch.where(keep, d.useg[src].long(), 0).clamp(0, n - 1)
    return src, keep, idx


def _set_rows(table, idx, src, keep, new_rows, old_rows):
    """``table[idx[m]] = new_rows[src[m]]`` in place (``keep``; else the
    gathered ``old_rows``), ``new_rows`` float32 cast to the table's
    dtype."""
    k = keep.reshape(-1, *([1] * (table.dim() - 1)))
    final = torch.where(k, new_rows.to(table.dtype)[src], old_rows)
    table.index_copy_(0, idx, final)


def make_sparse_adaptive_step(spec, config, *, beta: float = 1.0,
                              l1: float = 0.0, l2: float = 0.0):
    """The fused sparse per-coordinate step of the flat FM (the
    reference's ``make_sparse_adaptive_step``): ``step(params, slots, ids,
    vals, labels, weights, keys=None) → (params, slots, loss)``, ``params``
    and ``slots`` (:func:`init_adaptive_slots`) updated in place; ``keys``
    as in ``sparse.make_sparse_sgd_step`` (the tiered store's global ids).

    The backward is the flat SGD step's analytic row rule. For each table
    the ``[B·nnz, w]`` float32 lanes are summed once per distinct id
    (``ops.scatter._dedup``: kernel A on the card, no atomics), since a
    read-modify-write rule that saw a duplicate id twice would double its
    schedule; each distinct id's row and slot rows are gathered once,
    updated by :func:`ftrl_rows` or :func:`adagrad_rows` (``alpha`` the
    learning rate, ``beta``, ``l1``, ``l2`` FTRL's own terms) and written
    back with one set per id. Ids follow JAX's rules: an id in ``[-n, 0)``
    counts from the end, any other out of range clamps in the gather and
    is dropped from the write (the dedup keys on the normalised id, so an
    id and its negative alias in one batch are one segment here). ``w0``
    takes plain constant-lr SGD. Exactly lazy: a row no lane touches is
    not written, and neither are its slots.

    The reference's rejections hold: another family, another optimizer,
    the ``reg_*`` triple (FTRL carries its own l1/l2), and
    ``embed_tier='require'`` (the tiered trainer drives this step). On
    the card the body is captured as one CUDA graph over ``{"params",
    "slots"}``; ``step.body`` is the eager form and ``step.grads`` the
    gradient its rule reads."""
    from fm_spark_tpu_torch import graphs
    from fm_spark_tpu_torch.models.fm import FMSpec
    from fm_spark_tpu_torch.ops import fm as fm_ops
    from fm_spark_tpu_torch.ops import scatter as scatter_lib
    from fm_spark_tpu_torch.ops.fused_bwd import round_to
    from fm_spark_tpu_torch.sparse import (_loss_and_grad_fn,
                                           _reject_embed_tier_require)

    if type(spec) is not FMSpec:
        raise ValueError(
            "the sparse adaptive step supports the flat FM family only "
            "(the fused field families keep their SGD scatter bodies)")
    if config.optimizer not in ADAPTIVE_OPTIMIZERS:
        raise ValueError(
            f"make_sparse_adaptive_step handles {ADAPTIVE_OPTIMIZERS}; "
            f"config.optimizer={config.optimizer!r}")
    if config.reg_bias or config.reg_linear or config.reg_factors:
        raise ValueError(
            "the adaptive step rejects the reg_* triple: FTRL carries "
            "its own proximal l1/l2 and AdaGrad pairs with explicit "
            "weight decay, not lazy L2 — configure l1/l2 here instead")
    _reject_embed_tier_require(config, "the bare sparse adaptive step "
                               "(drive it through embed.TieredTrainer)")
    loss_and_grad = _loss_and_grad_fn(spec.loss)
    cd = spec.cdtype
    alpha = float(config.learning_rate)
    is_ftrl = config.optimizer == "ftrl"
    sum_upcast = fm_ops.sum_upcast

    def rule(rows, slot, g):
        if is_ftrl:
            new, z_new, n_new = ftrl_rows(rows, slot["z"], slot["n"], g,
                                          alpha, beta, l1, l2)
            return new, {"z": z_new, "n": n_new}
        new, n_new = adagrad_rows(rows, slot["n"], g, alpha)
        return new, {"n": n_new}

    def totals(params, ids, vals, labels, weights, keys=None):
        """The loss, the score gradient, the device dedup ``d`` of the
        batch's ``[row | linear]`` lanes and ``g``, its totals (zero past
        the live segments)."""
        w0, w, v = params["w0"], params["w"], params["v"]
        n, k = v.shape
        gidx = fm_ops.gather_index(ids, n)
        vals_c = vals.to(cd)
        xv = v[gidx].to(cd) * vals_c[..., None]               # [B, nnz, k]
        s = sum_upcast(xv, 1)                                 # [B, k]
        scores = 0.5 * (sum_upcast(s * s, 1) - sum_upcast(xv * xv, (1, 2)))
        if spec.use_linear:
            scores = scores + sum_upcast(w[gidx].to(cd) * vals_c, 1)
        if spec.use_bias:
            scores = scores + w0.to(cd)
        loss, dscores = loss_and_grad(scores, labels, weights)
        g_rows = dscores[:, None, None] * vals_c[..., None] * (
            s[:, None, :] - xv)
        m = ids.numel()
        lanes = [g_rows.float().reshape(m, k)]
        if spec.use_linear:
            lanes.append((dscores[:, None] * vals_c).float().reshape(m, 1))
        # One dedup for both tables: they share the ids, so the segments
        # are one; the linear lane rides as the last column.
        d = scatter_lib._dedup_by(fm_ops.write_index(ids, n).reshape(-1),
                                  torch.cat(lanes, dim=1), None if keys is None
                                  else keys.reshape(-1))
        slot_i = torch.arange(m, device=v.device)
        live = (slot_i < d.count) & (d.useg < n)
        g = torch.where(live[:, None], d.totals, 0.0)   # past the count: unset
        return loss, dscores, d, g

    @torch.no_grad()
    def body(params, slots, ids, vals, labels, weights, keys=None):
        w0, w, v = params["w0"], params["w"], params["v"]
        n, k = v.shape
        loss, dscores, d, g = totals(params, ids, vals, labels, weights, keys)
        src, keep, idx = _unique_writes(d, n)
        for name, table, col in (("v", v, slice(0, k)), ("w", w, k)):
            if name not in slots:
                continue
            old = table[idx]
            old_slot = {key: s_[idx] for key, s_ in slots[name].items()}
            new, new_slot = rule(old, old_slot, g[:, col])
            _set_rows(table, idx, src, keep, new, old)
            for key, s_ in slots[name].items():
                _set_rows(s_, idx, src, keep, new_slot[key], old_slot[key])
        if spec.use_bias:
            # The dense slot keeps constant-lr SGD: w0 − alpha·Σ ds, the
            # product in the compute dtype (alpha rounded to it first).
            w0.sub_((sum_upcast(dscores) * round_to(alpha, cd)).float())
        return params, slots, loss.float()

    @torch.no_grad()
    def grads(params, ids, vals, labels, weights):
        """The gradient the step's rule reads, as float32 tables: each
        distinct id's total in its row of ``v`` and ``w`` (zero on every
        other row), ``w0``'s the sum of the score gradient."""
        n, k = params["v"].shape
        _, dscores, d, g = totals(params, ids, vals, labels, weights)
        src, keep, idx = _unique_writes(d, n)
        out = torch.zeros(n, g.shape[1], device=g.device).index_copy_(
            0, idx, torch.where(keep, g[src], 0.0))
        return {"w0": sum_upcast(dscores).float(), "w": (
            out[:, k] if spec.use_linear else torch.zeros_like(out[:, 0])),
            "v": out[:, :k]}

    def run(state, _step, *batch):
        return body(state["params"], state["slots"], *batch)[2]

    captured = graphs.CapturedStep(run)

    def step(params, slots, ids, vals, labels, weights, keys=None):
        if params["w0"].device.type != "cuda":
            return body(params, slots, ids, vals, labels, weights, keys)
        loss = captured({"params": params, "slots": slots}, 0, ids, vals,
                        labels, weights, keys)
        return params, slots, loss

    step.captured = captured
    step.body = body
    step.grads = grads
    return step
