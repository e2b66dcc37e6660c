"""Full-batch L-BFGS training, the reference's second optimizer (the port
of ``fm_spark_tpu/lbfgs.py``).

The lineage ships ``FMWithLBFGS`` beside ``FMWithSGD``, on MLlib's
``LBFGS``: full-batch gradients, ``numCorrections`` history pairs and a
``convergenceTol`` stop. The reference runs optax 0.2.6's
``lbfgs(memory_size=numCorrections)`` (``scale_by_lbfgs`` with
``scale_init_precond=True``, then ``scale_by_zoom_linesearch(
max_linesearch_steps=20, initial_guess_strategy='one')``) inside one
``lax.while_loop``. This module computes the same algorithm, step for
step (Nocedal and Wright's two-loop recursion and zoom linesearch,
Algorithms 7.4, 3.5 and 3.6), not ``torch.optim.LBFGS``, whose
linesearch is another algorithm.

The loop runs on the host: the trip counts of the loop and of each
linesearch depend on the data, so each iteration and each linesearch
trial reads its few scalars (value, slope) from the device once and
decides on the host in float32, the reference's scalar dtype. The
vectors (parameters, gradients, the history) stay on the device as one
flat float32 vector in the parameters' key order.

L2 enters the objective, MLlib's ``loss + ½·r·‖θ‖²`` with the ``(r0,
r1, r2)`` triple per group, so objective and gradient agree for the
linesearch and the curvature pairs. The gradient is the dense step's,
written out and summed per id by the device dedup
(``train._dense_grads_fn``), plus ``r·θ``.
"""

from __future__ import annotations

import numpy as np
import torch

from fm_spark_tpu_torch.graphs import _leaves
from fm_spark_tpu_torch.train import TrainConfig

_F32 = np.float32


def _rebuild(tree, leaves):
    """A tree shaped like ``tree`` whose leaves are ``leaves`` (an
    iterator, in :func:`_leaves`' order)."""
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        out = {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return [_rebuild(x, leaves) for x in tree]


def _groups(tree):
    """Each leaf's top-level key, in :func:`_leaves`' order."""
    return [key for key in sorted(tree) for _ in _leaves(tree[key])]


class _Objective:
    """The full-batch regularized objective of :func:`make_objective`:
    ``f(params)`` → the value (a 0-dim float32 tensor), and
    :meth:`value_and_grad`."""

    def __init__(self, spec, config: TrainConfig, ids, vals, labels,
                 weights):
        from fm_spark_tpu_torch.train import _dense_grads_fn

        self._grads = _dense_grads_fn(spec)
        self._batch = (ids, vals, labels, weights)
        self._reg_of = {"w0": config.reg_bias, "w": config.reg_linear,
                        "v": config.reg_factors, "mlp": config.reg_factors,
                        "vw": config.reg_factors}

    def _reg(self, params):
        regs = []
        for key in _groups(params):
            r = self._reg_of.get(key)
            if r is None:
                raise ValueError(f"no regularization group for param {key!r}")
            regs.append(r)
        return regs

    def _penalty(self, params, regs):
        total = 0.0
        for p, r in zip(_leaves(params), regs):
            term = (torch.zeros((), dtype=torch.float32, device=p.device)
                    if r == 0.0 else
                    torch.sum(torch.square(p.float())) * float(_F32(0.5 * r)))
            total = total + term
        return total

    def __call__(self, params):
        return self.value_and_grad(params)[0]

    @torch.no_grad()
    def value_and_grad(self, params):
        """``(value, grads)``: the objective and its gradient, a tree like
        ``params`` (float32)."""
        regs = self._reg(params)
        loss, grads = self._grads(params, *self._batch)
        value = loss.float() + self._penalty(params, regs)
        leaves = [g.float() if r == 0.0 else
                  g.float() + (2.0 * p.float()) * float(_F32(0.5 * r))
                  for g, p, r in zip(_leaves(grads), _leaves(params), regs)]
        return value, _rebuild(params, iter(leaves))


def _on(params, ids, vals, labels, weights):
    dev = _leaves(params)[0].device
    ids = torch.as_tensor(np.asarray(ids) if not isinstance(
        ids, torch.Tensor) else ids).to(dev)
    vals = torch.as_tensor(vals, dtype=torch.float32).to(dev)
    labels = torch.as_tensor(labels, dtype=torch.float32).to(dev)
    weights = (torch.ones(labels.shape, dtype=torch.float32, device=dev)
               if weights is None
               else torch.as_tensor(weights, dtype=torch.float32).to(dev))
    return ids, vals, labels, weights


def make_objective(spec, config: TrainConfig, ids, vals, labels, weights):
    """The full-batch regularized objective: ``f(params)`` → ``Σ_b w_b·
    loss_b / max(Σ w, 1) + Σ_groups ½·r·‖θ‖²`` (a 0-dim float32 tensor on
    the params' device), with ``f.value_and_grad(params)`` → ``(value,
    grads)``. The groups are the reference's: ``w0`` → ``reg_bias``, ``w``
    → ``reg_linear``, ``v``, ``mlp``, ``vw`` → ``reg_factors``; another
    raises. The families are those of the dense step (the flat and the
    field families)."""
    return _Objective(spec, config, ids, vals, labels, weights)


class _Flat:
    """A params tree ⇄ one flat float32 vector, in :func:`_leaves`'
    order."""

    def __init__(self, params):
        self.example = params
        self.shapes = [t.shape for t in _leaves(params)]
        self.sizes = [t.numel() for t in _leaves(params)]

    def rounder(self):
        """``x ↦ x`` with the elements of bf16 leaves rounded to bf16 (the
        identity when every leaf is float32)."""
        leaves = _leaves(self.example)
        if all(t.dtype == torch.float32 for t in leaves):
            return lambda x: x
        mask = torch.cat([torch.full((t.numel(),), t.dtype == torch.bfloat16,
                                     device=t.device) for t in leaves])
        return lambda x: torch.where(mask, x.to(torch.bfloat16).float(), x)

    def flat(self, tree) -> torch.Tensor:
        return torch.cat([t.reshape(-1).float() for t in _leaves(tree)])

    def tree(self, vec):
        parts = torch.split(vec, self.sizes)
        return _rebuild(self.example, iter(
            p.view(s) for p, s in zip(parts, self.shapes)))


# -------------------------------------------------- the zoom linesearch

_MAX_LS_STEPS = 20
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5
_INCREASE = 2.0


def _fmax(a, b):
    """``jnp.maximum``: NaN if either is NaN."""
    return _F32(np.maximum(a, b))


def _fmin(a, b):
    return _F32(np.minimum(a, b))


def _decrease_error(stepsize, value_step, slope_step, value_init,
                    slope_init):
    """optax's ``_compute_decrease_error``: the Armijo error, or the
    approximate-Wolfe one where smaller, clipped at 0, NaN as inf."""
    with np.errstate(all="ignore"):
        err = value_step - value_init - _F32(_SLOPE_RTOL) * stepsize \
            * slope_init
        approx = slope_step - _F32(2 * _SLOPE_RTOL - 1.0) * slope_init
        delta = value_step - value_init - _F32(_APPROX_DEC_RTOL) \
            * np.abs(value_init)
        err = _fmin(_fmax(approx, delta), err)
        err = _fmax(err, _F32(0.0))
    return _F32(np.inf) if np.isnan(err) else err


def _curvature_error(slope_step, slope_init):
    with np.errstate(all="ignore"):
        err = _fmax(np.abs(slope_step) - _F32(_CURV_RTOL) * np.abs(slope_init),
                    _F32(0.0))
    return _F32(np.inf) if np.isnan(err) else err


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """The critical point of the cubic through ``(a, fa)``, ``(b, fb)``,
    ``(c, fc)`` with slope ``fpa`` at ``a`` (optax's ``_cubicmin``, in
    float32; NaN where there is none)."""
    with np.errstate(all="ignore"):
        C = fpa
        db = b - a
        dc = c - a
        denom = (db * dc) * (db * dc) * (db - dc)
        r0 = fb - fa - C * db
        r1 = fc - fa - C * dc
        A = (dc * dc * r0 + (-(db * db)) * r1) / denom
        B = ((-(dc * dc * dc)) * r0 + (db * db * db) * r1) / denom
        radical = B * B - _F32(3.0) * A * C
        return _F32(a + (-B + np.sqrt(radical)) / (_F32(3.0) * A))


def _quadmin(a, fa, fpa, b, fb):
    with np.errstate(all="ignore"):
        db = b - a
        B = (fb - fa - fpa * db) / (db * db)
        return _F32(a - fpa / (_F32(2.0) * B))


class _Linesearch:
    """optax 0.2.6's ``zoom_linesearch`` (max 20 steps, no max stepsize,
    tol 0, increase 2, slope_rtol 1e-4, curv_rtol 0.9, approx_dec_rtol
    1e-6, interval threshold 1e-5, first guess 1), its scalars float32 on
    the host, its vectors on the device."""

    def __init__(self, vag, params, updates, value, grad, value_init,
                 slope_init):
        self.vag, self.params, self.updates = vag, params, updates
        self.count = 0
        self.stepsize = _F32(0.0)
        self.value, self.grad, self.slope = value, grad, slope_init
        self.value_init, self.slope_init = value_init, slope_init
        self.decrease_error = self.curvature_error = _F32(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low = self.high = self.cubic_ref = _F32(0.0)
        self.value_low = self.value_high = self.value_cubic_ref = value
        self.slope_low = self.slope_high = slope_init
        self.safe_stepsize, self.safe_value, self.safe_grad = (
            _F32(0.0), value, grad)

    def _evaluate(self, stepsize):
        """One trial: the value, gradient and slope at ``params +
        stepsize·updates`` (one read from the device)."""
        step = self.params + float(stepsize) * self.updates
        value, grad = self.vag(step)
        slope = torch.dot(grad, self.updates)
        v, s = torch.stack([value, slope]).cpu().numpy().astype(np.float32)
        return _F32(v), grad, _F32(s)

    def _errors(self, stepsize, value, slope):
        de = _decrease_error(stepsize, value, slope, self.value_init,
                             self.slope_init)
        ce = _curvature_error(slope, self.slope_init)
        return de, ce, _fmax(de, ce)

    def _search_interval(self):
        prev = (self.stepsize, self.value, self.slope)
        new = (_F32(1.0) if self.count == 0
               else _F32(_INCREASE) * self.stepsize)
        value, grad, slope = self._evaluate(new)
        de, ce, error = self._errors(new, value, slope)
        if de <= 0.0:
            self.safe_stepsize, self.safe_value, self.safe_grad = (
                new, value, grad)
        set_high = (de > 0.0) or (value >= prev[1] and self.count > 0)
        set_low = slope >= 0.0 and not set_high
        if set_low:
            (self.low, self.value_low, self.slope_low, self.high,
             self.value_high, self.slope_high) = (new, value, slope) + prev
        else:
            (self.low, self.value_low, self.slope_low, self.high,
             self.value_high, self.slope_high) = prev + (new, value, slope)
        self.interval_found = set_high or set_low or error <= 0.0
        self.done = bool(error <= 0.0)
        self.failed = self.count + 1 >= _MAX_LS_STEPS and not self.done
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = (
            new, value, grad, slope)
        self.decrease_error, self.curvature_error = de, ce

    def _zoom(self):
        low, high = self.low, self.high
        delta = _F32(np.abs(high - low))
        left, right = _fmin(high, low), _fmax(high, low)
        cubic_chk, quad_chk = _F32(0.2) * delta, _F32(0.1) * delta
        too_small = delta <= _F32(_INTERVAL_THRESHOLD)
        mid_cubic = _cubicmin(low, self.value_low, self.slope_low, high,
                              self.value_high, self.cubic_ref,
                              self.value_cubic_ref)
        use_cubic = left + cubic_chk < mid_cubic < right - cubic_chk
        mid_quad = _quadmin(low, self.value_low, self.slope_low, high,
                            self.value_high)
        use_quad = (not use_cubic) and (left + quad_chk < mid_quad
                                        < right - quad_chk)
        if use_cubic:
            middle = mid_cubic
        elif use_quad:
            middle = mid_quad
        else:
            middle = _F32((low + high) / _F32(2.0))
        value, grad, slope = self._evaluate(middle)
        de, ce, error = self._errors(middle, value, slope)
        if de <= 0.0 and value < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = (
                middle, value, grad)
        self.done = bool(error <= 0.0)
        set_high_mid = de > 0.0 or value >= self.value_low
        set_high_low = (slope * (high - low) >= 0.0) and not set_high_mid
        old_low = (self.low, self.value_low, self.slope_low)
        old_high = (self.high, self.value_high, self.slope_high)
        new_high = (middle, value, slope) if set_high_mid else old_high
        if set_high_low:
            new_high = old_low
        new_low = old_low if set_high_mid else (middle, value, slope)
        self.cubic_ref, self.value_cubic_ref = (
            old_high[:2] if (set_high_mid or set_high_low) else old_low[:2])
        (self.low, self.value_low, self.slope_low) = new_low
        (self.high, self.value_high, self.slope_high) = new_high
        presumably = (self.count + 1 >= _MAX_LS_STEPS
                      or (too_small and self.safe_stepsize > 0.0))
        self.failed = presumably and not self.done
        self.count += 1
        self.stepsize, self.value, self.grad, self.slope = (
            middle, value, grad, slope)
        self.decrease_error, self.curvature_error = de, ce

    def run(self):
        """Trials until done or failed; a failed search falls back on the
        safe step (sufficient decrease) where there is one, or where the
        last trial left the domain. Returns ``(stepsize, value, grad)``."""
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom()
            else:
                self._search_interval()
            if self.failed and (self.safe_stepsize > 0.0
                                or np.isinf(self.decrease_error)):
                self.stepsize, self.value, self.grad = (
                    self.safe_stepsize, self.safe_value, self.safe_grad)
        return self.stepsize, self.value, self.grad


# ------------------------------------------------------------- the loop


def _precondition(updates, dws, dus, rhos, scale, memory_idx: int,
                  rnd=lambda x: x):
    """optax's ``_precondition_by_lbfgs``, the two-loop recursion over the
    ring buffer from ``memory_idx`` (every scalar a device tensor); ``rnd``
    rounds the first loop's carry to the leaves' dtypes."""
    m = rhos.shape[0]
    order = [(memory_idx + j) % m for j in range(m)]
    alphas = {}
    vec = updates
    for idx in reversed(order):
        alphas[idx] = rhos[idx] * torch.dot(dws[idx], vec)
        vec = rnd(vec + (-alphas[idx]) * dus[idx])
    vec = scale * vec
    for idx in order:
        beta = rhos[idx] * torch.dot(dus[idx], vec)
        vec = vec + (alphas[idx] - beta) * dws[idx]
    return vec


def fit_lbfgs(spec, params, ids, vals, labels, weights=None, *,
              config: TrainConfig | None = None, num_iterations: int = 100,
              num_corrections: int = 10, convergence_tol: float = 1e-6):
    """Minimize the full-batch objective (:func:`make_objective`) from
    ``params`` (float32 tensors, updated in place) by L-BFGS; returns
    ``(params, info)``, ``info`` the final ``loss``, its ``grad_norm`` and
    the ``iterations`` run, as floats.

    It stops after ``num_iterations`` or once the relative decrease of the
    objective between consecutive iterates, ``|f_{i-1} − f_i| /
    max(|f_{i-1}|, 1e-12)``, is at most ``convergence_tol`` (MLlib's rule,
    the reference's ``lbfgs.py:94-102``).

    bf16 tables (float32 and bf16 leaves) follow optax's dtype handling at
    the points where it stores a value in the parameters' dtype: the
    gradient (JAX's of a bf16 leaf is bf16), the accepted parameters
    (``apply_updates`` casts to the leaf's dtype), the memory pairs
    ``Δθ``, ``Δg`` (bf16 differences of bf16 leaves) and the first loop of
    the two-loop recursion (``cast_like`` its carry); its scaled update and
    second loop, and a linesearch trial's parameters, stay float32, as in
    optax. The rest is float32 in both (the vector sums of a bf16 leaf
    round once per leaf in optax, once per vector here)."""
    config = config or TrainConfig()
    bad = sorted({str(t.dtype) for t in _leaves(params)
                  if t.dtype not in (torch.float32, torch.bfloat16)})
    if bad:
        raise ValueError(
            f"fit_lbfgs takes float32 or bfloat16 parameters, got {bad}")
    batch = _on(params, ids, vals, labels, weights)
    objective = make_objective(spec, config, *batch)
    flat = _Flat(params)
    rnd = flat.rounder()

    def vag(theta):
        value, grads = objective.value_and_grad(flat.tree(theta))
        return value.float(), rnd(flat.flat(grads))

    theta = flat.flat(params)
    dev = theta.device
    m = num_corrections
    if m < 1:
        raise ValueError("memory_size must be >= 1")
    dws = torch.zeros(m, theta.numel(), dtype=torch.float32, device=dev)
    dus = torch.zeros_like(dws)
    rhos = torch.zeros(m, dtype=torch.float32, device=dev)
    prev_theta = torch.zeros_like(theta)
    prev_grad = torch.zeros_like(theta)
    ls_value, ls_grad = _F32(np.inf), None
    count = 0
    i, prev, cur = 0, _F32(np.inf), _F32(np.inf)
    tol = _F32(convergence_tol)

    def keep_going():
        if i >= num_iterations:
            return False
        if i < 1:
            return True
        with np.errstate(all="ignore"):
            rel = (_F32(np.abs(prev - cur)) / _fmax(np.abs(prev),
                                                      _F32(1e-12))
                   if np.isfinite(prev) else _F32(np.inf))
        return bool(rel > tol)

    while keep_going():
        if np.isfinite(ls_value):
            value_t, grad = None, ls_grad
        else:
            value_t, grad = vag(theta)
        # scale_by_lbfgs: the memory from the fresh params and gradient.
        memory_idx, prev_idx = count % m, (count - 1) % m
        if count > 0:
            dw = rnd(theta - prev_theta)
            du = rnd(grad - prev_grad)
            curv = torch.dot(du, dw)
            rho = torch.where(curv == 0.0, 0.0, 1.0 / curv)
            dws[prev_idx], dus[prev_idx], rhos[prev_idx] = dw, du, rho
            denom = torch.dot(du, du)
            scale = torch.where(denom > 0.0, curv / denom, 1.0)
        else:
            dws[prev_idx].zero_()
            dus[prev_idx].zero_()
            rhos[prev_idx] = 0.0
            scale = torch.minimum(torch.ones((), device=dev),
                                  1.0 / torch.linalg.vector_norm(grad))
        direction = -_precondition(grad, dws, dus, rhos, scale, memory_idx,
                                   rnd)
        count += 1
        prev_theta, prev_grad = theta, grad
        # The zoom linesearch from the current value (read with the first
        # trial's numbers, one transfer).
        slope_t = torch.dot(direction, grad)
        if value_t is None:
            value0, slope0 = ls_value, _F32(float(slope_t))
        else:
            value0, slope0 = (_F32(x) for x in torch.stack(
                [value_t, slope_t]).cpu().numpy())
        ls = _Linesearch(vag, theta, direction, value0, grad, value0, slope0)
        stepsize, ls_value, ls_grad = ls.run()
        theta = rnd(theta + float(stepsize) * direction)
        i, prev, cur = i + 1, cur, value0
    value, grad = vag(theta)
    for t, src in zip(_leaves(params), _leaves(flat.tree(theta))):
        t.copy_(src)
    info = {"loss": float(value),
            "grad_norm": float(torch.linalg.vector_norm(grad)),
            "iterations": float(i)}
    return params, info
