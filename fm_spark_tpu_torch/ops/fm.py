"""Order-2 factorization-machine forward math on gathered rows (the port
of ``fm_spark_tpu/ops/fm.py``)."""

from __future__ import annotations

import functools
import operator

import torch


def sum_upcast(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``jnp.sum``: bf16 sums accumulate in float32, rounded back once."""
    if x.dtype == torch.bfloat16:
        s = x.float().sum() if dim is None else x.float().sum(dim)
        return s.to(torch.bfloat16)
    return x.sum() if dim is None else x.sum(dim)


def seq_sum(terms):
    """Python's ``sum`` over per-field arrays: left to right, each add
    rounded in the operands' dtype."""
    return functools.reduce(operator.add, terms)


def fm_interaction_from_xv(xv: torch.Tensor) -> torch.Tensor:
    """Order-2 interaction from value-scaled gathered rows ``xv [B,nnz,k]``:
    ``0.5 · Σ_f (s_f² − Σ_i (v_{i,f} x_i)²)`` with ``s = Σ_i xv_i``."""
    s = xv.sum(dim=1)                                  # [B, k]
    sum_sq = (xv * xv).sum(dim=(1, 2))                 # [B]
    return 0.5 * ((s * s).sum(dim=1) - sum_sq)


def gather_index(ids: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's gather index of ``ids`` into a table of ``n`` rows (int64): an
    id in ``[-n, 0)`` counts from the end, then every id clamps into
    ``[0, n - 1]``."""
    idx = ids.long()
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def write_index(ids: torch.Tensor, n: int) -> torch.Tensor:
    """JAX's scatter index of ``ids`` into a table of ``n`` rows (int64):
    an id in ``[-n, 0)`` counts from the end; every other id out of range
    is dropped, here mapped to ``n``, one past the last row."""
    idx = ids.long()
    idx = torch.where(idx < 0, idx + n, idx)
    return torch.where((idx >= 0) & (idx < n), idx, n)


def _gather_rows(table: torch.Tensor, ids: torch.Tensor,
                 compute_dtype) -> torch.Tensor:
    """Rows of ``table`` at ``ids`` (JAX's index rules), cast to the compute
    dtype: tables may be stored in bf16 and accumulated in float32."""
    return table[gather_index(ids, table.shape[0])].to(compute_dtype)


def fm_scores(w0: torch.Tensor, w: torch.Tensor, v: torch.Tensor,
              ids: torch.Tensor, vals: torch.Tensor,
              compute_dtype=torch.float32) -> torch.Tensor:
    """Batched FM raw scores by the O(k·nnz) identity,
    ``w0 + Σ_i w_i x_i + 0.5·Σ_f (s_f² − Σ_i v_{i,f}² x_i²)``.

    ``w0`` a scalar, ``w`` ``[n]``, ``v`` ``[n, k]``, ``ids`` ``[B, nnz]``
    integer ids, ``vals`` ``[B, nnz]`` values (0 ⇒ a padded slot). Sums of
    a bf16 compute dtype accumulate in float32 and round once, as
    ``jnp.sum`` does. Returns ``[B]`` scores in the compute dtype."""
    vals = vals.to(compute_dtype)
    xv = _gather_rows(v, ids, compute_dtype) * vals[..., None]
    linear = sum_upcast(_gather_rows(w, ids, compute_dtype) * vals, 1)
    return w0.to(compute_dtype) + linear + _interaction(xv)


def _interaction(xv: torch.Tensor) -> torch.Tensor:
    """:func:`fm_interaction_from_xv` with ``jnp.sum``'s bf16 rule."""
    s = sum_upcast(xv, 1)
    sum_sq = sum_upcast(xv * xv, (1, 2))
    return 0.5 * (sum_upcast(s * s, 1) - sum_sq)


def fm_partial_terms(w: torch.Tensor, v_shard: torch.Tensor,
                     ids: torch.Tensor, vals: torch.Tensor, row_start,
                     num_rows: int, compute_dtype=torch.float32):
    """Shard-local partial sums for a row-sharded FM table that owns the
    global rows ``[row_start, row_start + num_rows)``: ids outside the
    shard contribute zero, so the sum of every shard's partials is the
    unsharded forward. Returns ``(linear_partial [B], s_partial [B, k],
    sum_sq_partial [B])``."""
    vals = vals.to(compute_dtype)
    local = ids.long() - row_start
    in_shard = (local >= 0) & (local < num_rows)
    safe = torch.where(in_shard, local, torch.zeros_like(local))
    mvals = vals * in_shard.to(compute_dtype)
    xv = _gather_rows(v_shard, safe, compute_dtype) * mvals[..., None]
    s_partial = sum_upcast(xv, 1)
    sum_sq_partial = sum_upcast(xv * xv, (1, 2))
    linear_partial = sum_upcast(
        _gather_rows(w, safe, compute_dtype) * mvals, 1)
    return linear_partial, s_partial, sum_sq_partial


def fm_scores_from_partials(w0, linear, s, sum_sq,
                            compute_dtype=torch.float32):
    """Raw scores from the summed partial terms; ``s`` must be the FULL
    ``s_f`` (summed over shards), since the interaction squares it."""
    interaction = 0.5 * (sum_upcast(s * s, -1) - sum_sq)
    return w0.to(compute_dtype) + linear + interaction


def fm_scores_dense(w0, w, v, x):
    """Brute-force O(n²) FM on dense inputs ``x [B, n]`` in numpy float64,
    Rendle's definition ``w0 + Σ_i w_i x_i + Σ_{i<j} <v_i, v_j> x_i x_j``:
    the test oracle of :func:`fm_scores`."""
    import numpy as np

    x = np.asarray(x, np.float64)
    w = np.asarray(w, np.float64)
    v = np.asarray(v, np.float64)
    linear = x @ w
    xv = x[:, :, None] * v[None, :, :]                    # [B, n, k]
    gram = np.einsum("bik,bjk->bij", xv, xv)              # [B, n, n]
    iu = np.triu(np.ones((x.shape[1],) * 2), k=1)
    pairwise = np.sum(gram * iu, axis=(1, 2))
    return float(np.asarray(w0)) + linear + pairwise
