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
