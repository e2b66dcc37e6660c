"""The one traffic generator. A mix is a data file,
``benchmark/traffic/<mix>.json``, of parameters that this module reads:

- ``batch``: rows per batch; ``pool``: distinct batches, cycled;
- ``fields``: per field, in the configuration's field order, its
  ``name``, the ``distinct`` values the data set's source counts in it
  over ``rows`` rows, and ``vocab``, the values it draws from: the
  smallest vocabulary whose Zipf law shows at least ``distinct`` values
  in ``rows`` draws (:func:`vocab_for`; a field whose every value shows
  keeps ``vocab == distinct``);
- ``zipf_a``: each field's value of rank ``n`` in ``[1, vocab]`` has
  probability ``∝ n^-a``; the rank is hashed into the field's buckets by
  a fixed 64-bit mix (:func:`hash_ids`), as the ingest hashes a token;
- ``label_rate``: labels are Bernoulli(label_rate); ``vals`` and
  ``weights``: every value and weight;
- ``compact_cap``: the per-field distinct ids a batch may hold (0: no
  cap); a pool with a field past it is refused, not redrawn;
- ``log_every``, ``warmup_steps``: the loop's loss lines, and the step
  at or after which the window opens.

Everything is drawn from one ``torch.Generator`` seeded with the run's
seed on the run's device, so a seed gives the same batches there.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
#: Ranks whose probabilities are summed exactly; past them the sum is
#: the integral of ``x^-a`` over each rank's unit cell (its error per
#: rank is below ``a(a+1)/24·n^-a-2``).
HEAD = 1 << 16
_M64 = (1 << 64) - 1
_MIX = (0x9E3779B97F4A7C15, 0xBF58476D1CE4E5B9, 0x94D049BB133111EB)


class PoolError(ValueError):
    """The drawn pool breaks the mix's own bounds."""


def load(mix: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{mix}.json")) as fh:
        return json.load(fh)


def _tail_int(x, a: float):
    """An antiderivative of ``x^-a``."""
    return np.log(x) if a == 1 else x ** (1 - a) / (1 - a)


def _tail_inv(z, a: float):
    return torch.exp(z) if a == 1 else ((1 - a) * z) ** (1 / (1 - a))


def zipf_ranks(u: torch.Tensor, vocab: int, a: float) -> torch.Tensor:
    """Ranks in ``[1, vocab]`` with ``P(n) ∝ n^-a`` for the float64
    uniforms ``u``, by inverting the CDF: exactly over the first
    ``HEAD`` ranks, by the integral over each rank's unit cell past
    them."""
    k = min(vocab, HEAD)
    head = torch.cumsum(torch.arange(1, k + 1, dtype=torch.float64,
                                     device=u.device).pow(-a), 0)
    s_k = float(head[-1])
    tail = (float(_tail_int(vocab + 0.5, a) - _tail_int(k + 0.5, a))
            if vocab > k else 0.0)
    t = u * (s_k + tail)
    ranks = torch.searchsorted(head, t).clamp_(max=k - 1) + 1
    if vocab > k:
        past = t > s_k
        y = _tail_inv(t[past] - s_k + float(_tail_int(k + 0.5, a)), a)
        ranks[past] = torch.ceil(y - 0.5).long().clamp_(k + 1, vocab)
    return ranks


def _signed(c: int) -> int:
    return c - (1 << 64) if c >= 1 << 63 else c


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """A logical right shift of int64 words."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def hash_ids(ranks: torch.Tensor, field: int, bucket: int) -> torch.Tensor:
    """Field ``field``'s ranks into ``[0, bucket)`` by splitmix64's
    finaliser of ``rank + field·2^40``: a fixed hash, as a token's."""
    z = ranks.long() + (field << 40) + _signed(_MIX[0])
    z = (z ^ _shr(z, 30)) * _signed(_MIX[1])
    z = (z ^ _shr(z, 27)) * _signed(_MIX[2])
    z = z ^ _shr(z, 31)
    return torch.remainder(_shr(z, 2), bucket)


def expected_distinct(vocab: int, rows: float, a: float) -> float:
    """The expected number of distinct values in ``rows`` draws from the
    Zipf law of exponent ``a`` over ``[1, vocab]``: exactly over the
    first ``HEAD`` ranks, past them the integral of ``1 − e^{−rows·p(x)}``
    in ``log x``."""
    k = min(vocab, HEAD)
    n = np.arange(1, k + 1, dtype=np.float64)
    total = (n ** -a).sum()
    if vocab > k:
        total += _tail_int(vocab + 0.5, a) - _tail_int(k + 0.5, a)
    seen = (-np.expm1(-rows * n ** -a / total)).sum()
    if vocab > k:
        lx = np.linspace(math.log(k + 0.5), math.log(vocab + 0.5), 4001)
        x = np.exp(lx)
        f = -np.expm1(-rows * x ** -a / total) * x
        seen += float(((f[1:] + f[:-1]) / 2 * np.diff(lx)).sum())
    return float(seen)


def vocab_for(distinct: int, rows: float, a: float) -> int:
    """The smallest vocabulary at or above ``distinct`` whose expected
    distinct values in ``rows`` draws reach ``distinct − 0.5``."""
    lo, hi = distinct, distinct
    while expected_distinct(hi, rows, a) < distinct - 0.5:
        lo, hi = hi, hi * 2
    while lo < hi:
        mid = (lo + hi) // 2
        if expected_distinct(mid, rows, a) < distinct - 0.5:
            lo = mid + 1
        else:
            hi = mid
    return hi


def unique_counts(ids: torch.Tensor) -> torch.Tensor:
    """Distinct ids per field of a ``[B, F]`` batch."""
    s, _ = torch.sort(ids, dim=0)
    return (s[1:] != s[:-1]).sum(0) + 1


def make_pool(mix: dict, num_fields: int, bucket: int, seed: int,
              device) -> tuple[list, np.ndarray]:
    """``(batches, unique)``: ``mix["pool"]`` numpy batches ``(ids int32
    [B, F], vals, labels, weights float32)`` in host memory, and the
    distinct ids per batch and field ``[pool, F]``. The configuration's
    ``num_fields`` take the mix's first fields."""
    b, fields = mix["batch"], mix["fields"][:num_fields]
    if len(fields) != num_fields:
        raise PoolError(f"the mix describes {len(mix['fields'])} fields; "
                        f"the configuration has {num_fields}")
    g = torch.Generator(device=device).manual_seed(int(seed))
    batches, unique = [], []
    for _ in range(mix["pool"]):
        ids = torch.empty(b, num_fields, dtype=torch.int32, device=device)
        for f, field in enumerate(fields):
            u = torch.rand(b, generator=g, dtype=torch.float64,
                           device=device)
            ranks = zipf_ranks(u, int(field["vocab"]), mix["zipf_a"])
            ids[:, f] = hash_ids(ranks, f, bucket).to(torch.int32)
        labels = (torch.rand(b, generator=g, device=device)
                  < mix["label_rate"]).float()
        unique.append(unique_counts(ids).cpu().numpy())
        batches.append((ids.cpu().numpy(),
                        np.full((b, num_fields), mix["vals"], np.float32),
                        labels.cpu().numpy(),
                        np.full(b, mix["weights"], np.float32)))
    unique = np.stack(unique)
    cap = mix.get("compact_cap", 0)
    if cap and unique.max() > cap:
        p, f = np.unravel_index(unique.argmax(), unique.shape)
        raise PoolError(f"batch {p} field {f} holds {unique.max()} distinct "
                        f"ids, past the mix's compact_cap {cap}")
    return batches, unique


class Cycle:
    """The pool as the loop's source: ``next_batch()`` hands out its
    batches in turn, forever."""

    def __init__(self, batches: list):
        self._batches = batches
        self._i = 0

    def next_batch(self):
        batch = self._batches[self._i % len(self._batches)]
        self._i += 1
        return batch
