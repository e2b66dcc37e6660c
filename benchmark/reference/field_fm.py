"""Plain reference of the field-partitioned factorization machine
(Rendle, ICDM 2010, with one hashed table per field): its scores, its
logistic loss and its SGD step, in plain PyTorch with no kernel, no
cache and no batching tricks, in the configuration's compute dtype as
``common.quantiser`` sets out.

Each field ``f`` owns a table of ``[bucket, k+1]`` rows, the factor
``v`` and the linear weight ``w`` side by side. For a row with ids
``i_f`` and values ``x_f``::

    score = w0 + Σ_f w[i_f]·x_f + ½ (‖Σ_f v[i_f]·x_f‖² − Σ_f ‖v[i_f]·x_f‖²)

SGD on the weighted mean loss moves each distinct id of a field once by
``−lr`` times the sum of its lanes' gradients (``ds·x_f·(s − v·x_f)``
plus the factor regulariser, and ``ds·x_f`` for the linear weight), and
``w0`` by ``−lr·Σ ds``. The write rule of the configuration applies
(``common.write_rows``).
"""

from __future__ import annotations

import torch

from benchmark.reference import common


def step(state: dict, t: int, ids, vals, labels, weights, cfg: dict,
         seed: int, q):
    """One SGD step in place, in the compute dtype (``q``); returns the
    loss and the per-leaf norms of this step's gradient (``w0``, then
    each table)."""
    k = cfg["rank"]
    lr = cfg["learning_rate"]
    seq = common.seq_sum
    x = q(vals)
    rows = [q(tab[ids[:, f]].float()) for f, tab in enumerate(state["vw"])]
    xv = [q(r[:, :k] * x[:, f:f + 1]) for f, r in enumerate(rows)]
    s = seq(xv, q)                                             # [B, k]
    sumsq = seq([q(q(v * v).sum(1)) for v in xv], q)
    scores = q(0.5 * q(q(q(s * s).sum(1)) - sumsq))
    scores = q(scores + seq([q(r[:, k] * x[:, f])
                             for f, r in enumerate(rows)], q))
    scores = q(scores + q(state["w0"]))
    loss, ds = common.logistic(scores, labels, weights, q)
    touched = (weights > 0).float()
    # g = ds·(s1 − mask·u·x)·x + rv·u·touched, s1 = [s, 1], each result
    # rounded; the linear column's mask leaves s1's 1.
    s1 = torch.cat([s, torch.ones_like(s[:, :1])], dim=1)
    rv = torch.full((k + 1,), q(torch.tensor(cfg["reg_factors"])).item(),
                    device=s.device)
    rv[k] = q(torch.tensor(cfg["reg_linear"])).item()
    bias = q(ds.double().sum().float())
    norms = [abs(float(bias))]
    for f, tab in enumerate(state["vw"]):
        u = rows[f]
        xu = q(u * x[:, f:f + 1])
        xu[:, k] = 0
        g = q(q(ds[:, None] * q(s1 - xu)) * x[:, f:f + 1])
        g = q(g + q(rv * u) * touched[:, None])
        uniq, totals = common.field_totals(ids[:, f], g, -lr)
        norms.append(float(totals.double().norm()) / lr)
        common.write_rows(tab, f, t, uniq, totals, cfg, seed)
    state["w0"] -= lr * (bias + cfg["reg_bias"] * state["w0"])
    return loss, norms
