"""Plain reference of the field-aware factorization machine (Juan et al.,
RecSys 2016, with one hashed table per field): its scores, its logistic
loss and its SGD step, in plain PyTorch in blocks of rows, in the
configuration's compute dtype as ``common.quantiser`` sets out.

Each field ``i`` owns a table of ``[bucket, F·k+1]`` rows: for each other
field ``j`` a factor ``v[i_i, j]`` of width ``k``, then the linear weight.
For a row with ids ``i_f`` and values ``x_f``::

    score = w0 + Σ_i w[i_i]·x_i + Σ_{i<j} ⟨v[i_i, j], v[i_j, i]⟩·x_i·x_j

so the gradient of factor ``v[i_i, j]`` (``j ≠ i``) is
``ds·x_i·x_j·v[i_j, i]``. SGD moves each distinct id of a field once by
``−lr`` times the sum of its lanes' gradients plus the regulariser, and
``w0`` by ``−lr·Σ ds``; the configuration's write rule applies.
"""

from __future__ import annotations

import torch

from benchmark.reference import common

#: Rows per block of the ``[rows, F, F, k]`` pairwise tensors.
BLOCK_ROWS = 8192


def _pairs(rows, x, lo: int, hi: int, fields: int, k: int):
    """``sel[b, i, j] = v[i_i, j]·x_i`` for rows ``lo:hi``, ``[b, F, F,
    k]``."""
    v = torch.stack([r[lo:hi, :fields * k].reshape(-1, fields, k)
                     for r in rows], dim=1)
    return v * x[lo:hi, :, None, None]


def step(state: dict, t: int, ids, vals, labels, weights, cfg: dict,
         seed: int, q):
    """One SGD step in place, in the compute dtype (``q``); returns the
    loss and the per-leaf norms of this step's gradient (``w0``, then
    each table)."""
    fields, k = cfg["num_fields"], cfg["rank"]
    fk = fields * k
    lr = cfg["learning_rate"]
    b = ids.shape[0]
    x = q(vals)
    rows = [q(tab[ids[:, f]].float()) for f, tab in enumerate(state["vw"])]
    pair = torch.empty(b, device=ids.device)
    eye = torch.eye(fields, dtype=torch.bool, device=ids.device)
    for lo in range(0, b, BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, b)
        sel = q(_pairs(rows, x, lo, hi, fields, k))
        a = q(sel * sel.transpose(1, 2)).sum(-1)             # [b, F, F]
        pair[lo:hi] = q(a.masked_fill(eye, 0.0).sum((1, 2)))
    scores = q(0.5 * pair)
    scores = q(scores + common.seq_sum(
        [q(r[:, fk] * x[:, f]) for f, r in enumerate(rows)], q))
    scores = q(scores + q(state["w0"]))
    loss, ds = common.logistic(scores, labels, weights, q)
    touched = (weights > 0).float()
    rf = q(torch.tensor(cfg["reg_factors"])).item()
    rl = q(torch.tensor(cfg["reg_linear"])).item()
    uniq, inv, acc = [], [], []
    for f in range(fields):
        u, i = torch.unique(ids[:, f], sorted=True, return_inverse=True)
        uniq.append(u)
        inv.append(i)
        acc.append(torch.zeros(u.numel(), fk + 1, dtype=torch.float64,
                               device=ids.device))
    for lo in range(0, b, BLOCK_ROWS):
        hi = min(lo + BLOCK_ROWS, b)
        sel = q(_pairs(rows, x, lo, hi, fields, k))
        # d score / d v[i_i, j] = (ds·(v[i_j, i]·x_j))·x_i, zero at j = i.
        dv = q(q(ds[lo:hi, None, None, None] * sel.transpose(1, 2))
               * x[lo:hi, :, None, None]).masked_fill(
                   eye[None, :, :, None], 0.0)
        for f in range(fields):
            r = rows[f][lo:hi]
            tch = touched[lo:hi, None]
            g = torch.empty_like(r)
            g[:, :fk] = q(dv[:, f].reshape(-1, fk)
                          + q(q(rf * r[:, :fk]) * tch))
            g[:, fk] = q(q(ds[lo:hi] * x[lo:hi, f])
                         + q(q(rl * r[:, fk]) * tch[:, 0]))
            acc[f].index_add_(0, inv[f][lo:hi], g.double() * -lr)
    bias = q(ds.double().sum().float())
    norms = [abs(float(bias))]
    for f, tab in enumerate(state["vw"]):
        totals = acc[f].float()
        norms.append(float(totals.double().norm()) / lr)
        common.write_rows(tab, f, t, uniq[f], totals, cfg, seed)
    state["w0"] -= lr * (bias + cfg["reg_bias"] * state["w0"])
    return loss, norms
