"""What the plain references of the field families share: the tables'
initialisation, the logistic loss, the per-id write rules (a float32 add,
or a bf16 stochastic rounding drawn by JAX's threefry key schedule), and
the rounding of a lower precision that the control computes in.

Plain PyTorch only. Nothing here imports the program under test: each
rule is written from its published definition (Rendle's FM and Juan et
al.'s FFM objectives; JAX's ``threefry2x32`` and ``fold_in``).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: Offset of the stochastic-rounding key from the run's seed.
SR_SEED_OFFSET = 0x5EED
#: Offset of the projections' generator from the run's seed.
PROJ_SEED_OFFSET = 0x9207

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float8_e4m3fn": torch.float8_e4m3fn}


def plain_float32() -> None:
    """Matrix products in true float32: TF32 off for the reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def init_tables(cfg: dict, seed: int, width: int, device) -> dict:
    """``{"w0", "vw"}``: per field a ``[bucket, width]`` normal draw times
    ``init_std`` from one generator seeded with ``seed`` on ``device``,
    rounded to the stored dtype, then a zero linear column; ``w0`` a
    float32 zero."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    store = DTYPES[cfg["param_dtype"]]
    tables = []
    for _ in range(cfg["num_fields"]):
        v = (torch.randn(cfg["bucket"], width, generator=g, device=device)
             * cfg["init_std"]).to(store)
        tables.append(torch.cat(
            [v, torch.zeros(cfg["bucket"], 1, dtype=store, device=device)],
            dim=1))
    return {"w0": torch.zeros((), dtype=torch.float32, device=device),
            "vw": tables}


def quantiser(dtype: str):
    """``q(t)``: ``t`` rounded to the compute dtype ``dtype`` (nearest
    even) and held in float32; the identity for float32. A reference
    computes in the configuration's compute dtype as JAX's formulas do:
    each elementwise result is rounded once (``q`` after each operation),
    a sum over an axis accumulates in float32 and is rounded once, and a
    sum over fields adds left to right, each add rounded."""
    dt = DTYPES[dtype]
    if dt == torch.float32:
        return lambda t: t
    return lambda t: t.to(dt).to(torch.float32)


def seq_sum(terms, q):
    """Left to right, each add rounded (a sum over fields)."""
    acc = terms[0]
    for t in terms[1:]:
        acc = q(acc + t)
    return acc


def logistic(scores, labels, weights, q):
    """The weighted mean of ``logaddexp(0, s) − y·s`` and its gradient
    with respect to each score, in the compute dtype: ``logaddexp(0, s) =
    max(s, 0) + log1p(exp(−|s|))`` op by op, its derivative ``exp(s −
    out)``; the mean in float32. The gradient reaches the score by two
    paths, rounded apart and then added."""
    s = q(scores)
    soft = q(torch.log1p(q(torch.exp(q(-s.abs())))))
    out = q(q(torch.clamp(s, min=0)) + soft)
    wsum = torch.clamp(weights.sum(), min=1.0)
    loss = ((out - labels * s) * weights).sum() / wsum
    up = q(weights / wsum)
    ds = q(q(up * q(torch.exp(q(s - out)))) + q(-labels * weights / wsum))
    return loss, ds


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & M32


def threefry2x32(k0, k1, x0, x1):
    """JAX's 20-round threefry-2x32 of ``(x0, x1)`` under ``(k0, k1)``;
    the words are Python ints or int64 tensors holding 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def sr_bits(seed: int, step: int, field: int, n: int, device):
    """``jax.random.bits(fold_in(fold_in(key(seed), step), field), (n,))
    & 0xFFFF``: the low 16 bits added before a bf16 truncation."""
    k0, k1 = threefry2x32(0, int(seed) & M32, 0, int(step) & M32)
    k0, k1 = threefry2x32(k0, k1, 0, int(field) & M32)
    e = torch.arange(n, dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k0, k1, e >> 32, e & M32)
    return (b0 ^ b1) & 0xFFFF


def stochastic_bf16(x: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` to bf16 by adding ``bits`` (``[0, 65536)``) to its
    low half-word and truncating: round up with probability equal to the
    dropped fraction. Finite values that would carry to inf saturate."""
    raw = x.contiguous().view(torch.int32).to(torch.int64) & M32
    up = (raw + bits.reshape(x.shape)) & 0xFFFF0000
    up = torch.where(up >= 1 << 31, up - (1 << 32), up)
    out = up.to(torch.int32).view(torch.float32)
    big = torch.finfo(torch.bfloat16).max
    out = torch.where(torch.isfinite(out), out, torch.sign(x) * big)
    return out.to(torch.bfloat16)


def write_rows(table, field: int, step: int, uniq, totals, cfg: dict,
               seed: int) -> None:
    """Apply one field's per-id float32 totals of ``−lr·g`` to the ids
    ``uniq`` (ascending): ``dedup_sr`` on a bf16 table rounds ``old +
    total`` stochastically with the bits of slot ``rank(id)·width + c``;
    every other case adds in float32 and rounds to the table's dtype."""
    old = table[uniq].float()
    if cfg["sparse_update"] == "dedup_sr" and table.dtype == torch.bfloat16:
        bits = sr_bits(seed + SR_SEED_OFFSET, step, field, totals.numel(),
                       table.device)
        table[uniq] = stochastic_bf16(old + totals, bits)
    else:
        table[uniq] = (old + totals).to(table.dtype)


def field_totals(ids_col, grads, neg_lr: float):
    """``(uniq, totals)``: the ascending distinct ids of one field's
    column and, per id, the float32 sum of ``neg_lr·g`` over its lanes
    (summed in float64)."""
    uniq, inv = torch.unique(ids_col, sorted=True, return_inverse=True)
    acc = torch.zeros(uniq.numel(), grads.shape[1], dtype=torch.float64,
                      device=grads.device)
    acc.index_add_(0, inv, grads.double() * neg_lr)
    return uniq, acc.float()


def _leaves(state: dict) -> list:
    return [state["w0"], *state["vw"]]


def leaf_norms(a: list, b: list) -> list[float]:
    """Per leaf the float64 2-norm of ``a − b``."""
    return [float((x.double() - y.double()).norm()) for x, y in zip(a, b)]


def projections(a: list, b: list, seed: int) -> list[float]:
    """Per leaf ``⟨a − b, R⟩`` in float64, ``R`` a standard normal draw of
    the leaf's shape from one generator seeded with ``seed +
    PROJ_SEED_OFFSET`` on the leaves' device, leaf after leaf: the same
    ``R`` on both sides of a comparison, so a change that keeps each
    leaf's norm but moves its rows reads apart."""
    g = torch.Generator(device=a[0].device).manual_seed(
        int(seed) + PROJ_SEED_OFFSET)
    out = []
    for x, y in zip(a, b):
        r = torch.randn(x.shape, generator=g, device=x.device)
        out.append(float(((x.double() - y.double()) * r).sum()))
    return out


def follow(step_fn, cfg: dict, seed: int, batches, *, steps: int = 3,
           lower: str | None = None, device=None) -> dict:
    """The family's plain SGD from its initial tables over ``batches``
    (numpy ``(ids, vals, labels, weights)``, one per step): each step's
    loss, the per-leaf norm of the first gradient as worked out from the
    state after one step (``‖p1 − p0‖ / lr``), the per-leaf norm of the
    change after ``steps`` (``‖p_steps − p0‖``) and its projection
    (:func:`projections`), and the per-leaf norm of the first step's true
    float32 gradient. Leaves: ``w0``, then each
    field's table. The step computes in the configuration's compute
    dtype, or in ``lower`` (the control's precision)."""
    plain_float32()
    width = cfg["rank"] * (cfg["num_fields"] if cfg["family"] == "field_ffm"
                           else 1)
    state = init_tables(cfg, seed, width, device)
    p0 = [t.clone() for t in _leaves(state)]
    q = quantiser(lower or cfg["compute_dtype"])
    out = {"loss": [], "grad": None, "change": None, "true_grad": None}
    with torch.no_grad():
        for t in range(steps):
            ids, vals, labels, weights = (torch.as_tensor(a, device=device)
                                          for a in batches[t])
            loss, true_grad = step_fn(state, t, ids.long(), vals.float(),
                                      labels.float(), weights.float(), cfg,
                                      seed, q)
            out["loss"].append(float(loss))
            if t == 0:
                out["true_grad"] = true_grad
                out["grad"] = [n / cfg["learning_rate"] for n in
                               leaf_norms(_leaves(state), p0)]
        out["change"] = leaf_norms(_leaves(state), p0)
        out["change_proj"] = projections(_leaves(state), p0, seed)
    return out
