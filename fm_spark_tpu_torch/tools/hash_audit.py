"""Hash-collision auditor for the bucket hash (the port of
``tools/hash_audit.py``, over the port's
``fm_spark_tpu_torch/data/hashing.murmur3_u64``).

The tiered embedding store's quality claim rests on the hashing trick:
at 10M/100M/1B buckets, how many distinct tokens silently share a row?
This tool MEASURES the collision rate of the production bucket fn —
``murmur3_u64(token) % m`` (data/hashing.py, the same x86_32 Murmur3
the text parsers and the C++ library implement bit-for-bit) — per
feature-axis decade, and compares it against the analytic
uniform-hashing expectation

    E[colliding tokens] = n − m·(1 − (1 − 1/m)^n)   ≈ n²/(2m) for n ≪ m

(n tokens into m buckets; a "colliding token" is one that landed in a
bucket some earlier token already occupied). A hash materially WORSE
than uniform at any decade would mean quality degrades faster than the
axis grows.

Usage::

    python -m fm_spark_tpu_torch.tools.hash_audit      # 1M tokens/decade
    python -m fm_spark_tpu_torch.tools.hash_audit --tokens 200000 \
        --decades 10000000
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

#: The embedding ladder's decades (the reference's bench_embed.py).
DECADES = (10_000_000, 100_000_000, 1_000_000_000)


def expected_collision_fraction(n: int, m: int) -> float:
    """Uniform-hashing expectation of the colliding-token fraction:
    ``(n − m·(1 − (1 − 1/m)^n)) / n``, computed in log space (the
    direct ``(1−1/m)^n`` underflows no decade here, but log1p keeps
    the small-n/m ratio exact to fp64)."""
    occupied = m * -np.expm1(n * np.log1p(-1.0 / m))
    return float((n - occupied) / n)


def audit_decade(n_tokens: int, m: int, seed: int = 0) -> dict:
    """Hash ``n_tokens`` distinct uint64 tokens into ``m`` buckets with
    the production fn; return measured vs expected collision stats."""
    from fm_spark_tpu_torch.data.hashing import murmur3_u64

    rng = np.random.default_rng(np.random.SeedSequence([seed, m]))
    # Distinct random uint64 tokens: collisions measured downstream of
    # the hash, never manufactured upstream of it.
    tokens = rng.choice(np.iinfo(np.int64).max, size=n_tokens,
                        replace=False).astype(np.uint64)
    buckets = murmur3_u64(tokens) % np.uint64(m)
    distinct = np.unique(buckets).size
    colliding = n_tokens - distinct
    expected = expected_collision_fraction(n_tokens, m)
    return {
        "buckets": m,
        "tokens": n_tokens,
        "colliding_tokens": int(colliding),
        "collision_rate": colliding / n_tokens,
        "expected_rate": expected,
        "ratio_vs_uniform": (colliding / n_tokens) / expected
        if expected > 0 else None,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hash_audit")
    ap.add_argument("--tokens", type=int, default=1_000_000,
                    help="distinct tokens hashed per decade")
    ap.add_argument("--decades", default=None,
                    help="comma-separated bucket counts (default: "
                         "10M,100M,1B — the embedding ladder)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--max-ratio", type=float, default=1.25,
                    dest="max_ratio",
                    help="fail (exit 1) if measured/expected exceeds "
                         "this at any decade (Poisson noise at 1B "
                         "buckets is ~±5%% on 1M tokens; 1.25 flags a "
                         "broken hash, not weather)")
    args = ap.parse_args(argv)

    decades = (tuple(int(d) for d in args.decades.split(",") if d)
               if args.decades else DECADES)
    rows = [audit_decade(args.tokens, m, args.seed) for m in decades]
    worst = max((r["ratio_vs_uniform"] or 0.0) for r in rows)
    result = {"tool": "hash_audit", "tokens": args.tokens,
              "rows": rows, "worst_ratio_vs_uniform": worst,
              "ok": worst <= args.max_ratio}
    print(json.dumps(result))
    return 0 if result["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
