"""Tiered billion-feature embedding store (the port of
``fm_spark_tpu/embed``).

A card-resident hot-bucket cache (:class:`TieredStore`) over a
host-memory cold tier (:class:`ColdStore`), with async batch-keyed
bucket prefetch (:class:`BucketPrefetcher`) and a trainer
(:class:`TieredTrainer`) that runs the flat-FM sparse steps over the hot
window — bitwise-identical to the in-memory path (``chip_smoke.py``
phase 20 holds it to that on the card, at config 2's widths from 10M to
1B features).

Selection mirrors the ``fused_embed`` lever's discipline exactly: ONE
queryable decision point (:func:`tier_plan`), callers either honor its
verdict or surface its reason — never a silent fallback.
"""

from __future__ import annotations

from fm_spark_tpu_torch.embed.prefetch import BucketPrefetcher
from fm_spark_tpu_torch.embed.store import ColdStore, TieredStore
from fm_spark_tpu_torch.embed.tiered import TieredTrainer, lazy_init_fn

__all__ = [
    "TIERABLE_OPTIMIZERS",
    "BucketPrefetcher",
    "ColdStore",
    "TieredStore",
    "TieredTrainer",
    "lazy_init_fn",
    "tier_plan",
]

#: Optimizers whose sparse step families the tiered trainer wraps.
TIERABLE_OPTIMIZERS = ("sgd", "ftrl", "adagrad")


def tier_plan(spec, config, strategy: str = "single") -> tuple:
    """The single decision point for the embed-tier lever.

    Returns ``("tiered", reason)`` when the tiered trainer serves this
    (spec, config, strategy), else ``(None, reason)`` naming exactly
    why not. Callers with ``embed_tier='require'`` turn a ``None`` into
    a hard failure carrying the reason; ``'auto'`` falls back to the
    in-HBM path and SAYS so — the same no-silent-fallback contract as
    :func:`fm_spark_tpu_torch.sparse.fused_embed_plan`.
    """
    from fm_spark_tpu_torch.models.fm import FMSpec

    if config.embed_tier not in ("auto", "require"):
        return None, f"embed_tier={config.embed_tier!r} does not ask for it"
    if type(spec) is not FMSpec:
        return None, (
            f"{type(spec).__name__} is not the flat FM family (the "
            "fused field families keep their in-HBM tables)")
    if strategy != "single":
        return None, (
            f"strategy {strategy!r} shards or replicates its tables; "
            "the hot-bucket residency protocol is single-attachment")
    if config.optimizer not in TIERABLE_OPTIMIZERS:
        return None, (
            f"optimizer {config.optimizer!r} has no tiered sparse step "
            f"(tierable: {TIERABLE_OPTIMIZERS})")
    if config.hot_rows <= 0:
        return None, "hot_rows is unset (the HBM hot-tier capacity)"
    if config.hot_rows % config.embed_bucket_rows:
        return None, (
            f"hot_rows={config.hot_rows} is not a multiple of "
            f"embed_bucket_rows={config.embed_bucket_rows}")
    if config.hot_rows >= spec.num_features:
        return None, (
            f"hot_rows={config.hot_rows} covers the whole "
            f"{spec.num_features}-row table — nothing to tier")
    return "tiered", (
        f"flat FM, optimizer={config.optimizer}, hot "
        f"{config.hot_rows}/{spec.num_features} rows in buckets of "
        f"{config.embed_bucket_rows}")
