"""Tiered flat-FM trainer: stock sparse steps over a hot-bucket window
(the port of ``fm_spark_tpu/embed/tiered.py``).

:class:`TieredTrainer` owns a :class:`~fm_spark_tpu_torch.embed.store
.TieredStore` whose hot tier is sized ``config.hot_rows``, builds the
flat-FM step against a spec re-dimensioned to the hot tier
(``dataclasses.replace(spec, num_features=hot_rows)``), and per batch:
(1) makes the batch's buckets resident and translates global → hot-local
ids on the host, (2) runs the step (captured on the card) on the hot
planes with the local ids, its dedup keyed by the global ids.

The reference's claim holds: the tiered loss and param trajectory is
BITWISE the untiered one. Scores and the per-row updates depend only on
gathered row VALUES. The one order that depends on the ids is that of
each id's fp32 sum: JAX's ``segment_sum`` and the port's plain version
on the CPU add an id's lanes in lane order whatever its value, but
kernel A on the card associates by where a segment sits among the sorted
lanes (256-lane tiles, lane groups, carries folded in strided groups),
and relabelling global ids to hot-local ones moves every segment. So the
step sorts and segments by the batch's GLOBAL ids (``keys``): each
segment sits on the lanes it has in the untiered step, and adds on the
same bits (``ops.scatter._dedup_by``); the gathers and writes use the
local ids.

The FTRL/AdaGrad slot tables (z/n) ride the SAME residency map as the
params: one extra hot plane per slot table, evicted, flushed and
prefetched together.

Checkpoints go through the MERGED view (:meth:`TieredStore
.merged_planes`): params and slots are saved at full feature-axis shape,
so save/restore round-trips bitwise whatever was resident at save time,
and a restored run may use another ``hot_rows``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fm_spark_tpu_torch.embed.store import (ColdStore, TieredStore,
                                            from_host, host_dtype, to_host)

__all__ = ["TieredTrainer", "lazy_init_fn"]

#: Planes whose hot rows are fp32 optimizer slots, keyed by
#: (optimizer, use_linear) — the slot tables tier WITH the params.
_SLOT_PLANES = {
    ("ftrl", True): ("v_z", "v_n", "w_z", "w_n"),
    ("ftrl", False): ("v_z", "v_n"),
    ("adagrad", True): ("v_n", "w_n"),
    ("adagrad", False): ("v_n",),
    ("sgd", True): (),
    ("sgd", False): (),
}


def _as_plane(a, dtype) -> np.ndarray:
    """float32 values as a plane of ``dtype`` (a bf16 plane's bits rounded
    to nearest even, as torch casts)."""
    dtype = np.dtype(dtype)
    if dtype == host_dtype(torch.bfloat16):
        return to_host(torch.from_numpy(np.asarray(a, np.float32)).to(
            torch.bfloat16)).copy()
    return np.asarray(a).astype(dtype)


def lazy_init_fn(spec, seed: int, *, ftrl_seed: tuple | None = None):
    """Deterministic per-(plane, bucket) cold-row initialiser for
    :meth:`ColdStore.lazy` — the 100M/1B rungs, where materialising the
    full axis up front would defeat the tiering (the reference's, with
    its numpy streams).

    ``v`` buckets draw N(0, init_std²) from a counter-based stream keyed
    by (seed, plane, bucket): deterministic and re-materialisation-safe,
    but NOT the stream of ``spec.init``; only the DENSE cold mode carries
    the bitwise-parity contract. ``w`` and slot-``n`` buckets are zero;
    FTRL ``z`` buckets are seeded from the bucket's ``v`` rows by the
    closed form of :func:`fm_spark_tpu_torch.optim.ftrl_init_z`
    (``ftrl_seed`` = ``(alpha, beta)``).
    """
    init_std = float(spec.init_std)

    def init(plane: str, bucket: int, shape: tuple, dtype) -> np.ndarray:
        if plane == "v":
            rng = np.random.default_rng(
                np.random.SeedSequence([seed, 0xE0, bucket]))
            return _as_plane(rng.standard_normal(shape, np.float32)
                             * init_std, dtype)
        if plane == "v_z":
            alpha, beta = ftrl_seed
            return (-init("v", bucket, shape, np.float32)
                    * (beta / alpha)).astype(dtype)
        # w starts at zero, so its FTRL z seed and every n slot are zero.
        return np.zeros(shape, dtype)

    return init


class TieredTrainer:
    """Flat-FM training over the two-tier store, on ``device`` (the card
    unless ``device="cpu"``).

    ``TrainConfig`` contract: ``embed_tier`` in ("auto", "require"),
    ``hot_rows`` > 0 and a multiple of ``embed_bucket_rows``,
    ``optimizer`` in ("sgd", "ftrl", "adagrad"), float32 or bf16 tables
    (the spec's ``param_dtype`` in the cold and hot ``v``/``w`` planes, a
    bf16 cold plane kept as its 16-bit patterns; the slot planes float32,
    as the reference keeps them). The
    inner step factory receives ``embed_tier="off"`` — the trainer IS the
    thing the reject lever points at.

    ``cold="dense"`` materialises the full feature axis on the host (the
    differential/bitwise mode): the tables start from ``spec.init`` with
    a generator on ``device`` seeded by ``config.seed`` (FMTrainer's
    init), or from ``params``, a ``{"w0", "w", "v"}`` trio of numpy
    arrays (the CPU tests start from JAX's), with the slots derived from
    them. ``cold="lazy"`` materialises buckets on first touch
    (:func:`lazy_init_fn`; host RSS tracks the touched set).
    """

    def __init__(self, spec, config, *, cold: str = "dense",
                 beta: float = 1.0, l1: float = 0.0, l2: float = 0.0,
                 device=None, params=None):
        from fm_spark_tpu_torch import optim, resolve_device, sparse
        from fm_spark_tpu_torch.models.fm import FMSpec

        if type(spec) is not FMSpec:
            raise ValueError(
                "the tiered embedding store serves the flat FM family "
                "only (the fused field families reject embed_tier="
                "'require' for the same reason they reject fused_embed)")
        if config.embed_tier not in ("auto", "require"):
            raise ValueError(
                f"TieredTrainer expects embed_tier 'auto'|'require', "
                f"got {config.embed_tier!r}")
        if config.optimizer not in ("sgd",) + optim.ADAPTIVE_OPTIMIZERS:
            raise ValueError(
                f"the tiered store tiers the sparse step families only "
                f"(sgd/ftrl/adagrad); optimizer={config.optimizer!r}")
        bucket_rows = int(config.embed_bucket_rows)
        hot_rows = int(config.hot_rows)
        if hot_rows <= 0:
            raise ValueError(
                "embed_tier needs hot_rows > 0 (the HBM hot-tier "
                "capacity in rows)")
        if hot_rows % bucket_rows:
            raise ValueError(
                f"hot_rows={hot_rows} must divide by embed_bucket_rows="
                f"{bucket_rows} (the hot tier is managed in buckets)")
        if spec.num_features % bucket_rows:
            raise ValueError(
                f"num_features={spec.num_features} must divide by "
                f"embed_bucket_rows={bucket_rows}; pad the feature axis "
                "(hashed spaces are free to round up)")
        if hot_rows >= spec.num_features:
            raise ValueError(
                f"hot_rows={hot_rows} >= num_features="
                f"{spec.num_features}: nothing to tier — run the plain "
                "in-HBM trainer (embed_tier='off')")
        if spec.param_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"the tiered store holds float32 or bfloat16 tables; "
                f"param_dtype={spec.param_dtype!r}")
        if cold not in ("dense", "lazy"):
            raise ValueError(f"cold must be 'dense' or 'lazy', got {cold!r}")
        if params is not None and cold != "dense":
            raise ValueError("params= seeds the dense cold tier only")

        self.spec = spec
        self.config = config
        self.device = resolve_device(device)
        self.step_count = 0
        self.loss_history: list[float] = []
        opt = config.optimizer
        self._slot_planes = _SLOT_PLANES[(opt, spec.use_linear)]

        # Inner step over the hot-tier window: the spec re-dimensioned to
        # hot_rows, the config with the tier lever neutralised (this
        # trainer is what 'require' demands; the inner factory must not
        # re-reject it).
        hot_spec = dataclasses.replace(spec, num_features=hot_rows)
        inner_cfg = dataclasses.replace(config, embed_tier="off")
        if opt == "sgd":
            self._step = sparse.make_sparse_sgd_step(hot_spec, inner_cfg)
        else:
            self._step = optim.make_sparse_adaptive_step(
                hot_spec, inner_cfg, beta=beta, l1=l1, l2=l2)

        pdt = host_dtype(spec.pdtype)
        meta = {"v": ((spec.rank,), pdt), "w": ((), pdt)}
        for p in self._slot_planes:
            meta[p] = ((spec.rank,) if p.startswith("v") else (),
                       np.dtype(np.float32))
        w0 = np.zeros((), np.float32)
        if cold == "dense":
            if params is None:
                gen = torch.Generator(device=self.device).manual_seed(
                    config.seed)
                init = spec.init(gen, device=self.device)
                params = {k: to_host(t.cpu()) for k, t in init.items()}
                del init
            # The cold tier takes eviction write-backs: own the bytes (a
            # float32 array for a bf16 plane, JAX's widened params, is
            # rounded to its bits).
            planes = {k: (np.array(params[k]) if np.asarray(params[k]).dtype
                          == pdt else _as_plane(params[k], pdt))
                      for k in ("v", "w")}
            w0 = np.array(params["w0"], np.float32)
            if opt != "sgd":
                host = {k: from_host(planes[k]) for k in ("v", "w")}
                slots = optim.init_adaptive_slots(opt, spec, host)
                if opt == "ftrl":
                    slots = optim.seed_ftrl_slots(
                        slots, host, float(config.learning_rate), beta)
                for p in self._slot_planes:
                    table, slot = p.split("_")
                    planes[p] = slots[table][slot].numpy()
            self._cold = ColdStore.dense(planes, bucket_rows)
        else:
            self._cold = ColdStore.lazy(
                meta, bucket_rows, spec.num_features,
                lazy_init_fn(spec, config.seed,
                             ftrl_seed=(float(config.learning_rate),
                                        beta)))
        self.store = TieredStore(self._cold, hot_rows // bucket_rows,
                                 device=self.device)
        self.hot = self.store.init_hot()
        # One set of tensors for the trainer's life: the step is captured
        # over them, and installs, flushes and restores work in place.
        self._w0 = torch.from_numpy(w0).to(self.device)
        self._params = {"w0": self._w0, "w": self.hot["w"],
                        "v": self.hot["v"]}
        self._slots = None
        if self._slot_planes:
            self._slots = {}
            for p in self._slot_planes:
                table, slot = p.split("_")
                self._slots.setdefault(table, {})[slot] = self.hot[p]

    # ------------------------------------------------------------ step/fit

    def _tensor(self, a):
        return torch.as_tensor(np.asarray(a)).to(self.device)

    def step_batch(self, ids, vals, labels, weights) -> float:
        """One training step: residency and id translation on the host,
        then the step on the hot planes (local ids; the dedup keyed by
        the global ``ids``)."""
        ids = np.asarray(ids)
        local_ids, _ = self.store.begin_batch(ids, self.hot)
        batch = [self._tensor(a) for a in (local_ids, vals, labels, weights,
                                           ids)]
        if self._slots is None:
            _, loss = self._step(self._params, self.step_count, *batch)
        else:
            _, _, loss = self._step(self._params, self._slots, *batch)
        self.step_count += 1
        loss = float(loss)
        self.loss_history.append(loss)
        return loss

    def fit(self, batches, num_steps: int | None = None,
            checkpointer=None, prefetch: int = 0):
        """The tiered training loop; ``batches`` yields ``(ids, vals,
        labels, weights)``.

        With a checkpointer, state saves on its cadence as the MERGED
        full-axis view (plus the pipeline cursor via ``batches.state()``),
        and a prior run's latest checkpoint is restored first — the
        kill-and-resume contract of ``FMTrainer.fit``. ``prefetch >= 2``
        wraps the source in a :class:`~fm_spark_tpu_torch.embed.prefetch
        .BucketPrefetcher` AFTER resume (the producer must see the
        restored cursor). Returns the merged params (dense cold mode;
        None for a lazy store).
        """
        from fm_spark_tpu_torch.embed.prefetch import BucketPrefetcher

        total = (num_steps if num_steps is not None
                 else self.config.num_steps)
        if checkpointer is not None:
            if not (hasattr(batches, "state")
                    and hasattr(batches, "restore")):
                raise ValueError(
                    "checkpointed tiered training needs a resumable "
                    "batch source with state()/restore()")
            restored = self.restore_from(checkpointer)
            if restored is not None and restored.get("pipeline"):
                batches.restore(restored["pipeline"])
        source = batches
        pf = None
        if prefetch >= 2:
            pf = BucketPrefetcher(source, self.store, depth=prefetch)
            source = pf
        # The checkpointable cursor comes from SOURCE, not batches: the
        # prefetch producer runs ahead of training, and saving the
        # upstream's live cursor would skip the read-ahead batches on
        # resume (the prefetcher reports its last-CONSUMED snapshot).
        cursor = getattr(source, "state", None) or getattr(
            batches, "state", None)
        try:
            for batch in source:
                if self.step_count >= total:
                    break
                self.step_batch(*tuple(batch)[:4])
                if checkpointer is not None and \
                        checkpointer.due(self.step_count):
                    self.save_to(checkpointer, cursor())
            if checkpointer is not None:
                self.save_to(checkpointer, cursor(), force=True)
                checkpointer.wait()
        finally:
            if pf is not None:
                pf.close()
        return None if self._cold.is_lazy else self.merged_params()

    # ----------------------------------------------------- merged view I/O

    def merged_params(self) -> dict:
        """Full-axis ``{"w0", "w", "v"}`` numpy arrays — the checkpoint
        and eval view (dense cold mode only; a bf16 table as its bits,
        :func:`~fm_spark_tpu_torch.embed.store.from_host` reads them)."""
        merged = self.store.merged_planes(self.hot, ("v", "w"))
        return {"w0": self._w0.cpu().numpy().copy(),
                "w": merged["w"], "v": merged["v"]}

    def merged_slots(self) -> dict | None:
        if not self._slot_planes:
            return None
        merged = self.store.merged_planes(self.hot, self._slot_planes)
        slots: dict = {}
        for p in self._slot_planes:
            table, slot = p.split("_")
            slots.setdefault(table, {})[slot] = merged[p]
        return slots

    def merged_torch_params(self, device=None) -> dict:
        """:meth:`merged_params` as tensors on ``device`` (default the
        trainer's): what ``evaluate_params`` and ``save_model`` take."""
        dev = self.device if device is None else device
        return {k: from_host(np.array(a)).to(dev)
                for k, a in self.merged_params().items()}

    def save_to(self, checkpointer, pipeline_state=None,
                force: bool = False) -> None:
        merged = self.store.merged_planes(self.hot)
        params = {"w0": self._w0.cpu(),
                  "w": from_host(merged["w"]),
                  "v": from_host(merged["v"])}
        slots = None
        if self._slot_planes:
            slots = {}
            for p in self._slot_planes:
                table, slot = p.split("_")
                slots.setdefault(table, {})[slot] = torch.from_numpy(
                    merged[p])
        checkpointer.save(self.step_count, params, pipeline_state,
                          {"loss_history": list(self.loss_history)},
                          force=force, opt_state=slots)

    def restore_from(self, checkpointer) -> dict | None:
        """Load the latest checkpoint's merged view into the cold tier and
        reset residency (the hot planes zeroed in place); returns the
        restore dict or None."""
        restored = checkpointer.restore({"w0": None, "w": None, "v": None})
        if restored is None:
            return None
        params = restored["params"]
        planes = {"v": to_host(params["v"]), "w": to_host(params["w"])}
        for p in self._slot_planes:
            planes[p] = restored["opt_state"][p.replace("_", "/")].numpy()
        self.store.restore_cold(planes)
        self._w0.copy_(params["w0"])
        self.step_count = int(restored["step"])
        extra = restored.get("extra") or {}
        self.loss_history = list(extra.get("loss_history", []))
        return restored

    def predict(self, ids, vals):
        """Merged-view prediction (eval convenience; not the serving
        path — serving keeps its own card-resident generations)."""
        params = self.merged_torch_params()
        return self.spec.predict(params, self._tensor(ids),
                                 self._tensor(vals))
