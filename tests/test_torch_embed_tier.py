"""The port's tiered flat-FM trainer (``fm_spark_tpu_torch.embed``):
bitwise differentials, crash drills and levers, the cases of
``tests/test_embed_tier.py``, on the CPU; then against the JAX package.

- tiered == untiered bit for bit, with the hot tier over the whole
  working set and under eviction churn, for SGD and for FTRL and
  AdaGrad (their slot planes ride the residency map);
- a kill mid-eviction (``embed_evict``) and a device loss mid-prefetch
  (``embed_prefetch``) each resume bit for bit;
- ``tier_plan`` verdicts and reasons equal to JAX's, ``require`` refused
  by every non-tiered factory;
- the port's tiered run from JAX's init against JAX's tiered run after
  12 steps: ``rtol=1e-5, atol=1e-6`` for SGD, ``tests/test_torch_ftrl.py``'s
  tolerances for the adaptive steps (params ``rtol=1e-5`` with ``atol``
  1e-6, plus 1e-3·lr for AdaGrad; slots ``rtol=1e-5`` and 1e-4 of their
  largest value): the two sum an id's lanes in another order.

The faults plane's plans are not ported (``inject`` is a no-op), so the
drills patch ``faults.inject`` to raise at the named occurrence.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from fm_spark_tpu_torch import models, optim, sparse
from fm_spark_tpu_torch.checkpoint import Checkpointer
from fm_spark_tpu_torch.embed import TIERABLE_OPTIMIZERS, TieredTrainer, tier_plan
from fm_spark_tpu_torch.resilience import faults
from fm_spark_tpu_torch.train import TrainConfig, make_train_step

N_FEATURES = 2048
BUCKET_ROWS = 128            # 16 buckets
N_BUCKETS = N_FEATURES // BUCKET_ROWS
NNZ = 4
BATCH = 32


def make_spec():
    return models.FMSpec(num_features=N_FEATURES, rank=4, init_std=0.05)


def make_config(optimizer="sgd", hot_buckets=4, num_steps=12,
                embed_tier="require"):
    return TrainConfig(
        num_steps=num_steps, batch_size=BATCH, learning_rate=0.1,
        optimizer=optimizer, lr_schedule="constant", log_every=1000,
        embed_tier=embed_tier, hot_rows=hot_buckets * BUCKET_ROWS,
        embed_bucket_rows=BUCKET_ROWS, seed=0,
    )


def tiered(spec, config, **kw):
    return TieredTrainer(spec, config, device="cpu", **kw)


class SkewedBatches:
    """The reference test's deterministic, resumable source: each batch's
    ids in ``window`` consecutive buckets, the window drifting one bucket
    every ``drift_every`` batches; batch ``i`` a pure function of
    ``(seed, i)``."""

    def __init__(self, window=3, drift_every=2, seed=11):
        self.window = window
        self.drift_every = drift_every
        self.seed = seed
        self.i = 0

    def state(self):
        return {"i": self.i}

    def restore(self, st):
        self.i = int(st["i"])

    def _batch(self, i):
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, i]))
        base = (i // self.drift_every) % (N_BUCKETS - self.window)
        buckets = rng.integers(base, base + self.window, (BATCH, NNZ))
        offs = rng.integers(0, BUCKET_ROWS, (BATCH, NNZ))
        ids = (buckets * BUCKET_ROWS + offs).astype(np.int32)
        vals = rng.normal(0.0, 1.0, (BATCH, NNZ)).astype(np.float32)
        labels = (rng.random(BATCH) < 0.4).astype(np.float32)
        weights = np.ones(BATCH, np.float32)
        return ids, vals, labels, weights

    def __iter__(self):
        return self

    def __next__(self):
        b = self._batch(self.i)
        self.i += 1
        return b


def _init(spec, seed=0):
    return spec.init(torch.Generator().manual_seed(seed), device="cpu")


def untiered_run(spec, config, num_steps, src=None, **adaptive_kw):
    """The in-memory trajectory over the same stream from the same init
    (the tiered trainer's dense init on the CPU)."""
    cfg_off = dataclasses.replace(config, embed_tier="off")
    params = _init(spec, config.seed)
    src = src or SkewedBatches()
    losses = []
    if config.optimizer == "sgd":
        step = sparse.make_sparse_sgd_step(spec, cfg_off)
        for i in range(num_steps):
            batch = [torch.from_numpy(a) for a in next(src)]
            params, loss = step(params, i, *batch)
            losses.append(float(loss))
        return params, None, losses
    slots = optim.init_adaptive_slots(config.optimizer, spec, params)
    if config.optimizer == "ftrl":
        slots = optim.seed_ftrl_slots(
            slots, params, float(config.learning_rate),
            adaptive_kw.get("beta", 1.0))
    step = optim.make_sparse_adaptive_step(spec, cfg_off, **adaptive_kw)
    for _ in range(num_steps):
        batch = [torch.from_numpy(a) for a in next(src)]
        params, slots, loss = step(params, slots, *batch)
        losses.append(float(loss))
    return params, slots, losses


def assert_params_equal(tiered_params, reference):
    for k in ("w0", "w", "v"):
        assert np.array_equal(np.asarray(tiered_params[k]),
                              np.asarray(reference[k])), (
            f"tiered plane {k!r} diverged from the in-memory reference")


def assert_slots_equal(tiered_slots, reference):
    for table in reference:
        for slot in reference[table]:
            assert np.array_equal(np.asarray(tiered_slots[table][slot]),
                                  np.asarray(reference[table][slot])), (
                f"slot plane {table}.{slot} diverged")


class _InjectAt:
    """``faults.inject`` raising at the ``at``-th call of ``point`` (from
    1): a device loss, or a generic injected failure."""

    def __init__(self, point, at, device_loss=False):
        self.point, self.at, self.device_loss, self.n = (point, at,
                                                         device_loss, 0)

    def __call__(self, point):
        if point != self.point:
            return
        self.n += 1
        if self.n == self.at:
            if self.device_loss:
                raise faults.InjectedDeviceLoss(point, self.n)
            raise faults.FaultInjected(f"injected fault at {point}#{self.n}")


# ------------------------------------------------------ bitwise differentials


def test_tiered_sgd_bitwise_when_hot_fits_working_set():
    spec = make_spec()
    config = make_config("sgd", hot_buckets=6, num_steps=8)
    trainer = tiered(spec, config)
    src = SkewedBatches(drift_every=10 ** 9)  # static 3-bucket window
    for _ in range(8):
        trainer.step_batch(*next(src))
    assert trainer.store.stats()["evictions"] == 0
    ref, _, ref_losses = untiered_run(
        spec, config, 8, src=SkewedBatches(drift_every=10 ** 9))
    assert_params_equal(trainer.merged_params(), ref)
    assert trainer.loss_history == ref_losses


def test_tiered_sgd_bitwise_under_eviction_churn():
    spec = make_spec()
    config = make_config("sgd", hot_buckets=4, num_steps=12)
    trainer = tiered(spec, config)
    trainer.fit(SkewedBatches(), num_steps=12, prefetch=3)
    st = trainer.store.stats()
    assert st["evictions"] > 0, "churn sizing failed to force evictions"
    assert st["staged_hits"] > 0 and st["hit_rate"] > 0.0
    ref_params, _, ref_losses = untiered_run(spec, config, 12)
    assert_params_equal(trainer.merged_params(), ref_params)
    assert trainer.loss_history == ref_losses


@pytest.mark.parametrize("optimizer", ["ftrl", "adagrad"])
def test_tiered_adaptive_bitwise_under_churn(optimizer):
    spec = make_spec()
    config = make_config(optimizer, hot_buckets=4, num_steps=10)
    src = SkewedBatches()
    trainer = tiered(spec, config, beta=1.0)
    for _ in range(10):
        trainer.step_batch(*next(src))
    assert trainer.store.stats()["evictions"] > 0
    ref_params, ref_slots, ref_losses = untiered_run(spec, config, 10,
                                                     beta=1.0)
    assert_params_equal(trainer.merged_params(), ref_params)
    assert_slots_equal(trainer.merged_slots(), ref_slots)
    assert trainer.loss_history == ref_losses


@pytest.mark.parametrize("optimizer", ["sgd", "ftrl"])
def test_global_keys_equal_local_keys_on_the_cpu(optimizer):
    """On the CPU kernel A's plain version adds each id's lanes in lane
    order, so the dedup's keys do not change a bit: the step keyed by the
    local ids equals the one keyed by the global ids (on the card they
    differ; tests/test_torch_package.py shows both)."""
    spec = make_spec()
    hot_spec = dataclasses.replace(spec, num_features=4 * BUCKET_ROWS)
    cfg = make_config(optimizer, embed_tier="off")
    trainer = tiered(spec, make_config(optimizer))
    ids, vals, labels, w = next(SkewedBatches())
    local, _ = trainer.store.begin_batch(ids, trainer.hot)
    runs = []
    for keys in (None, ids):
        params = {k: t.clone() for k, t in trainer._params.items()}
        batch = [torch.from_numpy(a) for a in (local, vals, labels, w)]
        keys = None if keys is None else torch.from_numpy(keys)
        if optimizer == "sgd":
            step = sparse.make_sparse_sgd_step(hot_spec, cfg)
            _, loss = step(params, 0, *batch, keys)
        else:
            slots = {t: {s: x.clone() for s, x in d.items()}
                     for t, d in trainer._slots.items()}
            step = optim.make_sparse_adaptive_step(hot_spec, cfg)
            _, _, loss = step(params, slots, *batch, keys)
        runs.append((params, float(loss)))
    assert runs[0][1] == runs[1][1]
    for k in ("w0", "w", "v"):
        assert torch.equal(runs[0][0][k], runs[1][0][k]), k


def test_keyed_steps_make_no_host_sync():
    """The keyed dedup stays capturable (``NoHostSync``, the guard of
    every captured form)."""
    from tests.test_torch_capture import NoHostSync

    spec = dataclasses.replace(make_spec(), num_features=512)
    ids, vals, labels, w = [torch.from_numpy(a)
                            for a in next(SkewedBatches())]
    local = torch.remainder(ids, 512)
    for opt in ("sgd", "ftrl"):
        cfg = make_config(opt, embed_tier="off")
        params = _init(spec)
        if opt == "sgd":
            body = sparse.make_sparse_sgd_step(spec, cfg).body
            step = torch.tensor(3, dtype=torch.int32)
            with NoHostSync():
                _, loss = body(params, step, local, vals, labels, w, ids)
        else:
            slots = optim.init_adaptive_slots(opt, spec, params)
            body = optim.make_sparse_adaptive_step(spec, cfg).body
            with NoHostSync():
                _, _, loss = body(params, slots, local, vals, labels, w, ids)
        assert bool(torch.isfinite(loss))


def test_hot_planes_keep_their_storage_under_churn():
    spec = make_spec()
    trainer = tiered(spec, make_config("ftrl", num_steps=14))
    ptrs = {p: t.data_ptr() for p, t in trainer.hot.items()}
    trainer.fit(SkewedBatches(), num_steps=14, prefetch=2)
    assert trainer.store.stats()["evictions"] > 0
    assert {p: t.data_ptr() for p, t in trainer.hot.items()} == ptrs
    assert trainer._params["v"] is trainer.hot["v"]


# ------------------------------------------------------------- crash drills


def test_kill_mid_eviction_resumes_bitwise(tmp_path, monkeypatch):
    """``embed_evict`` fires BEFORE an eviction's dirty write-back — the
    kill-mid-eviction window; the resumed run lands bitwise on the
    uninterrupted trajectory."""
    spec = make_spec()
    config = make_config("ftrl", hot_buckets=4, num_steps=14)
    golden_params, golden_slots, golden_losses = untiered_run(
        spec, config, 14, beta=1.0)

    ckdir = str(tmp_path / "ck")
    t1 = tiered(spec, config, beta=1.0)
    ck1 = Checkpointer(ckdir, save_every=4)
    monkeypatch.setattr(faults, "inject",
                        _InjectAt("embed_evict", 5))
    with pytest.raises(faults.FaultInjected):
        t1.fit(SkewedBatches(), num_steps=14, checkpointer=ck1)
    monkeypatch.undo()
    killed_at = t1.step_count
    assert 0 < killed_at < 14, "fault must interrupt mid-run"
    ck1.close()
    assert os.listdir(ckdir), "no checkpoint survived the kill"
    del t1

    t2 = tiered(spec, config, beta=1.0)
    ck2 = Checkpointer(ckdir, save_every=4)
    t2.fit(SkewedBatches(), num_steps=14, checkpointer=ck2)
    ck2.close()
    assert t2.step_count == 14
    assert_params_equal(t2.merged_params(), golden_params)
    assert_slots_equal(t2.merged_slots(), golden_slots)
    assert t2.loss_history == golden_losses


def test_device_loss_mid_prefetch_restarts_bitwise(tmp_path, monkeypatch):
    """``embed_prefetch`` loses the device on the producer thread
    mid-staging: the loss surfaces at the consumer, and the restart is
    bit-identical to a clean run."""
    spec = make_spec()
    config = make_config("sgd", hot_buckets=4, num_steps=14)
    golden_params, _, golden_losses = untiered_run(spec, config, 14)

    ckdir = str(tmp_path / "ck")
    t1 = tiered(spec, config)
    ck1 = Checkpointer(ckdir, save_every=4)
    monkeypatch.setattr(faults, "inject", _InjectAt(
        "embed_prefetch", 7, device_loss=True))
    with pytest.raises(faults.InjectedDeviceLoss, match="device lost"):
        t1.fit(SkewedBatches(), num_steps=14, checkpointer=ck1, prefetch=2)
    monkeypatch.undo()
    assert 0 < t1.step_count < 14
    ck1.close()
    del t1

    t2 = tiered(spec, config)
    ck2 = Checkpointer(ckdir, save_every=4)
    t2.fit(SkewedBatches(), num_steps=14, checkpointer=ck2, prefetch=2)
    ck2.close()
    assert t2.step_count == 14
    assert_params_equal(t2.merged_params(), golden_params)
    assert t2.loss_history == golden_losses


def test_embed_fault_points_registered():
    assert {"embed_prefetch", "embed_evict"} <= set(faults.KNOWN_POINTS)


# ------------------------------------------------------------ lever plumbing


def _plan_cases():
    return [
        ("sgd", {}, "single"),
        ("sgd", {"embed_tier": "off"}, "single"),
        ("adam", {}, "single"),
        ("sgd", {}, "sharded"),
        ("sgd", {"hot_buckets": 0}, "single"),
        ("sgd", {"hot_buckets": N_BUCKETS}, "single"),
    ]


def test_tier_plan_verdicts_equal_jax():
    from fm_spark_tpu import models as jmodels
    from fm_spark_tpu.embed import tier_plan as jax_tier_plan
    from fm_spark_tpu.train import TrainConfig as JTrainConfig

    spec = make_spec()
    jspec = jmodels.FMSpec(num_features=N_FEATURES, rank=4, init_std=0.05)
    for opt, kw, strategy in _plan_cases():
        cfg = make_config(opt, **kw)
        jcfg = JTrainConfig(**dataclasses.asdict(cfg))
        got = tier_plan(spec, cfg, strategy)
        assert got == jax_tier_plan(jspec, jcfg, strategy)
    odd = dataclasses.replace(make_config("sgd"), hot_rows=BUCKET_ROWS + 1)
    assert tier_plan(spec, odd) == jax_tier_plan(
        jspec, JTrainConfig(**dataclasses.asdict(odd)))
    mode, reason = tier_plan(spec, make_config("sgd"), "single")
    assert mode == "tiered" and "hot" in reason
    fspec = models.FieldFMSpec(num_features=768, num_fields=3, bucket=256,
                               rank=4, init_std=0.05)
    mode, reason = tier_plan(fspec, make_config("sgd"))
    assert mode is None and "flat FM family" in reason


def test_tierable_optimizers_are_the_sparse_step_families():
    assert TIERABLE_OPTIMIZERS == ("sgd", "ftrl", "adagrad")


def test_require_rejected_by_every_non_tiered_factory():
    spec = make_spec()
    config = make_config("sgd")
    with pytest.raises(ValueError, match="TieredTrainer"):
        make_train_step(spec, config)
    with pytest.raises(ValueError, match="TieredTrainer"):
        sparse.make_sparse_sgd_step(spec, config)
    with pytest.raises(ValueError, match="fm_spark_tpu_torch.embed"):
        optim.make_sparse_adaptive_step(spec, make_config("ftrl"))
    fspec = models.FieldFMSpec(
        num_features=768, num_fields=3, bucket=256, rank=4, init_std=0.05)
    with pytest.raises(ValueError, match="TieredTrainer"):
        sparse.make_field_sparse_sgd_body(
            fspec, dataclasses.replace(config, hot_rows=256))


def test_trainer_validates_its_config():
    spec = make_spec()
    with pytest.raises(ValueError, match="auto.*require"):
        tiered(spec, make_config("sgd", embed_tier="off"))
    with pytest.raises(ValueError, match="sparse step"):
        tiered(spec, make_config("adam"))
    with pytest.raises(ValueError, match="hot_rows > 0"):
        tiered(spec, make_config("sgd", hot_buckets=0))
    with pytest.raises(ValueError, match="divide"):
        tiered(spec, dataclasses.replace(
            make_config("sgd"), hot_rows=BUCKET_ROWS + 1))
    with pytest.raises(ValueError, match="nothing to tier"):
        tiered(spec, make_config("sgd", hot_buckets=N_BUCKETS))
    fspec = models.FieldFMSpec(
        num_features=768, num_fields=3, bucket=256, rank=4, init_std=0.05)
    with pytest.raises(ValueError, match="flat FM"):
        tiered(fspec, make_config("sgd"))
    with pytest.raises(ValueError, match="param_dtype"):
        tiered(dataclasses.replace(spec, param_dtype="float16"),
               make_config("sgd"))


def test_invalid_embed_tier_value_rejected():
    spec = make_spec()
    config = dataclasses.replace(make_config("sgd"), embed_tier="maybe")
    with pytest.raises(ValueError, match="embed_tier"):
        sparse.make_sparse_sgd_step(spec, config)


def test_lazy_rung_trains_and_bounds_host_bytes():
    """The lazy cold store (the 100M/1B rungs' mode): host bytes track the
    touched buckets, not the axis."""
    spec = models.FMSpec(num_features=BUCKET_ROWS * 4096, rank=4,
                         init_std=0.05)
    trainer = tiered(spec, make_config("ftrl"), cold="lazy")
    assert trainer.fit(SkewedBatches(), num_steps=6, prefetch=2) is None
    cold = trainer.store.cold
    assert 0 < cold.touched_buckets() <= 8
    assert cold.host_bytes() == cold.touched_buckets() * BUCKET_ROWS * (
        4 * 4 * 3 + 4 * 3)       # v, v_z, v_n rows of 4; w, w_z, w_n
    assert all(np.isfinite(trainer.loss_history))


# ------------------------------------------------------ against the JAX port


def _jax_params(spec_kw, seed=0):
    import jax

    from fm_spark_tpu import models as jmodels

    p = jmodels.FMSpec(**spec_kw).init(jax.random.key(seed))
    return {k: np.array(v) for k, v in p.items()}


@pytest.mark.parametrize("optimizer", ["sgd", "ftrl", "adagrad"])
def test_tiered_run_matches_jax_tiered_run(optimizer):
    """12 steps under churn from JAX's init, the port's tiered trainer
    against the reference's."""
    from fm_spark_tpu import embed as jembed
    from fm_spark_tpu import models as jmodels
    from fm_spark_tpu.train import TrainConfig as JTrainConfig

    kw = dict(num_features=N_FEATURES, rank=4, init_std=0.05)
    config = make_config(optimizer, num_steps=12)
    init = _jax_params(kw, config.seed)
    jt = jembed.TieredTrainer(jmodels.FMSpec(**kw),
                              JTrainConfig(**dataclasses.asdict(config)))
    assert np.array_equal(np.asarray(jt.merged_params()["v"]), init["v"])
    tt = tiered(models.FMSpec(**kw), config,
                params={k: v.copy() for k, v in init.items()})
    js, ts = SkewedBatches(), SkewedBatches()
    for _ in range(12):
        jl = jt.step_batch(*next(js))
        tl = tt.step_batch(*next(ts))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)
    assert jt.store.stats()["evictions"] == tt.store.stats()["evictions"] > 0
    jp, tp = jt.merged_params(), tt.merged_params()
    atol = 1e-6 + (1e-3 * config.learning_rate
                   if optimizer == "adagrad" else 0.0)
    for k in ("w0", "w", "v"):
        np.testing.assert_allclose(tp[k], np.asarray(jp[k]), rtol=1e-5,
                                   atol=atol, err_msg=k)
    if optimizer != "sgd":
        jsl, tsl = jt.merged_slots(), tt.merged_slots()
        for table in jsl:
            for slot, want in jsl[table].items():
                want = np.asarray(want)
                np.testing.assert_allclose(
                    tsl[table][slot], want, rtol=1e-5,
                    atol=1e-4 * np.abs(want).max(), err_msg=f"{table}.{slot}")


# ------------------------------------------------------------------- the CLI


def _train(*extra):
    from fm_spark_tpu_torch import cli

    return cli.main(["train", "--config", "movielens_fm_r8", "--synthetic",
                     "4096", "--steps", "12", "--batch-size", "8",
                     "--log-every", "4", "--device", "cpu", *extra])


def test_cli_trains_over_the_tier_and_says_why_not(capsys, tmp_path):
    """``fmtorch train --embed-tier``: ``require`` trains over the store
    and evaluates its merged view; ``auto`` falls back saying why;
    ``require`` that cannot be served exits with the reason; a capacity
    without the lever, or not a whole number of buckets, is refused (the
    reference's lever checks)."""
    import json

    assert _train("--embed-tier", "require", "--hot-rows", "2048",
                  "--embed-bucket-rows", "128", "--model-out",
                  str(tmp_path / "m")) == 0
    out, err = capsys.readouterr()
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert [x["step"] for x in lines if "loss" in x] == [4, 8, 12]
    assert any("eval" in x for x in lines)
    summary = json.loads(err.strip().splitlines()[-1])
    assert summary["embed_tier"] == "tiered"
    assert summary["tier"]["lookups"] > 0
    assert os.path.exists(tmp_path / "m" / "params.npz")
    assert _train("--embed-tier", "auto") == 0
    assert "embed-tier auto: in-HBM fallback (hot_rows is unset" in \
        capsys.readouterr().err
    with pytest.raises(SystemExit, match="cannot be served: hot_rows"):
        _train("--embed-tier", "require")
    with pytest.raises(SystemExit, match="no effect without --embed-tier"):
        _train("--hot-rows", "2048")
    with pytest.raises(SystemExit, match="multiple of --embed-bucket-rows"):
        _train("--embed-tier", "require", "--hot-rows", "1000",
               "--embed-bucket-rows", "128")
    with pytest.raises(SystemExit, match="exclusive with --divergence"):
        _train("--embed-tier", "require", "--hot-rows", "2048",
               "--embed-bucket-rows", "128", "--divergence-guard",
               "--checkpoint-dir", str(tmp_path / "ck"))
    with pytest.raises(SystemExit, match="flat FM family"):
        from fm_spark_tpu_torch import cli

        cli.main(["train", "--config", "criteo1tb_fm_r64", "--bucket", "64",
                  "--synthetic", "512", "--steps", "1", "--embed-tier",
                  "require", "--hot-rows", "1024", "--device", "cpu"])
