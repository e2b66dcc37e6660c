"""bf16 tables where the port held float32 only: the tiered store's bf16
planes against the untiered step bit for bit, and L-BFGS over bf16 tables
against optax's.

- Tiered: a flat FM of 2,048 features in 16 buckets of 128 rows, a hot
  tier of 4 buckets under eviction churn (the window of 3 buckets drifts
  one bucket every 2 batches), 12 steps of SGD, FTRL and AdaGrad with bf16
  ``v``/``w`` planes and float32 slots: every loss, merged plane and slot
  equal to the untiered captured-form step's, bit for bit (the step is the
  same and its dedup is keyed by the global ids). A checkpoint of the
  merged view restores bit for bit, and the cold tier's write-back reads
  back its bf16 bits.
- L-BFGS: the reference's ``fit_lbfgs`` cannot run bf16 tables: optax
  0.2.6 keeps the linesearch's value in the first leaf's dtype (bf16)
  while the objective returns float32, and ``value_and_grad_from_state``'s
  ``lax.cond`` raises a TypeError (pinned below). So the port's
  ``fit_lbfgs`` from bf16 params of a flat FM (40 features, rank 4, 256
  rows, the reg pair, 8 iterations, 5 corrections) is held against
  optax's ``lbfgs`` driven as the reference drives it with the one change
  that lets it run, the objective's value cast to bf16: the final
  objective within ``rtol=1e-2`` and each table within
  ``0.05·‖optax − init‖`` of optax's (measured 0.1 % and 1.4-1.8 %). The
  port keeps its linesearch scalars float32 where optax's round to bf16,
  and rounds the stored vectors where optax does.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fm_spark_tpu_torch import lbfgs, models
from fm_spark_tpu_torch.checkpoint import Checkpointer
from fm_spark_tpu_torch.embed.store import ColdStore, from_host, to_host

import test_torch_embed_tier as tier


def _bits(t):
    t = t if isinstance(t, torch.Tensor) else from_host(np.asarray(t))
    if t.dtype == torch.bfloat16:
        return to_host(t.detach().cpu()).copy()
    return t.detach().cpu().numpy().copy()


def _spec():
    return dataclasses.replace(tier.make_spec(), param_dtype="bfloat16")


@pytest.mark.parametrize("optimizer", ["sgd", "ftrl", "adagrad"])
def test_bf16_tiered_matches_untiered_bitwise(optimizer):
    spec = _spec()
    config = tier.make_config(optimizer, hot_buckets=4)
    ref, ref_slots, ref_losses = tier.untiered_run(spec, config, 12)
    assert ref["v"].dtype == torch.bfloat16
    tr = tier.tiered(spec, config)
    assert tr.hot["v"].dtype == torch.bfloat16
    if optimizer != "sgd":
        assert all(tr.hot[p].dtype == torch.float32
                   for p in tr._slot_planes)
    tr.fit(tier.SkewedBatches(), num_steps=12)
    assert tr.store.stats()["evictions"] > 0
    assert tr.loss_history == ref_losses
    merged = tr.merged_params()
    for k in ("w0", "w", "v"):
        assert np.array_equal(_bits(merged[k]), _bits(ref[k])), k
    if ref_slots is not None:
        slots = tr.merged_slots()
        for table in ref_slots:
            for slot in ref_slots[table]:
                assert np.array_equal(slots[table][slot],
                                      ref_slots[table][slot].numpy())


def test_bf16_tier_checkpoint_and_write_back_round_trip(tmp_path):
    spec = _spec()
    config = tier.make_config("ftrl", hot_buckets=4)
    tr = tier.tiered(spec, config)
    ck = Checkpointer(str(tmp_path / "ck"), save_every=4)
    src = tier.SkewedBatches()
    tr.fit(src, num_steps=8, checkpointer=ck)
    want = {k: _bits(v) for k, v in tr.merged_params().items()}
    back = tier.tiered(spec, config)
    restored = back.restore_from(ck)
    ck.close()
    assert restored["params"]["v"].dtype == torch.bfloat16
    got = {k: _bits(v) for k, v in back.merged_params().items()}
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    tr.store.cold.write_back(str(tmp_path / "cold"))
    cold = ColdStore.read_back(str(tmp_path / "cold"))
    assert np.array_equal(cold.dense_plane("v"),
                          tr.store.cold.dense_plane("v"))
    assert from_host(cold.dense_plane("v")).dtype == torch.bfloat16


def test_bf16_lazy_cold_tier_rounds_its_init():
    spec = _spec()
    config = tier.make_config("sgd", hot_buckets=4)
    tr = tier.TieredTrainer(spec, config, cold="lazy", device="cpu")
    tr.fit(tier.SkewedBatches(), num_steps=4)
    v = tr.store.cold.read_bucket("v", 0)
    assert v.dtype == np.uint16 and v.shape == (tier.BUCKET_ROWS, 4)
    assert np.isfinite(from_host(v).float().numpy()).all()


# ------------------------------------------------------------------ L-BFGS


def _lbfgs_case():
    import jax
    import jax.numpy as jnp

    from fm_spark_tpu import models as jmodels

    kw = dict(num_features=40, rank=4, param_dtype="bfloat16",
              init_std=0.1)
    jspec, pspec = jmodels.FMSpec(**kw), models.FMSpec(**kw)
    jp = jspec.init(jax.random.key(0))
    rng = np.random.default_rng(3)
    ids = rng.integers(0, 40, (256, 5)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (256, 5)).astype(np.float32)
    labels = rng.integers(0, 2, 256).astype(np.float32)
    flat = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in
            jp.items()}
    pp = models.params_from_numpy(pspec, {k: v.copy() for k, v in
                                          flat.items()}, "cpu")
    return jspec, pspec, jp, pp, flat, (ids, vals, labels)


def _optax_bf16(jspec, jp, data, config, iterations, corrections):
    """optax 0.2.6's lbfgs as ``fm_spark_tpu.lbfgs.fit_lbfgs`` drives it,
    one iteration per call, the objective's value cast to bf16."""
    import jax.numpy as jnp
    import optax

    from fm_spark_tpu import lbfgs as jlbfgs

    ids, vals, labels = (jnp.asarray(a) for a in data)
    objective = jlbfgs.make_objective(jspec, config, ids, vals, labels,
                                      jnp.ones(labels.shape))

    def value_fn(p):
        return objective(p).astype(jnp.bfloat16)

    opt = optax.lbfgs(memory_size=corrections)
    vag = optax.value_and_grad_from_state(value_fn)
    state, params = opt.init(jp), jp
    for _ in range(iterations):
        value, grad = vag(params, state=state)
        updates, state = opt.update(grad, state, params, value=value,
                                    grad=grad, value_fn=value_fn)
        params = optax.apply_updates(params, updates)
    return params, float(objective(params))


def test_reference_lbfgs_raises_on_bf16_tables():
    from fm_spark_tpu import lbfgs as jlbfgs

    jspec, _, jp, _, _, data = _lbfgs_case()
    with pytest.raises(TypeError, match="cond branches"):
        jlbfgs.fit_lbfgs(jspec, jp, *data, num_iterations=2)


def test_bf16_lbfgs_tracks_optax():
    import jax.numpy as jnp

    from fm_spark_tpu import train as jtrain
    from fm_spark_tpu_torch import train as ptrain

    jspec, pspec, jp, pp, init, data = _lbfgs_case()
    reg = dict(reg_factors=1e-2, reg_linear=1e-3)
    jparams, jloss = _optax_bf16(jspec, jp, data, jtrain.TrainConfig(**reg),
                                 8, 5)
    pparams, pinfo = lbfgs.fit_lbfgs(pspec, pp, *data,
                                     config=ptrain.TrainConfig(**reg),
                                     num_iterations=8, num_corrections=5)
    assert pparams["v"].dtype == torch.bfloat16
    assert pinfo["iterations"] == 8
    np.testing.assert_allclose(pinfo["loss"], jloss, rtol=1e-2)
    for key in ("w", "v"):
        want = np.asarray(jnp.asarray(jparams[key], jnp.float32))
        got = pparams[key].float().numpy()
        moved = np.linalg.norm(want - init[key])
        assert np.linalg.norm(got - want) <= 0.05 * moved, key
