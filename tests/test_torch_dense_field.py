"""The generic dense step of the field families (FieldFM in its three
table forms, FieldFFM, FieldDeepFM) against the JAX package's
``make_train_step`` (``FMTrainer``'s autodiff step), and ``fmtorch train
--strategy single|dp`` on a field config.

Shapes, cut small: 4 fields of 16 buckets, rank 4, B = 48 (with repeated
ids and zero-weight tail lanes), a (8, 8) head for FieldDeepFM; params
drawn by JAX and carried across.

Tolerances, and why: float32 tables after 3 steps of SGD (with the reg
triple) or Adam within ``rtol=1e-5, atol=1e-6`` of JAX's, and the loss
within ``rtol=1e-5``: XLA's autodiff adds a duplicated id's lanes in lane
order and the batch sums in its own order, the port in sorted order (the
dedup), a few float32 ulps per step. bf16 tables: JAX scatters each lane's
gradient in bf16, the port sums an id's lanes in float32 and rounds once,
so bits cannot match; each parameter is held by how far it moved,
``‖port − jax‖ ≤ 0.2·‖jax − init‖``, and the loss within ``1e-2``.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu import train as jtrain
from fm_spark_tpu_torch import cli, models
from fm_spark_tpu_torch import train as ptrain
from fm_spark_tpu_torch.models.io import flatten

F, BUCKET, K, B, STEPS = 4, 16, 4, 48, 3
FAMILIES = {
    "fm": ("FieldFMSpec", {}),
    "fm_unfused": ("FieldFMSpec", {"fused_linear": False}),
    "fm_col": ("FieldFMSpec", {"table_layout": "col"}),
    "ffm": ("FieldFFMSpec", {}),
    "deepfm": ("FieldDeepFMSpec", {"mlp_dims": (8, 8)}),
}


def _specs(family, pd="float32"):
    name, extra = FAMILIES[family]
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET, rank=K,
              param_dtype=pd, init_std=0.1, **extra)
    return getattr(jmodels, name)(**kw), getattr(models, name)(**kw)


def _jflat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = np.array(jnp.asarray(leaf).astype(jnp.float32))
    return out


def _params(jspec, pspec):
    jp = jspec.init(jax.random.key(0))
    flat = _jflat(jp)
    pp = models.params_from_numpy(
        pspec, {k: v.copy() for k, v in flat.items()}, "cpu")
    return jp, pp, flat


def _batches(seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        ids = (rng.zipf(1.3, (B, F)) % BUCKET).astype(np.int32)
        vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
        labels = rng.integers(0, 2, B).astype(np.float32)
        weights = np.ones(B, np.float32)
        weights[-5:] = 0.0
        out.append((ids, vals, labels, weights))
    return out


def _run(family, pd, optimizer):
    jspec, pspec = _specs(family, pd)
    cfg = dict(learning_rate=0.1, optimizer=optimizer, reg_bias=1e-3,
               reg_linear=1e-2, reg_factors=3e-2)
    if optimizer == "adam" or family == "fm_col":
        cfg.update(reg_bias=0.0, reg_linear=0.0, reg_factors=0.0)
    jc, pc = jtrain.TrainConfig(**cfg), ptrain.TrainConfig(**cfg)
    jp, pp, init = _params(jspec, pspec)
    jstep = jtrain.make_train_step(jspec, jc)
    jopt = jtrain.make_optimizer(jc).init(jp)
    pstep = ptrain.make_train_step(pspec, pc)
    popt = ptrain.make_optimizer(pc).init(pp)
    jl, pl = [], []
    for batch in _batches():
        jp, jopt, jm = jstep(jp, jopt, *(jnp.asarray(a) for a in batch))
        pp, popt, pm = pstep(pp, popt, *(torch.from_numpy(a.copy())
                                         for a in batch))
        jl.append(float(jm["loss"]))
        pl.append(float(pm["loss"]))
    return jl, pl, _jflat(jp), {k: v.float().numpy()
                                for k, v in flatten(pp).items()}, init


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_field_dense_step_matches_jax_fp32(family, optimizer):
    jl, pl, jflat, pflat, _ = _run(family, "float32", optimizer)
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    assert sorted(pflat) == sorted(jflat)
    for name, want in jflat.items():
        np.testing.assert_allclose(pflat[name], want, rtol=1e-5, atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("family", ["fm", "ffm", "deepfm"])
def test_field_dense_step_bf16_tracks_jax(family):
    jl, pl, jflat, pflat, init = _run(family, "bfloat16", "sgd")
    np.testing.assert_allclose(pl, jl, atol=1e-2)
    for name, want in jflat.items():
        moved = np.linalg.norm(want - init[name])
        assert np.linalg.norm(pflat[name] - want) <= 0.2 * moved + 1e-7, name


def test_field_dense_step_keeps_grad_norm():
    """``grad_norm`` is optax's global norm over every table."""
    jspec, pspec = _specs("fm")
    jc, pc = jtrain.TrainConfig(), ptrain.TrainConfig()
    jp, pp, _ = _params(jspec, pspec)
    batch = _batches()[0]
    _, _, jm = jtrain.make_train_step(jspec, jc)(
        jp, jtrain.make_optimizer(jc).init(jp),
        *(jnp.asarray(a) for a in batch))
    _, _, pm = ptrain.make_train_step(pspec, pc)(
        pp, ptrain.make_optimizer(pc).init(pp),
        *(torch.from_numpy(a.copy()) for a in batch))
    np.testing.assert_allclose(float(pm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)


@pytest.mark.parametrize("strategy", ["single", "dp"])
def test_cli_trains_a_field_config_by_the_dense_step(tmp_path, capsys,
                                                     strategy):
    """``--strategy single|dp`` on config 3 (narrowed by ``--bucket``)
    reaches its last step by the dense step, and the saved model evals."""
    out = tmp_path / "m"
    rc = cli.main(["train", "--config", "criteo1tb_fm_r64", "--bucket", "16",
                   "--synthetic", "600", "--steps", "3", "--batch-size",
                   "128", "--strategy", strategy, "--device", "cpu",
                   "--model-out", str(out), "--obs-dir", "none"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    steps = [x["step"] for x in lines if "loss" in x]
    assert steps and steps[-1] == 3
    assert any("eval" in x for x in lines)
    rc = cli.main(["eval", "--model", str(out), "--synthetic", "200",
                   "--device", "cpu"])
    assert rc == 0


def test_cli_strategy_row_refuses_a_field_config(capsys):
    with pytest.raises(SystemExit, match="row"):
        cli.main(["train", "--config", "criteo1tb_fm_r64", "--bucket", "16",
                  "--synthetic", "600", "--steps", "1", "--strategy", "row",
                  "--device", "cpu", "--obs-dir", "none"])
