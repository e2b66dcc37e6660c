"""The port's flat DeepFM (``models/deepfm.py``): its scores, the dense
Adam step (``train.make_train_step``), the model dir and the served rows,
against the JAX package's ``DeepFMSpec`` at a small size: 4 fields, rank
4, 80 features, ``mlp_dims`` (16, 16, 16), B = 48.

Parameters are drawn by JAX and carried across by ``params_from_numpy``;
batches are numpy from a seed, with duplicate ids, zero-weight tail lanes
and ids out of range. The MLP's products are ``torch.matmul`` (the scores
over FieldDeepFM's fixed 64-row tiles, the step over the whole batch).

Tolerances, and why:

- scores: ``rtol=1e-5, atol=1e-6``; the matrix products and the batch
  sums add in different orders on the two sides.
- 5 dense Adam steps, float32, held as FieldDeepFM's are
  (``tests/test_torch_train_deepfm.py``): the loss within ``rtol=1e-6``,
  ``grad_norm`` within ``rtol=1e-5``, every parameter within
  ``rtol=1e-5`` and ``atol=1e-7 + 1e-3·lr``: Adam's update is
  scale-free, so where a gradient's batch sum cancels to a few ulps the
  summation order reaches ``m̂/√v̂`` itself.
- served rows: bit for bit, a row's score in a batch of 5 against the
  same row in a batch of 70 (two tiles): the head runs products of one
  shape whatever the batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu import train as jtrain
from fm_spark_tpu_torch import models
from fm_spark_tpu_torch import train as ptrain
from fm_spark_tpu_torch.models.io import flatten

B, F, K, N, STEPS = 48, 4, 4, 80, 5
MLP = (16, 16, 16)
LR = 0.01


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _specs(**kw):
    kw = dict(num_features=N, rank=K, num_fields=F, mlp_dims=MLP,
              init_std=0.1, **kw)
    return jmodels.DeepFMSpec(**kw), models.DeepFMSpec(**kw)


def _jflat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = _np(leaf)
    return out


def _params(jspec, pspec, seed=0):
    """JAX-initialised params with a random bias and linear weights, and
    the port's copy of them."""
    jp = jspec.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    jp["w0"] = jnp.float32(0.1)
    jp["w"] = jnp.asarray(rng.normal(size=N) * 0.2, jnp.float32)
    return jp, models.params_from_numpy(pspec, _jflat(jp), "cpu")


def _batch(seed, b=B):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, (b, F)) % N).astype(np.int32)
    ids[0, 0], ids[1, -1] = N + 3, -N - 4
    vals = rng.uniform(0.5, 1.5, (b, F)).astype(np.float32)
    labels = rng.integers(0, 2, b).astype(np.float32)
    weights = np.ones(b, np.float32)
    weights[-5:] = 0.0
    return ids, vals, labels, weights


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("use_bias,use_linear", [(True, True),
                                                 (False, False)])
def test_deepfm_scores_match_jax_and_check_the_slot_count(use_bias,
                                                          use_linear):
    jspec, pspec = _specs(use_bias=use_bias, use_linear=use_linear)
    jp, pp = _params(jspec, pspec)
    ids, vals, _, _ = _batch(1)
    for name in ("scores", "predict"):
        want = getattr(jspec, name)(jp, jnp.asarray(ids), jnp.asarray(vals))
        got = getattr(pspec, name)(pp, *_t((ids, vals)))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="nnz=3 slots .* num_fields=4"):
        pspec.scores(pp, *_t((ids[:, :3], vals[:, :3])))
    with pytest.raises(ValueError, match="num_fields > 0"):
        models.DeepFMSpec(num_features=4, rank=2)


def test_deepfm_init_is_he_init():
    spec = models.DeepFMSpec(num_features=N, rank=K, num_fields=F,
                             mlp_dims=(64, 64))
    p = spec.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(layer["kernel"].shape) for layer in p["mlp"]] == [
        (F * K, 64), (64, 64), (64, 1)]
    assert all(float(layer["bias"].abs().max()) == 0.0 for layer in p["mlp"])
    np.testing.assert_allclose(float(p["mlp"][1]["kernel"].std()),
                               np.sqrt(2.0 / 64), rtol=0.1)
    assert float(p["w"].abs().max()) == 0.0 and float(p["w0"]) == 0.0


@pytest.mark.parametrize("optimizer", ["adam", "ftrl"])
def test_dense_deepfm_steps_match_jax(optimizer):
    """Five dense steps: the FM part of the row gradient plus the MLP's
    input gradient (``sparse._mlp_backward``), each id's lanes summed once
    by the device dedup, the MLP's own gradients, the group L2 (``mlp``
    with ``reg_factors``) and the optimizer over every parameter."""
    jspec, pspec = _specs()
    kw = dict(learning_rate=LR, optimizer=optimizer, lr_schedule="constant",
              reg_bias=1e-4, reg_linear=1e-3, reg_factors=1e-3)
    jcfg, pcfg = jtrain.TrainConfig(**kw), ptrain.TrainConfig(**kw)
    jp, pp = _params(jspec, pspec)
    jopt, popt = jtrain.make_optimizer(jcfg), ptrain.make_optimizer(pcfg)
    jo, po = jopt.init(jp), popt.init(pp)
    jstep = jtrain.make_train_step(jspec, jcfg, jopt)
    pstep = ptrain.make_train_step(pspec, pcfg, popt)
    for i in range(STEPS):
        batch = _batch(10 + i)
        jp, jo, jm = jstep(jp, jo, *map(jnp.asarray, batch))
        pp, po, pm = pstep(pp, po, *_t(batch))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    want, got = _jflat(jp), {k: v.numpy() for k, v in flatten(pp).items()}
    assert sorted(want) == sorted(got)
    atol = 1e-7 + (1e-3 * LR if optimizer == "adam" else 0.0)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=atol, err_msg=name)


def test_deepfm_model_dir_crosses_both_ways(tmp_path):
    jspec, pspec = _specs(param_dtype="bfloat16")
    jp = jspec.init(jax.random.key(4))
    jmodels.save_model(str(tmp_path / "j"), jspec, jp)
    spec, params = models.load_model(str(tmp_path / "j"), device="cpu")
    assert spec == pspec and spec.mlp_dims == MLP
    assert params["v"].dtype == torch.bfloat16
    assert params["mlp"][0]["kernel"].dtype == torch.float32
    models.save_model(str(tmp_path / "p"), spec, params)
    jspec2, jp2 = jmodels.load_model(str(tmp_path / "p"))
    assert jspec2 == jspec
    for name, arr in _jflat(jp).items():
        np.testing.assert_array_equal(_jflat(jp2)[name], arr, err_msg=name)
    ids, vals, _, _ = _batch(5)
    np.testing.assert_allclose(
        spec.predict(params, *_t((ids, vals))).numpy(),
        _np(jspec2.predict(jp2, jnp.asarray(ids), jnp.asarray(vals))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_served_rows_do_not_depend_on_the_batch(cd):
    """A row scores to the same bits alone, in a batch of 5 and in one of
    70 (two of the head's 64-row tiles, the second padded)."""
    _, pspec = _specs(param_dtype=cd, compute_dtype=cd)
    params = pspec.init(torch.Generator().manual_seed(2), device="cpu")
    ids, vals, _, _ = _batch(6, b=70)
    ids, vals = _t((ids, vals))
    whole = pspec.scores(params, ids, vals)
    for lo, hi in ((0, 5), (3, 4), (64, 70), (60, 70)):
        part = pspec.scores(params, ids[lo:hi], vals[lo:hi])
        assert torch.equal(part, whole[lo:hi]), (lo, hi)


@pytest.mark.parametrize("family", ["ffm", "deepfm"])
def test_fmtorch_eval_predict_serve_take_a_jax_model_dir(tmp_path, capsys,
                                                         family):
    """A model dir of the flat FFM or DeepFM written by JAX goes through
    ``fmtorch eval``, ``predict`` and ``serve --model`` on its own
    synthetic rows; predict's lines equal JAX's predictions."""
    import json

    from fm_spark_tpu_torch import cli
    from fm_spark_tpu_torch.data import synthetic_ctr

    kw = dict(num_features=N, rank=K, num_fields=F, init_std=0.1)
    jspec = (jmodels.FFMSpec(**kw) if family == "ffm"
             else jmodels.DeepFMSpec(mlp_dims=MLP, **kw))
    jp = jspec.init(jax.random.key(7))
    model = str(tmp_path / "m")
    jmodels.save_model(model, jspec, jp)
    assert cli.main(["eval", "--model", model, "--synthetic", "200",
                     "--device", "cpu"]) == 0
    metrics = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert metrics["count"] == 200 and np.isfinite(metrics["logloss"])
    preds = str(tmp_path / "p.txt")
    assert cli.main(["predict", "--model", model, "--synthetic", "100",
                     "--batch-size", "32", "--out", preds,
                     "--device", "cpu"]) == 0
    ids, vals, _ = synthetic_ctr(100, N, F, seed=1)
    want = np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals)))
    np.testing.assert_allclose(np.loadtxt(preds), want, rtol=1e-5,
                               atol=1e-6)
    capsys.readouterr()
    assert cli.main(["serve", "--model", model, "--synthetic", "64",
                     "--batch-size", "16", "--buckets", "1,8,16",
                     "--reload-poll-s", "0", "--device", "cpu"]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["serve_summary"]["served_rows"] == 64
