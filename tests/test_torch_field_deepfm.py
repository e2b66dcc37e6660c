"""The port's FieldDeepFM model, model dirs, config and serving against the
JAX package, at a small size (4 fields, 32 buckets, rank 4, ``mlp_dims``
(16, 16, 16)).

Parameters are drawn by JAX and moved to the port through
``params_from_numpy`` or a model dir (the packages' generators differ).
Tolerances: float32 compute within ``rtol=1e-5, atol=1e-5`` (products
and sums in another order, as ``test_torch_field_fm.py``; measured 2e-7);
bf16 compute within ``atol=2⁻⁶``, one bf16 ulp of a score in [2, 4): the
MLP's bf16 products round float32 sums added in another order, which can
land on either side of a rounding boundary (measured equal).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu_torch import cli, configs, models
from fm_spark_tpu_torch.models.io import flatten
from fm_spark_tpu_torch.serve import PredictEngine

F, BUCKET, K = 4, 32, 4
MLP = (16, 16, 16)


def _kw(**kw):
    return dict(num_features=F * BUCKET, rank=K, num_fields=F, bucket=BUCKET,
                mlp_dims=MLP, init_std=0.3, **kw)


def _jax_params(spec):
    """JAX-initialised params with a random linear column and bias."""
    p = spec.init(jax.random.key(0))
    rng = np.random.default_rng(3)
    vw = [t.at[:, K].set(jnp.asarray(rng.normal(size=BUCKET) * 0.3, t.dtype))
          for t in p["vw"]]
    return {"w0": jnp.float32(0.2), "vw": vw, "mlp": p["mlp"]}


def _flat(jp) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): np.array(jnp.asarray(leaf, jnp.float32))
            for path, leaf in jax.tree_util.tree_leaves_with_path(jp)}


def _batch(n=37, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BUCKET, (n, F)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (n, F)).astype(np.float32)
    return ids, vals


@pytest.mark.parametrize("pd,cd", [("float32", "float32"),
                                   ("bfloat16", "float32"),
                                   ("bfloat16", "bfloat16")])
def test_scores_and_predict_match_jax(pd, cd):
    jspec = jmodels.FieldDeepFMSpec(**_kw(param_dtype=pd, compute_dtype=cd))
    pspec = models.FieldDeepFMSpec(**_kw(param_dtype=pd, compute_dtype=cd))
    jp = _jax_params(jspec)
    jp["vw"] = [t.astype(jspec.pdtype) for t in jp["vw"]]
    pp = models.params_from_numpy(pspec, _flat(jp), "cpu")
    ids, vals = _batch()
    want = np.asarray(jspec.scores(jp, jnp.asarray(ids), jnp.asarray(vals)),
                      np.float32)
    got = pspec.scores(pp, torch.from_numpy(ids), torch.from_numpy(vals))
    assert got.dtype == pspec.cdtype and got.shape == (len(ids),)
    tol = (dict(rtol=1e-5, atol=1e-5) if cd == "float32"
           else dict(rtol=0, atol=2.0**-6))
    np.testing.assert_allclose(got.float().numpy(), want, **tol)
    np.testing.assert_allclose(
        pspec.predict(pp, torch.from_numpy(ids),
                      torch.from_numpy(vals)).float().numpy(),
        np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals)),
                   np.float32), **tol)


def test_init_is_he_for_the_mlp_and_fieldfm_for_the_tables():
    spec = models.FieldDeepFMSpec(**_kw())
    p = spec.init(torch.Generator().manual_seed(0), device="cpu")
    dims = (F * K, *MLP, 1)
    assert [tuple(layer["kernel"].shape) for layer in p["mlp"]] == list(
        zip(dims[:-1], dims[1:]))
    assert all(float(layer["bias"].abs().max()) == 0 for layer in p["mlp"])
    assert len(p["vw"]) == F and tuple(p["vw"][0].shape) == (BUCKET, K + 1)
    assert float(p["vw"][0][:, K].abs().max()) == 0       # linear column
    big = models.FieldDeepFMSpec(**{**_kw(), "mlp_dims": (400,)})
    k0 = big.init(torch.Generator().manual_seed(0), "cpu")["mlp"][0]["kernel"]
    assert abs(float(k0.std()) - (2.0 / (F * K)) ** 0.5) < 0.05
    with pytest.raises(ValueError, match="num_fields\\*bucket"):
        models.FieldDeepFMSpec(**{**_kw(), "num_features": 7})


@pytest.mark.parametrize("pd", ["float32", "bfloat16"])
def test_model_dir_from_jax_loads_in_the_port_and_back(tmp_path, pd):
    jspec = jmodels.FieldDeepFMSpec(**_kw(param_dtype=pd))
    jp = _jax_params(jspec)
    jp["vw"] = [t.astype(jspec.pdtype) for t in jp["vw"]]
    jmodels.save_model(str(tmp_path / "jax"), jspec, jp)
    pspec, pp = models.load_model(str(tmp_path / "jax"), device="cpu")
    assert pspec == models.FieldDeepFMSpec(**_kw(param_dtype=pd))
    assert isinstance(pspec.mlp_dims, tuple)
    assert pp["vw"][0].dtype == pspec.pdtype
    assert pp["mlp"][0]["kernel"].dtype == torch.float32
    ids, vals = _batch()
    np.testing.assert_allclose(
        pspec.predict(pp, torch.from_numpy(ids), torch.from_numpy(vals))
        .numpy(),
        np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals))),
        rtol=1e-5, atol=1e-6)
    # The port's dir loads in JAX, array for array.
    models.save_model(str(tmp_path / "port"), pspec, pp)
    meta = json.loads((tmp_path / "port" / "spec.json").read_text())
    assert meta["family"] == "FieldDeepFMSpec"
    assert meta["param_dtypes"]["mlp/3/kernel"] == "float32"
    jspec2, jp2 = jmodels.load_model(str(tmp_path / "port"))
    assert jspec2 == jspec
    got = _flat(jp2)
    for name, t in flatten(pp).items():
        np.testing.assert_array_equal(got[name], t.float().numpy())


def test_run_config_five_builds_the_spec_and_the_recipe():
    cfg = configs.get_config("criteo1tb_deepfm")
    spec = cfg.spec()
    assert type(spec) is models.FieldDeepFMSpec
    assert (spec.num_fields, spec.bucket, spec.rank, spec.mlp_dims) == (
        39, 1 << 18, 16, (400, 400, 400))
    assert spec.table_width == 17
    t = cfg.train_config()
    assert (t.optimizer, t.learning_rate, t.lr_schedule, t.batch_size) == (
        "adam", 1e-3, "constant", 16384)
    narrow = configs.get_config("criteo1tb_deepfm", bucket=64).spec()
    assert narrow.num_features == 39 * 64
    with pytest.raises(ValueError, match="takes num_features from the data"):
        configs.get_config("movielens_fm_r8").spec()


def test_predict_engine_serves_deepfm_on_the_cpu():
    spec = models.FieldDeepFMSpec(**_kw())
    params = spec.init(torch.Generator().manual_seed(2), device="cpu")
    engine = PredictEngine(spec, params, nnz=F, buckets=(1, 8, 64),
                           latency_budget_ms=0.0, device="cpu")
    engine.warmup()
    ids, vals = _batch(n=50)
    want = spec.predict(params, torch.from_numpy(ids),
                        torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(engine.score(ids, vals), want, rtol=1e-6,
                               atol=1e-7)
    futures = [engine.submit(ids[i:i + 3], vals[i:i + 3])
               for i in range(0, 48, 3)]
    got = np.concatenate([f.result(timeout=60) for f in futures])
    np.testing.assert_allclose(got, want[:48], rtol=1e-6, atol=1e-7)
    params2 = spec.init(torch.Generator().manual_seed(4), device="cpu")
    gen = engine.swap_generation(params2, step=7)
    assert gen.step == 7
    np.testing.assert_allclose(
        engine.score(ids, vals),
        spec.predict(params2, torch.from_numpy(ids),
                     torch.from_numpy(vals)).numpy(), rtol=1e-6, atol=1e-7)
    engine.close()


def test_cli_trains_resumes_evals_and_predicts_config_five(tmp_path,
                                                          capsys):
    """``train --config criteo1tb_deepfm`` at a narrow bucket on the CPU
    with the registered recipe and a checkpoint chain: stopped at 2 and
    resumed to 4 equals 4 uninterrupted (loss lines and saved arrays),
    then ``eval`` and ``predict`` of the model dir."""
    common = ["train", "--config", "criteo1tb_deepfm", "--bucket", "32",
              "--synthetic", "1500", "--batch-size", "128",
              "--param-dtype", "bfloat16", "--compute-dtype", "bfloat16",
              "--sparse-update", "dedup_sr", "--host-dedup",
              "--compact-cap", "128", "--checkpoint-every", "2",
              "--test-fraction", "0.2", "--device", "cpu"]

    def run(*argv):
        assert cli.main(list(argv)) == 0
        out = capsys.readouterr().out
        return [json.loads(x) for x in out.splitlines() if x.startswith("{")]

    full = run(*common, "--steps", "4", "--checkpoint-dir",
               str(tmp_path / "a"), "--model-out", str(tmp_path / "m"))
    run(*common, "--steps", "2", "--checkpoint-dir", str(tmp_path / "b"))
    rest = run(*common, "--steps", "4", "--checkpoint-dir",
               str(tmp_path / "b"))
    losses = {x["step"]: x["loss"] for x in full if "loss" in x}
    resumed = {x["step"]: x["loss"] for x in rest if "loss" in x}
    assert sorted(resumed) == [3, 4]
    assert all(resumed[s] == losses[s] for s in resumed)
    assert [x["resumed"]["step"] for x in rest if "resumed" in x] == [2]
    for root, _, files in os.walk(tmp_path / "a" / "4"):
        for name in files:
            if name.endswith(".npy"):
                rel = os.path.relpath(os.path.join(root, name),
                                      tmp_path / "a")
                np.testing.assert_array_equal(np.load(tmp_path / "a" / rel),
                                              np.load(tmp_path / "b" / rel))
    assert (tmp_path / "a" / "4" / "opt" / "count.npy").exists()
    metrics = run("eval", "--model", str(tmp_path / "m"), "--synthetic",
                  "300", "--device", "cpu")[-1]
    assert metrics["count"] == 300 and np.isfinite(metrics["logloss"])
    run("predict", "--model", str(tmp_path / "m"), "--synthetic", "40",
        "--batch-size", "16", "--device", "cpu", "--out",
        str(tmp_path / "p.txt"))
    preds = np.loadtxt(tmp_path / "p.txt")
    assert preds.shape == (40,) and np.all((preds > 0) & (preds < 1))
