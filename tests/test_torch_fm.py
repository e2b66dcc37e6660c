"""The port's flat FM (``ops/fm.py``'s ``fm_scores`` family and
``models.FMSpec``) against the JAX package, at a small size: 50
features, rank 4, batches of 32 rows of 3 ids.

Parameters are drawn by JAX (with a random linear part and bias) and
carried across by ``params_from_numpy``; ids, values and labels are numpy
from a seed, with non-unit values, padded slots (value 0) and ids out of
range on both sides.

Tolerances, and why: float32 scores within ``rtol=1e-6, atol=1e-6`` of
JAX's (the two sides sum the same float32 terms in another order: a few
ulps); with bf16 tables and float32 compute the same (the rows are
widened exactly); with bf16 compute within 2⁻⁷ relative plus 2⁻⁷ absolute
(the sums accumulate in float32 and round once on both sides, but the
products round to bf16 in another order). The float64 oracle equals JAX's
to 1e-12, and float32 scores are within 1e-5 of it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu.ops import fm as jfm
from fm_spark_tpu_torch import models
from fm_spark_tpu_torch.ops import fm as pfm

N, K, B, NNZ = 50, 4, 32, 3


def _specs(**kw):
    kw = dict(num_features=N, rank=K, init_std=0.1, **kw)
    return jmodels.FMSpec(**kw), models.FMSpec(**kw)


def _params(jspec, pspec, seed=0):
    """JAX-initialised params with a random linear part and bias, and the
    port's copy of them."""
    jp = jspec.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    flat = {"w0": np.float32(0.3),
            "w": (rng.normal(size=N) * 0.2).astype(np.float32),
            "v": np.asarray(jp["v"].astype(jnp.float32))}
    jp = {"w0": jnp.float32(0.3), "w": jnp.asarray(flat["w"]).astype(
        jspec.pdtype), "v": jp["v"]}
    return jp, models.params_from_numpy(pspec, flat, "cpu")


def _batch(seed=1, bad_ids=True):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, N, (B, NNZ)).astype(np.int32)
    if bad_ids:
        ids[0, 0], ids[1, 1], ids[2, 2], ids[3, 0] = -3, N + 7, -N - 2, -N
    vals = rng.uniform(0.5, 1.5, (B, NNZ)).astype(np.float32)
    vals[4, 2] = 0.0                                   # a padded slot
    return ids, vals


def _close(got, want, cd):
    if cd == "bfloat16":
        np.testing.assert_allclose(got, want, rtol=2**-7, atol=2**-7)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("pd,cd", [("float32", "float32"),
                                   ("bfloat16", "float32"),
                                   ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("use_bias,use_linear", [(True, True), (False, True),
                                                 (True, False),
                                                 (False, False)])
def test_scores_and_predict_match_jax(pd, cd, use_bias, use_linear):
    """Every ``dim`` gate, with non-unit values and ids out of range (an id
    in ``[-n, 0)`` counts from the end, any other clamps)."""
    jspec, pspec = _specs(param_dtype=pd, compute_dtype=cd,
                          use_bias=use_bias, use_linear=use_linear)
    jp, pp = _params(jspec, pspec)
    ids, vals = _batch()
    want = np.asarray(jspec.scores(jp, jnp.asarray(ids), jnp.asarray(vals)),
                      np.float32)
    got = pspec.scores(pp, torch.from_numpy(ids), torch.from_numpy(vals))
    _close(got.float().numpy(), want, cd)
    wantp = np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals)),
                       np.float32)
    gotp = pspec.predict(pp, torch.from_numpy(ids), torch.from_numpy(vals))
    _close(gotp.float().numpy(), wantp, cd)


def test_regression_predictions_clip_to_the_learned_range():
    kw = dict(task="regression", min_target=0.1, max_target=0.5)
    jspec, pspec = _specs(**kw)
    jp, pp = _params(jspec, pspec)
    ids, vals = _batch(bad_ids=False)
    want = np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals)))
    got = pspec.predict(pp, torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert got.min() >= 0.1 and got.max() <= 0.5
    assert (got == 0.1).any() and (got == 0.5).any()


def test_fm_scores_ops_match_jax_and_the_dense_oracle():
    """``fm_scores`` on raw tables against JAX's and against the float64
    O(n²) oracle of Rendle's definition (each side's oracle equal)."""
    rng = np.random.default_rng(3)
    w0 = np.float32(0.2)
    w = rng.normal(size=N).astype(np.float32)
    v = (rng.normal(size=(N, K)) * 0.3).astype(np.float32)
    ids, vals = _batch(seed=4, bad_ids=False)
    want = np.asarray(jfm.fm_scores(jnp.float32(w0), jnp.asarray(w),
                                    jnp.asarray(v), jnp.asarray(ids),
                                    jnp.asarray(vals)))
    got = pfm.fm_scores(torch.tensor(w0), torch.from_numpy(w),
                        torch.from_numpy(v), torch.from_numpy(ids),
                        torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    x = np.zeros((B, N), np.float64)
    for b in range(B):
        for i, val in zip(ids[b], vals[b]):
            x[b, i] += val
    oracle = pfm.fm_scores_dense(w0, w, v, x)
    np.testing.assert_allclose(oracle, jfm.fm_scores_dense(w0, w, v, x),
                               rtol=1e-12, atol=1e-12)
    # Distinct ids per row: the identity equals the pairwise sum there.
    rows = np.array([len(set(r)) == NNZ for r in ids])
    assert rows.sum() > B // 2
    np.testing.assert_allclose(got[rows], oracle[rows], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("shards", [1, 2, 5])
def test_partial_terms_sum_to_the_full_forward(shards):
    """A row-sharded table: each shard's partial terms (ids outside the
    shard contribute zero) equal JAX's, and their sum through
    ``fm_scores_from_partials`` is the unsharded forward."""
    rng = np.random.default_rng(5)
    w = rng.normal(size=N).astype(np.float32)
    v = (rng.normal(size=(N, K)) * 0.3).astype(np.float32)
    ids, vals = _batch(seed=6, bad_ids=False)
    rows = N // shards
    lin, s, sq = 0.0, 0.0, 0.0
    for r in range(shards):
        lo = r * rows
        hi = N if r == shards - 1 else lo + rows
        got = pfm.fm_partial_terms(
            torch.from_numpy(w[lo:hi]), torch.from_numpy(v[lo:hi]),
            torch.from_numpy(ids), torch.from_numpy(vals), lo, hi - lo)
        want = jfm.fm_partial_terms(
            jnp.asarray(w[lo:hi]), jnp.asarray(v[lo:hi]), jnp.asarray(ids),
            jnp.asarray(vals), lo, hi - lo)
        for g, j in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-6,
                                       atol=1e-6)
        lin, s, sq = lin + got[0], s + got[1], sq + got[2]
    w0 = torch.tensor(0.1)
    full = pfm.fm_scores(w0, torch.from_numpy(w), torch.from_numpy(v),
                         torch.from_numpy(ids), torch.from_numpy(vals))
    combined = pfm.fm_scores_from_partials(w0, lin, s, sq)
    np.testing.assert_allclose(combined.numpy(), full.numpy(), rtol=1e-6,
                               atol=1e-6)
    jcomb = jfm.fm_scores_from_partials(jnp.float32(0.1), jnp.asarray(
        lin.numpy()), jnp.asarray(s.numpy()), jnp.asarray(sq.numpy()))
    np.testing.assert_allclose(combined.numpy(), np.asarray(jcomb),
                               rtol=1e-6, atol=1e-6)


def test_init_draws_the_reference_distribution():
    _, pspec = _specs(param_dtype="bfloat16")
    p = pspec.init(torch.Generator().manual_seed(0), device="cpu")
    assert p["v"].dtype == torch.bfloat16 and p["w"].dtype == torch.bfloat16
    assert float(p["w0"]) == 0.0 and not p["w"].any()
    assert abs(float(p["v"].float().std()) - 0.1) < 0.02
    again = pspec.init(torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["v"], again["v"])


@pytest.mark.parametrize("pd", ["float32", "bfloat16"])
def test_model_dir_crosses_between_the_packages(tmp_path, pd):
    """A dir JAX writes loads in the port (its FMSpec, dtypes and values)
    and predicts as JAX does; a dir the port writes loads in JAX."""
    jspec, pspec = _specs(param_dtype=pd, task="regression",
                          min_target=-0.5, max_target=2.0)
    jp, pp = _params(jspec, pspec)
    ids, vals = _batch(bad_ids=False)
    jmodels.save_model(str(tmp_path / "jax"), jspec, jp)
    spec, params = models.load_model(str(tmp_path / "jax"), device="cpu")
    assert spec == pspec
    assert params["v"].dtype == pspec.pdtype
    for key in ("w0", "w", "v"):
        np.testing.assert_array_equal(
            params[key].float().numpy(),
            np.asarray(jnp.asarray(jp[key], jnp.float32)))
    got = spec.predict(params, torch.from_numpy(ids), torch.from_numpy(vals))
    want = jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    models.save_model(str(tmp_path / "torch"), pspec, pp)
    jspec2, jp2 = jmodels.load_model(str(tmp_path / "torch"))
    assert jspec2 == jspec
    for key in ("w0", "w", "v"):
        assert jp2[key].dtype == jp[key].dtype
        np.testing.assert_array_equal(
            np.asarray(jnp.asarray(jp2[key], jnp.float32)),
            pp[key].float().numpy())
