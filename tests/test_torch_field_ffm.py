"""The port's FieldFFM model and its model dirs against the JAX package.

Parameters are drawn by JAX and carried to the port as numpy arrays
through ``params_from_numpy`` or a model dir; both packages score the same
numpy batch. On the CPU ``FieldFFMSpec.scores`` is the reference's formula
over the ``[B, F, F, k]`` sel tensor; ``_scores_sel`` is the composition
the card runs (stacked rows through ``ffm_sel_scores``), here on its plain
version. Tolerances: ``rtol=1e-5, atol=1e-5`` in float32 (fp32 sums in
another order); in bf16 compute the reference's bf16 bounds
``rtol=3e-2, atol=3e-3`` (``tests/test_sel_blocked.py``) plus, for the
owner-loop composition, the bf16 rounding of its running sums (bounded by
``2F·2⁻⁸`` of the sum of |pair terms|, as in ``test_torch_ffm_sel.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu_torch import models

F, BUCKET, K = 5, 30, 4


def _kw(**kw):
    base = dict(num_features=F * BUCKET, rank=K, num_fields=F, bucket=BUCKET,
                init_std=0.3)
    base.update(kw)
    return base


def _jax_params(spec, seed=0):
    """JAX-initialised params with a random linear column and bias (a fresh
    init zeroes both), as a JAX tree and as numpy under the npz names."""
    p = spec.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    flat = {"w0": np.float32(0.2)}
    for f, t in enumerate(p["vw"]):
        arr = np.array(t.astype(jnp.float32))
        arr[:, -1] = rng.normal(size=arr.shape[0]) * 0.3
        flat[f"vw/{f}"] = arr
    jp = {"w0": jnp.float32(flat["w0"]),
          "vw": [jnp.asarray(flat[f"vw/{f}"]).astype(spec.pdtype)
                 for f in range(spec.num_fields)]}
    return jp, flat


def _batch(n=37, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BUCKET, (n, F)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (n, F)).astype(np.float32)
    return ids, vals


def _pair_scale(pspec, pp, ids, vals):
    """Σ_ij |⟨sel_ij, sel_ji⟩| per row, in float32."""
    rows = [pp["vw"][f][torch.from_numpy(ids[:, f]).long()].float()
            for f in range(F)]
    sel = pspec._sel(rows, torch.from_numpy(vals))
    return (sel * sel.transpose(1, 2)).sum(-1).abs().sum((1, 2)).numpy()


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_linear,use_bias", [(True, True), (False, False),
                                                 (True, False)])
def test_scores_and_predict_match_jax(cd, use_linear, use_bias):
    kw = _kw(compute_dtype=cd, use_linear=use_linear, use_bias=use_bias)
    jspec, pspec = jmodels.FieldFFMSpec(**kw), models.FieldFFMSpec(**kw)
    jp, flat = _jax_params(jspec)
    pp = models.params_from_numpy(pspec, flat, "cpu")
    ids, vals = _batch()
    tids, tvals = torch.from_numpy(ids), torch.from_numpy(vals)
    want = np.asarray(jspec.scores(jp, jnp.asarray(ids), jnp.asarray(vals))
                      .astype(jnp.float32))
    want_p = np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals))
                        .astype(jnp.float32))
    got = pspec.scores(pp, tids, tvals).float().numpy()
    got_sel = pspec._scores_sel(pp, tids, tvals).float().numpy()
    got_p = pspec.predict(pp, tids, tvals).float().numpy()
    assert pspec.scores(pp, tids, tvals).dtype == pspec.cdtype
    if cd == "float32":
        for g in (got, got_sel):
            np.testing.assert_allclose(g, want, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(got_p, want_p, rtol=1e-5, atol=1e-6)
    else:
        np.testing.assert_allclose(got, want, rtol=3e-2, atol=3e-3)
        np.testing.assert_allclose(got_p, want_p, rtol=3e-2, atol=3e-3)
        s = _pair_scale(pspec, pp, ids, vals)
        bound = 3e-2 * np.abs(want) + 3e-3 + 2 * F * 2.0**-8 * s
        assert (np.abs(got_sel - want) <= bound).all()


def test_init_shapes_dtypes_and_defaults():
    spec = models.FieldFFMSpec(**_kw(param_dtype="bfloat16"))
    assert spec.table_width == F * K + 1
    p = spec.init(torch.Generator().manual_seed(3), device="cpu")
    assert p["w0"].shape == () and p["w0"].dtype == torch.float32
    assert float(p["w0"]) == 0.0
    assert len(p["vw"]) == F
    for t in p["vw"]:
        assert t.shape == (BUCKET, F * K + 1) and t.dtype == torch.bfloat16
        assert not bool(t[:, -1].any())                 # zero linear column
        std = float(t[:, :-1].float().std())
        assert 0.25 < std < 0.35                        # N(0, 0.3²)
    again = spec.init(torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(p["vw"], again["vw"]))


@pytest.mark.parametrize("kw", [
    dict(num_fields=0), dict(bucket=0), dict(num_features=F * BUCKET + 1),
    dict(fused_linear=False), dict(task="ranking"),
])
def test_guards_raise_as_jax(kw):
    with pytest.raises(ValueError) as want:
        jmodels.FieldFFMSpec(**_kw(**kw))
    with pytest.raises(ValueError) as got:
        models.FieldFFMSpec(**_kw(**kw))
    assert str(got.value) == str(want.value)


def test_scores_refuse_a_wrong_slot_count():
    spec = models.FieldFFMSpec(**_kw())
    p = spec.init(device="cpu")
    with pytest.raises(ValueError, match="slots"):
        spec.scores(p, torch.zeros(3, F + 1, dtype=torch.int32),
                    torch.ones(3, F + 1))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_model_dir_jax_to_port(tmp_path, param_dtype):
    kw = _kw(param_dtype=param_dtype, task="regression", max_target=2.0)
    jspec = jmodels.FieldFFMSpec(**kw)
    jp, _ = _jax_params(jspec)
    jmodels.save_model(str(tmp_path), jspec, jp)
    pspec, pp = models.load_model(str(tmp_path), device="cpu")
    assert pspec == models.FieldFFMSpec(**kw)
    assert pspec.min_target == -math.inf
    assert pp["vw"][0].dtype == pspec.pdtype
    ids, vals = _batch(seed=4)
    want = np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals)))
    got = pspec.predict(pp, torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_model_dir_port_to_jax(tmp_path, param_dtype):
    kw = _kw(param_dtype=param_dtype)
    pspec = models.FieldFFMSpec(**kw)
    pp = pspec.init(torch.Generator().manual_seed(5), device="cpu")
    for t in pp["vw"]:
        t[:, -1] = 0.25
    pp["w0"].fill_(-0.1)
    models.save_model(str(tmp_path), pspec, pp)
    jspec, jp = jmodels.load_model(str(tmp_path))
    assert jspec == jmodels.FieldFFMSpec(**kw)
    assert jp["vw"][0].dtype == jnp.dtype(param_dtype)
    ids, vals = _batch(seed=6)
    want = np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals)))
    got = pspec.predict(pp, torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
