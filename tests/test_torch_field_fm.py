"""The port's FieldFM model and model-dir format against the JAX package.

Parameters are drawn by JAX (``spec.init(jax.random.key(0))``), moved to
the port as numpy arrays through ``params_from_numpy`` (the two packages'
random generators differ), and both packages score the same numpy batch.
Tolerance ``rtol=1e-5, atol=1e-5`` on float32 accumulation in different
orders, as in ``test_torch_fused_fwd.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu.ops import losses as jlosses
from fm_spark_tpu_torch import models
from fm_spark_tpu_torch.ops import KernelUnavailable, losses

F, BUCKET = 5, 60
RTOL, ATOL = 1e-5, 1e-5


def _kw(**kw):
    base = dict(num_features=F * BUCKET, rank=8, num_fields=F, bucket=BUCKET,
                init_std=0.3)
    base.update(kw)
    return base


def _jax_params(spec, seed=0):
    """JAX-initialised params with a random linear column and bias (a
    fresh init zeroes both), as numpy under the npz names."""
    p = spec.init(jax.random.key(0))
    rng = np.random.default_rng(seed)
    flat = {"w0": np.float32(0.2)}
    for group in ("vw", "v", "w"):
        for f, t in enumerate(p.get(group, [])):
            arr = np.asarray(t.astype(jnp.float32))
            if group == "w":
                arr = (rng.normal(size=arr.shape) * 0.3).astype(np.float32)
            elif group == "vw":
                lin = (slice(None), spec.rank) if spec.table_layout == "row" \
                    else (spec.rank, slice(None))
                arr = arr.copy()
                arr[lin] = rng.normal(size=arr[lin].shape) * 0.3
            flat[f"{group}/{f}"] = arr
    jp = {"w0": jnp.float32(flat["w0"])}
    for name, arr in flat.items():
        if "/" in name:
            group, f = name.split("/")
            jp.setdefault(group, [None] * spec.num_fields)[int(f)] = (
                jnp.asarray(arr).astype(spec.pdtype))
    return jp, flat


def _batch(n=33, seed=1):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, BUCKET, (n, F)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (n, F)).astype(np.float32)
    return ids, vals


def _both(jspec, pspec, jp, flat, ids, vals):
    want = np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals)))
    pp = models.params_from_numpy(pspec, flat, "cpu",
                                  {k: pspec.param_dtype for k in flat
                                   if k != "w0"})
    got = pspec.predict(pp, torch.from_numpy(ids), torch.from_numpy(vals))
    return got.float().numpy(), want


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_predict_matches_jax(task, param_dtype):
    kw = _kw(task=task, param_dtype=param_dtype)
    if task == "regression":
        kw.update(min_target=-0.5, max_target=0.6)
    jspec, pspec = jmodels.FieldFMSpec(**kw), models.FieldFMSpec(**kw)
    jp, flat = _jax_params(jspec)
    got, want = _both(jspec, pspec, jp, flat, *_batch())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    if task == "regression":   # the clip engaged on both ends
        assert got.min() == np.float32(-0.5) and got.max() == np.float32(0.6)


@pytest.mark.parametrize("layout,fused,compute", [
    ("col", True, "float32"),
    ("row", False, "float32"),
    ("row", True, "bfloat16"),
])
def test_cpu_only_layouts_match_jax(layout, fused, compute):
    kw = _kw(table_layout=layout, fused_linear=fused, compute_dtype=compute,
             task="regression")
    jspec, pspec = jmodels.FieldFMSpec(**kw), models.FieldFMSpec(**kw)
    jp, flat = _jax_params(jspec)
    got, want = _both(jspec, pspec, jp, flat, *_batch())
    # bf16 compute rounds every product and partial sum to 8 bits of
    # mantissa, in another order in each framework.
    tol = dict(rtol=3e-2, atol=3e-2) if compute == "bfloat16" else \
        dict(rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.astype(np.float32),
                               want.astype(np.float32), **tol)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_model_dir_jax_to_port(tmp_path, param_dtype):
    jspec = jmodels.FieldFMSpec(**_kw(param_dtype=param_dtype,
                                      task="regression", max_target=2.0))
    jp, _ = _jax_params(jspec)
    jmodels.save_model(str(tmp_path), jspec, jp)
    pspec, pp = models.load_model(str(tmp_path), device="cpu")
    assert pspec == models.FieldFMSpec(**_kw(param_dtype=param_dtype,
                                             task="regression", max_target=2.0))
    assert pspec.min_target == -math.inf
    assert pp["vw"][0].dtype == pspec.pdtype
    for f in range(F):
        np.testing.assert_array_equal(
            pp["vw"][f].float().numpy(), np.asarray(jp["vw"][f], np.float32))
    assert float(pp["w0"]) == float(jp["w0"])


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_model_dir_port_to_jax(tmp_path, param_dtype):
    pspec = models.FieldFMSpec(**_kw(param_dtype=param_dtype))
    pp = pspec.init(torch.Generator().manual_seed(3), device="cpu")
    models.save_model(str(tmp_path), pspec, pp)
    jspec, jp = jmodels.load_model(str(tmp_path))
    assert jspec == jmodels.FieldFMSpec(**_kw(param_dtype=param_dtype))
    assert str(jp["vw"][0].dtype) == param_dtype
    for f in range(F):
        np.testing.assert_array_equal(np.asarray(jp["vw"][f], np.float32),
                                      pp["vw"][f].float().numpy())
    ids, vals = _batch()
    np.testing.assert_allclose(
        pspec.predict(pp, torch.from_numpy(ids), torch.from_numpy(vals)).numpy(),
        np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals))),
        rtol=RTOL, atol=ATOL)


def test_params_from_numpy_takes_jax_bf16_arrays():
    jspec = jmodels.FieldFMSpec(**_kw(param_dtype="bfloat16"))
    jp = jspec.init(jax.random.key(1))
    flat = {"w0": np.asarray(jp["w0"])}
    flat.update({f"vw/{f}": np.asarray(t) for f, t in enumerate(jp["vw"])})
    pp = models.params_from_numpy(models.FieldFMSpec(**_kw(param_dtype="bfloat16")),
                                  flat, "cpu")
    assert pp["vw"][0].dtype == torch.bfloat16
    np.testing.assert_array_equal(pp["vw"][2].float().numpy(),
                                  np.asarray(jp["vw"][2], np.float32))
    with pytest.raises(KeyError, match="vw/4"):
        models.params_from_numpy(models.FieldFMSpec(**_kw()),
                                 {k: v for k, v in flat.items() if k != "vw/4"},
                                 "cpu")


def test_init_is_seeded_and_zeroes_linear_terms():
    spec = models.FieldFMSpec(**_kw(param_dtype="bfloat16"))
    a = spec.init(torch.Generator().manual_seed(7), device="cpu")
    b = spec.init(torch.Generator().manual_seed(7), device="cpu")
    assert len(a["vw"]) == F and a["vw"][0].shape == (BUCKET, 9)
    assert a["vw"][0].dtype == torch.bfloat16
    assert all(torch.equal(x, y) for x, y in zip(a["vw"], b["vw"]))
    assert not a["vw"][0][:, 8].any() and float(a["w0"]) == 0.0
    col = models.FieldFMSpec(**_kw(table_layout="col")).init(device="cpu")
    assert col["vw"][0].shape == (9, BUCKET)


@pytest.mark.parametrize("kw", [dict(table_layout="col"),
                                dict(fused_linear=False),
                                dict(table_layout="col",
                                     compute_dtype="bfloat16")])
def test_kernel_unavailable_for_layouts_without_a_kernel(kw):
    spec = models.FieldFMSpec(**_kw(**kw))
    assert "ROADMAP" in spec.kernel_unsupported()
    # Off the CPU such a spec is refused, never scored another way (meta
    # tensors stand in for CUDA ones: neither takes the CPU path).
    w = spec.table_width
    shape = (w, BUCKET) if spec.table_layout == "col" else (BUCKET, w)
    params = {"w0": torch.zeros((), device="meta"),
              "vw": [torch.zeros(shape, device="meta") for _ in range(F)]}
    ids = torch.zeros((2, F), dtype=torch.int32, device="meta")
    with pytest.raises(KernelUnavailable, match="no CUDA kernel"):
        spec.scores(params, ids, ids.float())
    assert models.FieldFMSpec(**_kw()).kernel_unsupported() is None
    # bf16 compute has the kernel's bf16 mode now.
    assert models.FieldFMSpec(
        **_kw(compute_dtype="bfloat16")).kernel_unsupported() is None


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_bf16_compute_scores_match_jax(param_dtype):
    # The kernel's plain version on the CPU: bf16 rows, x and x·row
    # products as JAX's bf16 compute rounds them, sums in fp32 where JAX
    # sums in bf16. Against JAX's bf16 scores: within 2 % of the score's
    # magnitude plus 2e-2, the sum's rounding in bf16 (8-bit mantissa)
    # over F·k = 40 products of ~0.3.
    kw = _kw(compute_dtype="bfloat16", param_dtype=param_dtype)
    jspec, pspec = jmodels.FieldFMSpec(**kw), models.FieldFMSpec(**kw)
    jp, flat = _jax_params(jspec)
    ids, vals = _batch(n=200, seed=4)
    want = np.asarray(jspec.scores(jp, jnp.asarray(ids), jnp.asarray(vals)),
                      np.float32)
    pp = models.params_from_numpy(pspec, flat, "cpu")
    got = pspec.scores(pp, torch.from_numpy(ids), torch.from_numpy(vals))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2, atol=2e-2)


def test_spec_validation_matches_jax():
    for bad in (dict(loss="nope"), dict(task="regression", loss="logistic"),
                dict(task="ranking"), dict(bucket=7),
                dict(table_layout="diag"),
                dict(table_layout="col", fused_linear=False)):
        with pytest.raises(ValueError):
            jmodels.FieldFMSpec(**_kw(**bad))
        with pytest.raises(ValueError):
            models.FieldFMSpec(**_kw(**bad))
    assert models.FieldFMSpec(**_kw(task="regression")).loss == "squared"


@pytest.mark.parametrize("name", ["logistic", "squared", "hinge"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(2)
    s = rng.normal(size=64).astype(np.float32) * 4
    y = rng.integers(0, 2, 64).astype(np.float32)
    np.testing.assert_allclose(
        losses.loss_fn(name)(torch.from_numpy(s), torch.from_numpy(y)).numpy(),
        np.asarray(jlosses.loss_fn(name)(jnp.asarray(s), jnp.asarray(y))),
        rtol=1e-6, atol=1e-6)
