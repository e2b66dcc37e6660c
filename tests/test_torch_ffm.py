"""The port's flat FFM (``ops/ffm.py``, ``models/ffm.py``), the field
specs' flat layouts (``flat_spec``/``to_flat_params``/``to_global_ids`` of
FieldFM and FieldFFM), the dense FFM step, ``FFMWithSGD`` and the FFM
model dir against the JAX package, at a small size: 5 fields, rank 3,
60 features, B = 48.

Parameters are drawn by JAX and carried across by ``params_from_numpy``;
batches are numpy from a seed, with duplicate ids, zero-weight tail lanes,
padded slots (``vals`` 0) and ids out of range (past the table and below
``-n``). On the CPU the port runs the plain versions: the reference's
formula for the scores, and the sel-blocked kernels' plain versions
(``ffm_sel_scores_plain`` and ``ffm_sel_bwd_plain``) in the dense step.

Tolerances, and why:

- scores: ``rtol=1e-5, atol=1e-6`` against JAX's, and ``atol=1e-5``
  against the per-pair oracle (``ffm_scores_dense``, which accumulates
  in a Python float); the two float32 forms sum in different orders. The
  oracle equals JAX's bit for bit (the same numpy loop).
- layouts: bit for bit (concatenations and offsets, no arithmetic), and
  a FieldFM's scores against its flat FM's on the global ids within
  ``rtol=1e-5`` (the field step sums field by field, the flat one along
  the slot axis).
- the dense step and ``FFMWithSGD``, float32: after 5 steps every
  parameter within ``rtol=1e-5, atol=1e-6`` of JAX's (Adam's updated
  parameters ``atol=1e-6 + 1e-3·lr``: its update is scale-free, so the
  summation order of a cancelling gradient reaches the step, as in
  ``tests/test_torch_train_deepfm.py``), loss and ``grad_norm`` within
  ``rtol=1e-5``: the kernel's plain version sums the pairwise term in
  another order than XLA, and each id's lanes are summed by the device
  dedup in sorted order.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import compat as jcompat
from fm_spark_tpu import models as jmodels
from fm_spark_tpu import train as jtrain
from fm_spark_tpu.ops import ffm as jffm
from fm_spark_tpu_torch import compat, models
from fm_spark_tpu_torch import train as ptrain
from fm_spark_tpu_torch.ops import ffm as pffm

B, F, K, N, STEPS = 48, 5, 3, 60, 5
LR = 0.1


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _specs(**kw):
    kw = dict(num_features=N, rank=K, num_fields=F, init_std=0.1, **kw)
    return jmodels.FFMSpec(**kw), models.FFMSpec(**kw)


def _jparams(jspec, seed=0):
    """JAX-initialised params with a random bias and linear weights."""
    jp = jspec.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return {"w0": jnp.float32(0.1),
            "w": jnp.asarray(rng.normal(size=N) * 0.2, jnp.float32),
            "v": jp["v"]}


def _carry(pspec, jp):
    return models.params_from_numpy(
        pspec, {k: _np(v) for k, v in jp.items()}, "cpu")


def _batch(seed, bad_ids=True, pad=True):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, (B, F)) % N).astype(np.int32)
    if bad_ids:
        ids[0, 0], ids[1, -1], ids[2, 1] = N + 3, -N - 4, -2
    vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
    if pad:
        vals[3:9, -1] = 0.0                        # padded slots
    labels = rng.integers(0, 2, B).astype(np.float32)
    weights = np.ones(B, np.float32)
    weights[-5:] = 0.0                             # padded tail lanes
    return ids, vals, labels, weights


def _t(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


# ------------------------------------------------------------- the scores


@pytest.mark.parametrize("fields", [None, [0, 2, 1, 1, 3], [4, 0, 9, -1, 2]],
                         ids=["default", "explicit", "out-of-range"])
def test_ffm_scores_match_jax_and_the_oracle(fields):
    """The default slot == field layout, an explicit ``fields`` vector
    (slots sharing a field, the torch formula on any device), and field
    ids out of range, which both sides refuse."""
    jspec, _ = _specs()
    jp = _jparams(jspec)
    ids, vals, _, _ = _batch(1, bad_ids=False)
    if fields is not None and max(fields) >= F:
        with pytest.raises(ValueError, match="field ids must be in"):
            jffm.ffm_scores(jp["w0"], jp["w"], jp["v"], ids, vals,
                            fields=np.asarray(fields))
        with pytest.raises(ValueError, match="field ids must be in"):
            pffm.ffm_scores(*_t((jp["w0"], jp["w"], jp["v"], ids, vals)),
                            fields=fields)
        return
    want = jffm.ffm_scores(jp["w0"], jp["w"], jp["v"], ids, vals,
                           fields=None if fields is None
                           else np.asarray(fields))
    got = pffm.ffm_scores(*_t((jp["w0"], jp["w"], jp["v"], ids, vals)),
                          fields=fields)
    np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5, atol=1e-6)
    host = [_np(jp[k]) for k in ("w0", "w", "v")]
    oracle = pffm.ffm_scores_dense(*host, ids, vals, fields)
    np.testing.assert_array_equal(oracle, _np(jffm.ffm_scores_dense(
        *host, ids, vals, fields)))
    np.testing.assert_allclose(got.numpy(), oracle, rtol=1e-5, atol=1e-5)


def test_ffm_scores_keep_the_reference_checks():
    jspec, _ = _specs()
    jp = _jparams(jspec)
    ids, vals, _, _ = _batch(1, bad_ids=False)
    args = _t((jp["w0"], jp["w"], jp["v"], ids[:, :4], vals[:, :4]))
    with pytest.raises(ValueError, match="needs nnz \\(4\\) == F \\(5\\)"):
        pffm.ffm_scores(*args)
    with pytest.raises(ValueError, match="fields must have shape"):
        pffm.ffm_scores(*args, fields=[0, 1, 2])
    with pytest.raises(ValueError, match="field ids must be in"):
        pffm.ffm_scores(*args, fields=[0, 1, 2, 5])


@pytest.mark.parametrize("use_bias,use_linear", [(True, True),
                                                 (False, False)])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_ffm_spec_scores_and_predict_match_jax(task, use_bias, use_linear):
    kw = dict(task=task, use_bias=use_bias, use_linear=use_linear)
    if task == "regression":
        kw.update(min_target=-0.3, max_target=0.4)
    jspec, pspec = _specs(**kw)
    jp = _jparams(jspec)
    pp = _carry(pspec, jp)
    ids, vals, _, _ = _batch(2)
    for name in ("scores", "predict"):
        want = getattr(jspec, name)(jp, jnp.asarray(ids), jnp.asarray(vals))
        got = getattr(pspec, name)(pp, *_t((ids, vals)))
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
    with pytest.raises(ValueError, match="num_fields > 0"):
        models.FFMSpec(num_features=4, rank=2)


# ------------------------------------------------------- the flat layouts


@pytest.mark.parametrize("form", ["fm-fused", "fm-col", "fm-split", "ffm"])
def test_flat_layouts_equal_jax_bit_for_bit(form):
    """``flat_spec``, ``to_flat_params`` and ``to_global_ids`` of FieldFM
    (its three layouts) and FieldFFM, against JAX's; and the field model's
    scores against its flat model's on the global ids."""
    bucket = 8
    kw = dict(num_features=F * bucket, rank=K, num_fields=F, bucket=bucket,
              init_std=0.1)
    if form == "ffm":
        jspec, pspec = jmodels.FieldFFMSpec(**kw), models.FieldFFMSpec(**kw)
    else:
        kw.update(fused_linear=form != "fm-split",
                  table_layout="col" if form == "fm-col" else "row")
        jspec, pspec = jmodels.FieldFMSpec(**kw), models.FieldFMSpec(**kw)
    jp = jspec.init(jax.random.key(3))
    flat = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        flat[name] = _np(leaf)
    pp = models.params_from_numpy(pspec, flat, "cpu")
    assert (dataclasses.asdict(pspec.flat_spec())
            == dataclasses.asdict(jspec.flat_spec()))
    assert type(pspec.flat_spec()).__name__ == type(jspec.flat_spec()).__name__
    jflat, pflat = jspec.to_flat_params(jp), pspec.to_flat_params(pp)
    assert sorted(jflat) == sorted(pflat)
    for key in jflat:
        np.testing.assert_array_equal(pflat[key].numpy(), _np(jflat[key]))
    rng = np.random.default_rng(4)
    local = rng.integers(0, bucket, (B, F)).astype(np.int32)
    gids = pspec.to_global_ids(torch.from_numpy(local))
    assert gids.dtype == torch.int32
    np.testing.assert_array_equal(gids.numpy(),
                                  np.asarray(jspec.to_global_ids(local)))
    if form == "fm-col":
        return                       # the col layout scores on JAX only
    vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
    torch.testing.assert_close(
        pspec.flat_spec().scores(pflat, gids, torch.from_numpy(vals)),
        pspec.scores(pp, torch.from_numpy(local), torch.from_numpy(vals)),
        rtol=1e-5, atol=1e-6)


# --------------------------------------------------------- the dense step


@pytest.mark.parametrize("optimizer,reg", [("sgd", "triple"),
                                           ("adam", "none"),
                                           ("ftrl", "triple")])
def test_dense_ffm_steps_match_jax(optimizer, reg):
    """Five dense FFM steps: the pairwise term and its row gradient by the
    sel kernels' plain versions, each id's ``[F·k | 1]`` lanes summed once
    by the device dedup, then the group L2 and the optimizer over the
    whole table."""
    jspec, pspec = _specs()
    kw = dict(learning_rate=LR, optimizer=optimizer, lr_schedule="inv_sqrt")
    if reg == "triple":
        kw.update(reg_bias=1e-3, reg_linear=1e-2, reg_factors=3e-2)
    jcfg, pcfg = jtrain.TrainConfig(**kw), ptrain.TrainConfig(**kw)
    jp = _jparams(jspec)
    pp = _carry(pspec, jp)
    jopt, popt = jtrain.make_optimizer(jcfg), ptrain.make_optimizer(pcfg)
    jo, po = jopt.init(jp), popt.init(pp)
    jstep = jtrain.make_train_step(jspec, jcfg, jopt)
    pstep = ptrain.make_train_step(pspec, pcfg, popt)
    for i in range(STEPS):
        batch = _batch(10 + i)
        jp, jo, jm = jstep(jp, jo, *map(jnp.asarray, batch))
        pp, po, pm = pstep(pp, po, *_t(batch))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    atol = 1e-6 + (1e-3 * LR if optimizer == "adam" else 0.0)
    for key in ("w0", "w", "v"):
        np.testing.assert_allclose(pp[key].numpy(), _np(jp[key]), rtol=1e-5,
                                   atol=atol, err_msg=key)


def test_dense_ffm_step_refuses_another_slot_count():
    _, pspec = _specs()
    step = ptrain.make_train_step(pspec, ptrain.TrainConfig())
    params = pspec.init(torch.Generator().manual_seed(0), device="cpu")
    opt = ptrain.make_optimizer(ptrain.TrainConfig()).init(params)
    ids, vals, labels, weights = _t(_batch(1))
    with pytest.raises(ValueError, match="nnz=4 slots"):
        step(params, opt, ids[:, :4], vals[:, :4], labels, weights)


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_ffm_with_sgd_matches_jax(fraction, monkeypatch):
    """``FFMWithSGD.train`` end to end (the spec it builds, the Bernoulli
    sampler and the dense step). JAX draws its init from ``jax.random``,
    so the port's trainer starts from JAX's initial params, copied into
    it as it is made."""
    rng = np.random.default_rng(5)
    ids = rng.integers(0, 30, (200, 4)).astype(np.int32)
    vals = np.ones((200, 4), np.float32)
    labels = (ids.sum(1) % 3 == 0).astype(np.float32)
    kw = dict(numIterations=5, stepSize=0.2, miniBatchFraction=fraction,
              dim=(True, True, 3), regParam=(0.0, 1e-3, 1e-3), seed=2)
    jmodel = jcompat.FFMWithSGD.train((ids, vals, labels), **kw)
    jp0 = jmodel.spec.init(jax.random.key(2))
    real_init = ptrain.FMTrainer.__init__

    def init(self, spec, config, device=None):
        real_init(self, spec, config, device=device)
        from fm_spark_tpu_torch.checkpoint import copy_into

        copy_into(self.params, _carry(spec, jp0))

    monkeypatch.setattr(ptrain.FMTrainer, "__init__", init)
    pmodel = compat.FFMWithSGD.train((ids, vals, labels), **kw,
                                     device="cpu")
    assert type(pmodel.spec) is models.FFMSpec
    assert (dataclasses.asdict(pmodel.spec)
            == dataclasses.asdict(jmodel.spec))
    for key in ("w0", "w", "v"):
        np.testing.assert_allclose(pmodel.params[key].numpy(),
                                   _np(jmodel.params[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_allclose(pmodel.predict(ids, vals),
                               jmodel.predict(ids, vals), rtol=1e-5,
                               atol=1e-6)


def test_ffm_model_dir_crosses_both_ways(tmp_path):
    jspec, pspec = _specs(param_dtype="bfloat16")
    jp = jspec.init(jax.random.key(6))
    jmodels.save_model(str(tmp_path / "j"), jspec, jp)
    spec, params = models.load_model(str(tmp_path / "j"), device="cpu")
    assert spec == pspec and params["v"].dtype == torch.bfloat16
    assert params["v"].shape == (N, F, K)
    np.testing.assert_array_equal(params["v"].float().numpy(), _np(jp["v"]))
    models.save_model(str(tmp_path / "p"), spec, params)
    jspec2, jp2 = jmodels.load_model(str(tmp_path / "p"))
    assert jspec2 == jspec and jp2["v"].dtype == jnp.bfloat16
    ids, vals, _, _ = _batch(7, bad_ids=False)
    np.testing.assert_allclose(
        spec.predict(params, *_t((ids, vals))).float().numpy(),
        _np(jspec2.predict(jp2, jnp.asarray(ids), jnp.asarray(vals))),
        rtol=1e-5, atol=1e-6)
