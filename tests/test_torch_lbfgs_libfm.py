"""The port's full-batch L-BFGS (``lbfgs.py``, ``compat.FMWithLBFGS``) and
libFM text format (``models/libfm_io.py``) against the JAX package.

L-BFGS is optax 0.2.6's ``lbfgs`` (memory 10, the zoom linesearch) on
both sides; the port runs its loop on the host with float32 scalars and
the vectors on the device. Parameters are drawn by JAX and carried
across; the data is the reference's planted FM (``synthetic_ctr``) or a
numpy draw from a seed, small (≤ 2,000 rows, ≤ 200 features).

Tolerances, and why:

- the objective and its gradient: ``rtol=1e-6`` (value) and ``rtol=1e-5,
  atol=1e-7`` (gradient); the dense gradient is summed per id by the
  device dedup in sorted order, JAX's autodiff scatter in lane order.
- the first three iterates: every parameter within ``rtol=1e-5, atol=
  1e-6`` and the loss within ``rtol=1e-5``. Each iterate is a function of
  a few float32 scalars (the linesearch's stepsizes) that both sides
  compute alike; the vectors' dot products add in different orders.
- the run to convergence on a small planted problem: the same iteration
  count and the final objective within ``rtol=1e-4``. Over tens of
  iterations the summation orders move the iterates by more than the
  first three's tolerance, but not the path (the same trip count) nor
  the minimum it reaches.
- libFM: the file the port writes is byte-equal to JAX's for the same
  params; a round trip reads back the float32 values bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import compat as jcompat
from fm_spark_tpu import lbfgs as jlbfgs
from fm_spark_tpu import models as jmodels
from fm_spark_tpu import train as jtrain
from fm_spark_tpu.data import synthetic_ctr
from fm_spark_tpu.models import libfm_io as jlibfm
from fm_spark_tpu_torch import compat, lbfgs, models
from fm_spark_tpu_torch import train as ptrain
from fm_spark_tpu_torch.models import libfm_io

REGS = dict(reg_bias=1e-4, reg_linear=1e-3, reg_factors=1e-2)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _jflat(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        out[name] = _np(leaf)
    return out


def _carry(pspec, jp):
    return models.params_from_numpy(pspec, _jflat(jp), "cpu")


def _fm(n=40, k=4, **kw):
    kw = dict(num_features=n, rank=k, init_std=0.1, **kw)
    return jmodels.FMSpec(**kw), models.FMSpec(**kw)


def _data(n=40, b=400, nnz=3, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, n, (b, nnz)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (b, nnz)).astype(np.float32)
    planted = rng.normal(size=n)
    labels = (planted[ids].sum(1) > 0).astype(np.float32)
    return ids, vals, labels


# ---------------------------------------------------------- the objective


@pytest.mark.parametrize("family", ["fm", "ffm", "deepfm"])
def test_objective_and_gradient_match_jax(family):
    ids, vals, labels = _data(nnz=3)
    weights = np.random.default_rng(1).uniform(0, 2, labels.shape).astype(
        np.float32)
    kw = dict(num_features=40, rank=3, init_std=0.1)
    if family == "fm":
        jspec, pspec = jmodels.FMSpec(**kw), models.FMSpec(**kw)
    elif family == "ffm":
        jspec = jmodels.FFMSpec(num_fields=3, **kw)
        pspec = models.FFMSpec(num_fields=3, **kw)
    else:
        jspec = jmodels.DeepFMSpec(num_fields=3, mlp_dims=(8, 8), **kw)
        pspec = models.DeepFMSpec(num_fields=3, mlp_dims=(8, 8), **kw)
    jp = jspec.init(jax.random.key(0))
    pp = _carry(pspec, jp)
    jcfg, pcfg = jtrain.TrainConfig(**REGS), ptrain.TrainConfig(**REGS)
    jobj = jlbfgs.make_objective(jspec, jcfg, *map(jnp.asarray, (
        ids, vals, labels, weights)))
    pobj = lbfgs.make_objective(pspec, pcfg, *map(torch.from_numpy, (
        ids, vals, labels, weights)))
    jv, jg = jax.value_and_grad(jobj)(jp)
    pv, pg = pobj.value_and_grad(pp)
    np.testing.assert_allclose(float(pv), float(jv), rtol=1e-6)
    np.testing.assert_allclose(float(pobj(pp)), float(jv), rtol=1e-6)
    want, got = _jflat(jg), {k: v.numpy() for k, v in
                             models.io.flatten(pg).items()}
    assert sorted(want) == sorted(got)
    for name in want:
        np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                   atol=1e-7, err_msg=name)


def test_objective_refuses_an_unknown_group():
    _, pspec = _fm()
    obj = lbfgs.make_objective(pspec, ptrain.TrainConfig(), *map(
        torch.from_numpy, _data()), torch.ones(400))
    params = pspec.init(torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="no regularization group"):
        obj.value_and_grad({**params, "extra": torch.zeros(3)})


# ------------------------------------------------------------ the solver


@pytest.mark.parametrize("iters", [1, 2, 3])
def test_first_iterates_match_jax(iters):
    jspec, pspec = _fm()
    jcfg, pcfg = jtrain.TrainConfig(**REGS), ptrain.TrainConfig(**REGS)
    ids, vals, labels = _data()
    jp = jspec.init(jax.random.key(0))
    jp2, jinfo = jlbfgs.fit_lbfgs(jspec, jp, ids, vals, labels, config=jcfg,
                                  num_iterations=iters)
    pp, pinfo = lbfgs.fit_lbfgs(pspec, _carry(pspec, jp), ids, vals, labels,
                                config=pcfg, num_iterations=iters)
    assert pinfo["iterations"] == jinfo["iterations"] == iters
    np.testing.assert_allclose(pinfo["loss"], jinfo["loss"], rtol=1e-5)
    np.testing.assert_allclose(pinfo["grad_norm"], jinfo["grad_norm"],
                               rtol=1e-4)
    for key in ("w0", "w", "v"):
        np.testing.assert_allclose(pp[key].numpy(), _np(jp2[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_run_to_convergence_matches_jax():
    """A small planted problem run until MLlib's relative-decrease rule
    stops it: the same iteration count, the final objective within
    ``rtol=1e-4``."""
    jspec, pspec = _fm()
    jcfg, pcfg = jtrain.TrainConfig(**REGS), ptrain.TrainConfig(**REGS)
    ids, vals, labels = _data()
    jp = jspec.init(jax.random.key(0))
    _, jinfo = jlbfgs.fit_lbfgs(jspec, jp, ids, vals, labels, config=jcfg,
                                num_iterations=100)
    _, pinfo = lbfgs.fit_lbfgs(pspec, _carry(pspec, jp), ids, vals, labels,
                               config=pcfg, num_iterations=100)
    assert 1 < pinfo["iterations"] == jinfo["iterations"] < 100
    np.testing.assert_allclose(pinfo["loss"], jinfo["loss"], rtol=1e-4)


def test_lbfgs_drives_loss_down_on_planted_fm():
    ids, vals, labels = synthetic_ctr(2000, 200, 4, rank=3, seed=1)
    _, spec = _fm(n=200, k=4)
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    obj = lbfgs.make_objective(spec, ptrain.TrainConfig(), *map(
        torch.from_numpy, (ids, vals, labels)), torch.ones(2000))
    before = float(obj(params))
    _, info = lbfgs.fit_lbfgs(spec, params, ids, vals, labels,
                              num_iterations=60)
    assert info["loss"] < before - 0.05
    assert np.isfinite(info["grad_norm"])
    assert 1 <= info["iterations"] <= 60


def test_lbfgs_convergence_tol_stops_early():
    ids, vals, labels = synthetic_ctr(500, 100, 3, seed=2)
    _, spec = _fm(n=100, k=2)
    _, info = lbfgs.fit_lbfgs(
        spec, spec.init(torch.Generator().manual_seed(0), device="cpu"),
        ids, vals, labels, num_iterations=500, convergence_tol=1e-2)
    assert info["iterations"] < 500


def test_lbfgs_regularization_shrinks_weights():
    ids, vals, labels = synthetic_ctr(1000, 100, 3, seed=3)
    _, spec = _fm(n=100, k=3)

    def fit(**reg):
        p0 = spec.init(torch.Generator().manual_seed(0), device="cpu")
        return lbfgs.fit_lbfgs(spec, p0, ids, vals, labels,
                               num_iterations=40,
                               config=ptrain.TrainConfig(**reg))[0]

    free, reg = fit(), fit(reg_linear=1.0, reg_factors=1.0)
    for key in ("v", "w"):
        assert float(reg[key].square().sum()) < float(
            free[key].square().sum()), key


def test_fm_with_lbfgs_regression_clips_and_dim_flags():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, (400, 3)).astype(np.int32)
    vals = np.ones(ids.shape, np.float32)
    labels = rng.uniform(1.0, 5.0, 400).astype(np.float32)
    model = compat.FMWithLBFGS.train((ids, vals, labels), task="regression",
                                     numIterations=30, device="cpu")
    preds = model.predict(ids, vals)
    assert preds.min() >= 1.0 - 1e-5 and preds.max() <= 5.0 + 1e-5
    data = synthetic_ctr(500, 80, 3, seed=5)
    entry = compat.FMWithLBFGS(numIterations=10, dim=(False, False, 2),
                               device="cpu")
    model = entry.run(data)
    assert float(model.params["w0"]) == 0.0
    assert float(model.params["w"].abs().max()) == 0.0
    assert model.spec.rank == 2 and 1 <= entry.info["iterations"] <= 10


def test_fm_with_lbfgs_matches_jax(monkeypatch):
    """The entry point end to end: the spec it builds (``num_features``
    from the data, the dim flags, the reg triple) and the fit from JAX's
    initial params (copied into the port's, since JAX draws from
    ``jax.random``), three iterations, held as the first iterates are."""
    ids, vals, labels = _data(n=30, b=300)
    kw = dict(numIterations=3, dim=(True, True, 3),
              regParam=(1e-4, 1e-3, 1e-3), seed=3)
    jmodel = jcompat.FMWithLBFGS.train((ids, vals, labels), **kw)
    jp0 = jmodel.spec.init(jax.random.key(3))
    real = models.FMSpec.init

    def init(self, generator=None, device=None):
        real(self, generator, device)
        return _carry(self, jp0)

    monkeypatch.setattr(models.FMSpec, "init", init)
    pmodel = compat.FMWithLBFGS.train((ids, vals, labels), **kw,
                                      device="cpu")
    assert pmodel.spec == models.FMSpec(**{
        f: getattr(jmodel.spec, f) for f in ("num_features", "rank",
                                             "use_bias", "use_linear")})
    for key in ("w0", "w", "v"):
        np.testing.assert_allclose(pmodel.params[key].numpy(),
                                   _np(jmodel.params[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def test_bf16_tables_raise_naming_their_item():
    """bf16 tables train (held against optax in
    ``tests/test_torch_tiered_bf16.py``); another dtype raises, naming
    the two that L-BFGS takes."""
    _, spec = _fm(param_dtype="bfloat16")
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    params, info = lbfgs.fit_lbfgs(spec, params, *_data(), num_iterations=2)
    assert params["v"].dtype == torch.bfloat16 and info["iterations"] == 2
    params["v"] = params["v"].half()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        lbfgs.fit_lbfgs(spec, params, *_data())


# ------------------------------------------------------------------ libFM


def _random_fm(jspec, seed=0):
    jp = jspec.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    jp["w0"] = jnp.asarray(rng.normal(), jnp.float32)
    jp["w"] = jnp.asarray(rng.normal(size=(jspec.num_features,)),
                          jnp.float32)
    return jp


@pytest.mark.parametrize("use_bias,use_linear", [(True, True), (False, True),
                                                 (True, False),
                                                 (False, False)])
@pytest.mark.parametrize("pd", ["float32", "bfloat16"])
def test_save_libfm_writes_jax_bytes_and_round_trips(tmp_path, pd, use_bias,
                                                     use_linear):
    jspec, pspec = _fm(n=37, k=5, param_dtype=pd, use_bias=use_bias,
                       use_linear=use_linear)
    jp = _random_fm(jspec)
    jp = {k: (v.astype(jnp.bfloat16) if k != "w0" and pd == "bfloat16"
              else v) for k, v in jp.items()}
    pp = _carry(pspec, jp)
    jlibfm.save_libfm(str(tmp_path / "j.libfm"), jspec, jp)
    libfm_io.save_libfm(str(tmp_path / "p.libfm"), pspec, pp)
    assert ((tmp_path / "p.libfm").read_bytes()
            == (tmp_path / "j.libfm").read_bytes())
    spec2, p2 = libfm_io.load_libfm(str(tmp_path / "p.libfm"), device="cpu",
                                    param_dtype=pd)
    jspec2, jp2 = jlibfm.load_libfm(str(tmp_path / "j.libfm"),
                                    param_dtype=pd)
    assert spec2 == models.FMSpec(**{f: getattr(jspec2, f) for f in (
        "num_features", "rank", "task", "use_bias", "use_linear",
        "param_dtype")})
    assert (spec2.use_bias, spec2.use_linear) == (use_bias, use_linear)
    for key in ("w0", "w", "v"):
        assert p2[key].dtype == pp[key].dtype
        np.testing.assert_array_equal(p2[key].float().numpy(), _np(jp2[key]))
        if key != "w0" or use_bias:
            if key != "w" or use_linear:
                assert torch.equal(p2[key], pp[key]), key


def test_field_fm_flattens_on_export_and_ffm_deepfm_refuse(tmp_path):
    kw = dict(num_features=4 * 8, rank=3, num_fields=4, bucket=8)
    jspec, pspec = jmodels.FieldFMSpec(**kw), models.FieldFMSpec(**kw)
    jp = jspec.init(jax.random.key(0))
    pp = models.params_from_numpy(pspec, {
        "w0": _np(jp["w0"]), **{f"vw/{f}": _np(t)
                                for f, t in enumerate(jp["vw"])}}, "cpu")
    jlibfm.save_libfm(str(tmp_path / "j.libfm"), jspec, jp)
    libfm_io.save_libfm(str(tmp_path / "p.libfm"), pspec, pp)
    assert ((tmp_path / "p.libfm").read_bytes()
            == (tmp_path / "j.libfm").read_bytes())
    spec2, p2 = libfm_io.load_libfm(str(tmp_path / "p.libfm"), device="cpu")
    assert spec2.num_features == 32 and spec2.rank == 3
    rng = np.random.default_rng(0)
    local = torch.from_numpy(rng.integers(0, 8, (16, 4)).astype(np.int32))
    vals = torch.ones(16, 4)
    torch.testing.assert_close(
        spec2.predict(p2, pspec.to_global_ids(local), vals),
        pspec.predict(pp, local, vals), rtol=1e-5, atol=1e-6)
    for spec in (models.FFMSpec(num_features=8, rank=2, num_fields=2),
                 models.DeepFMSpec(num_features=8, rank=2, num_fields=2)):
        with pytest.raises(ValueError, match="plain FM models only, not "
                                             f"{type(spec).__name__}"):
            libfm_io.save_libfm(str(tmp_path / "x.libfm"), spec, {})


def test_libfm_external_file_and_mismatched_sections(tmp_path):
    path = tmp_path / "ext.libfm"
    path.write_text("#global bias W0\n0.25\n#unary interactions Wj\n0.1\n"
                    "-0.2\n0.3\n#pairwise interactions Vj,f\n0.1 0.2\n"
                    "0.3 -0.4\n-0.5 0.6\n")
    spec, params = libfm_io.load_libfm(str(path), device="cpu")
    assert spec.num_features == 3 and spec.rank == 2
    assert float(params["w0"]) == pytest.approx(0.25)
    assert float(params["w"][1]) == pytest.approx(-0.2)
    assert float(params["v"][2, 1]) == pytest.approx(0.6)
    bad = tmp_path / "bad.libfm"
    bad.write_text("#unary interactions Wj\n0.1\n0.2\n"
                   "#pairwise interactions Vj,f\n0.1 0.2\n")
    with pytest.raises(ValueError, match="unary weights"):
        libfm_io.load_libfm(str(bad), device="cpu")
    bad.write_text("#global bias W0\n0.0\n")
    with pytest.raises(ValueError, match="missing"):
        libfm_io.load_libfm(str(bad), device="cpu")
