"""The port's reference API (``compat.FMWithSGD``, ``FMModel``,
``evaluate``) and its host input (``BernoulliBatches``, MovieLens and
libSVM I/O) against the JAX package.

``FMWithSGD.train`` starts from JAX's initial params on both sides (the
port's ``FMSpec.init`` is patched to return them: ``torch.Generator``
draws other numbers than ``jax.random``), on 400 MovieLens-shaped rows
from a synthesized ratings file, full batch (``miniBatchFraction`` 1.0)
and Bernoulli-sampled (0.3, the same masks on both sides). Tolerance:
predictions within ``rtol=1e-5, atol=1e-6`` after 8 steps (the float32
sums over the batch and over each id's lanes add in another order on
each side, a few ulps a step). The data paths are numpy code copied from
the reference and must equal its output exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import compat as jcompat
from fm_spark_tpu.data import libsvm as jlibsvm
from fm_spark_tpu.data import movielens as jmovielens
from fm_spark_tpu.data.pipeline import BernoulliBatches as JBernoulli
from fm_spark_tpu_torch import compat, models
from fm_spark_tpu_torch.data import BernoulliBatches, libsvm, movielens


@pytest.fixture
def ratings(tmp_path):
    path = str(tmp_path / "u.data")
    jmovielens.synthesize_ratings(path, 40, 60, 400, seed=2)
    return path


def _from_jax_init(monkeypatch):
    """Make the port's ``FMSpec.init`` return JAX's initial params (the
    reference draws them from ``jax.random.key(seed)``)."""
    def init(self, generator=None, device=None):
        jspec = jcompat.models.FMSpec(**{
            f: getattr(self, f) for f in self.__dataclass_fields__})
        jp = jspec.init(jax.random.key(0))
        flat = {k: np.asarray(jnp.asarray(v, jnp.float32))
                for k, v in jp.items()}
        return models.params_from_numpy(self, flat, device)

    monkeypatch.setattr(models.FMSpec, "init", init)


@pytest.mark.parametrize("task,dim", [("classification", (True, True, 4)),
                                      ("regression", (True, True, 4)),
                                      ("classification", (False, True, 0))])
@pytest.mark.parametrize("fraction", [1.0, 0.3])
def test_fm_with_sgd_predicts_as_jax(ratings, monkeypatch, fraction, task,
                                     dim):
    _from_jax_init(monkeypatch)
    (ids, vals, labels), _ = jmovielens.load_ratings(ratings, task=task)
    kw = dict(task=task, numIterations=8, stepSize=0.3,
              miniBatchFraction=fraction, dim=dim,
              regParam=(1e-3, 1e-2, 1e-2), initStd=0.1, seed=0)
    jmodel = jcompat.FMWithSGD.train((ids, vals, labels), **kw)
    pmodel = compat.FMWithSGD.train((ids, vals, labels), **kw, device="cpu")
    assert pmodel.spec == models.FMSpec(**{
        f: getattr(jmodel.spec, f) for f in jmodel.spec.__dataclass_fields__})
    want = jmodel.predict(ids, vals)
    got = pmodel.predict(ids, vals)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    if task == "regression":            # clipped to the learned range
        assert got.min() >= labels.min() and got.max() <= labels.max()
    jm = jcompat.evaluate(jmodel, (ids, vals, labels), batch_size=128)
    pm = compat.evaluate(pmodel, (ids, vals, labels), batch_size=128)
    for key in ("auc", "logloss", "rmse", "count"):
        np.testing.assert_allclose(pm[key], jm[key], rtol=1e-5, atol=1e-6)


def test_fm_model_saves_and_loads_across_the_packages(ratings, tmp_path):
    (ids, vals, labels), _ = jmovielens.load_ratings(ratings)
    pmodel = compat.FMWithSGD.train((ids, vals, labels), numIterations=3,
                                    dim=(True, False, 4), device="cpu")
    pmodel.save(str(tmp_path / "m"))
    jmodel = jcompat.FMModel.load(str(tmp_path / "m"))
    back = compat.FMModel.load(str(tmp_path / "m"), device="cpu")
    np.testing.assert_array_equal(back.predict(ids, vals),
                                  pmodel.predict(ids, vals))
    np.testing.assert_allclose(jmodel.predict(ids, vals),
                               pmodel.predict(ids, vals), rtol=1e-6,
                               atol=1e-7)
    assert not jmodel.spec.use_linear and jmodel.spec.rank == 4


@pytest.mark.parametrize("cls", ["FFMWithSGD", "FMWithLBFGS"])
def test_the_unported_entry_points_name_their_roadmap_item(cls):
    """Once refused naming ROADMAP item 9b, both entry points now train:
    a finite model of the family the reference's entry point builds
    (held against JAX's in tests/test_torch_ffm.py and
    tests/test_torch_lbfgs_libfm.py)."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 6, (40, 3)).astype(np.int32)
    data = (ids, np.ones((40, 3), np.float32),
            (ids.sum(1) > 7).astype(np.float32))
    model = getattr(compat, cls).train(data, numIterations=3, device="cpu")
    want = models.FFMSpec if cls == "FFMWithSGD" else models.FMSpec
    assert type(model.spec) is want
    assert model.spec.num_features == 6
    preds = model.predict(ids, data[1])
    assert preds.shape == (40,) and np.isfinite(preds).all()


@pytest.mark.parametrize("fraction", [1.0, 0.5, 0.05])
def test_bernoulli_masks_equal_jax_bit_for_bit(fraction):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 9, (1000, 3)).astype(np.int32)
    vals = np.ones((1000, 3), np.float32)
    labels = rng.integers(0, 2, 1000).astype(np.float32)
    j = JBernoulli(ids, vals, labels, fraction, seed=7)
    p = BernoulliBatches(ids, vals, labels, fraction, seed=7)
    for _ in range(5):
        jb, pb = j.next_batch(), p.next_batch()
        for a, b in zip(jb, pb):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert p.state() == j.state()
    p.restore({"step": 2, "seed": 7, "fraction": fraction})
    j.restore({"step": 2, "seed": 7, "fraction": fraction})
    np.testing.assert_array_equal(p.next_batch()[3], j.next_batch()[3])
    with pytest.raises(ValueError, match="different seed"):
        p.restore({"step": 0, "seed": 8})
    with pytest.raises(ValueError, match="fraction"):
        BernoulliBatches(ids, vals, labels, 0.0)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_movielens_synthesize_and_load_equal_jax(tmp_path, task):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    jmovielens.synthesize_ratings(a, 943, 1682, 2000, seed=5)
    movielens.synthesize_ratings(b, 943, 1682, 2000, seed=5)
    assert open(a, "rb").read() == open(b, "rb").read()
    (jids, jvals, jlabels), jmeta = jmovielens.load_ratings(a, task=task)
    (ids, vals, labels), meta = movielens.load_ratings(a, task=task)
    for x, y in ((ids, jids), (vals, jvals), (labels, jlabels)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert meta["num_features"] == jmeta["num_features"]
    np.testing.assert_array_equal(meta["item_ids"], jmeta["item_ids"])


def test_libsvm_parse_load_save_round_trip_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    ids = np.sort(rng.choice(200, (50, 6)), axis=1).astype(np.int32)
    vals = rng.normal(size=(50, 6)).astype(np.float32)
    vals[3, 4:] = 0.0                              # a short row
    labels = rng.integers(0, 2, 50).astype(np.float32)
    a, b = str(tmp_path / "a.svm"), str(tmp_path / "b.svm")
    jlibsvm.save_libsvm(a, ids, vals, labels)
    libsvm.save_libsvm(b, ids, vals, labels)
    assert open(a).read() == open(b).read()
    for kw in ({}, {"max_nnz": 8}, {"max_nnz": 4, "truncate": True}):
        got, want = libsvm.load_libsvm(a, **kw), jlibsvm.load_libsvm(a, **kw)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
    got = libsvm.load_libsvm(a)
    np.testing.assert_array_equal(got[2], labels)
    keep = vals != 0
    np.testing.assert_array_equal(got[0][:, :6][keep], ids[keep])
    for line in (b"1 3:0.5 7:1", b"-1", b"0 1:2 # comment"):
        assert libsvm.parse_libsvm_line(line) == jlibsvm.parse_libsvm_line(
            line)
    for bad in (b"3:1 4:2", b"x 1:2", b"1 3:", b"1 0:1"):
        with pytest.raises(ValueError) as got_err:
            libsvm.parse_libsvm_line(bad)
        with pytest.raises(ValueError) as want_err:
            jlibsvm.parse_libsvm_line(bad)
        assert str(got_err.value) == str(want_err.value)
    with open(b, "a") as f:
        f.write("1 2:x\n")
    with pytest.raises(ValueError, match=r"b\.svm:51: bad libsvm line"):
        libsvm.load_libsvm(b)
    with pytest.raises(ValueError, match="exceeds max_nnz=2"):
        libsvm.load_libsvm(a, max_nnz=2)


def test_predict_on_the_model_device_takes_numpy(ratings):
    (ids, vals, labels), _ = jmovielens.load_ratings(ratings)
    model = compat.FMWithSGD.train((ids, vals, labels), numIterations=2,
                                   device="cpu")
    got = model.predict(ids[:5], vals[:5])
    assert isinstance(got, np.ndarray) and got.shape == (5,)
    want = model.spec.predict(model.params, torch.from_numpy(ids[:5]),
                              torch.from_numpy(vals[:5]))
    np.testing.assert_array_equal(got, want.numpy())
