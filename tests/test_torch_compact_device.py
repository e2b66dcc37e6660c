"""The port's device-built compact aux (``compact_device``) against the JAX
package: ``ops.scatter.device_compact_aux`` against the host aux's ints
(no overflow) and JAX's device aux (overflow), and the FieldFM
and FieldFFM steps against JAX's jitted steps under both overflow
policies, with the cases of ``tests/test_compact_device.py``.

Parameters are drawn by JAX and carried across; batches are numpy from a
seed; the SR bits are each side's own (the port draws JAX's key
schedule). JAX's steps are compiled with ``xla_allow_excess_precision``
off, so XLA rounds every bf16 operation as the program writes it (on the
CPU it may otherwise keep fp32 between fused bf16 operations); then the
bf16 ``dedup_sr`` losses and tables are held bit for bit. In float32
(``dedup``) the sums over the batch and the segments add in another
order on each side: the reference's fp32 step tolerances (loss within
1e-6, tables within ``atol=1e-5``). ``w0`` is a float32 sum over the
batch in either dtype: held at ``rtol=1e-6, atol=1e-8`` (the observed
differences are ~1e-10).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu import sparse as jsparse
from fm_spark_tpu import train as jtrain
from fm_spark_tpu.ops import scatter as jscatter
from fm_spark_tpu_torch import cli, models, sparse
from fm_spark_tpu_torch.ops import scatter
from fm_spark_tpu_torch.train import TrainConfig, fit_field_sparse
from fm_spark_tpu_torch.utils.logging import MetricsLogger

F, BUCKET, K, B, CAP = 5, 64, 4, 48, 40


def _batch(rng, b=B, f=F, bucket=CAP, overflow=False):
    """A batch whose fields fit the cap, but with ``overflow`` field 2,
    whose ids are all distinct."""
    ids = rng.integers(0, bucket, size=(b, f)).astype(np.int32)
    ids[:, 0] = rng.integers(0, 3, b)          # heavy duplication
    if overflow:
        ids[:, 2] = rng.permutation(b).astype(np.int32)   # near-unique
    vals = rng.normal(size=(b, f)).astype(np.float32)
    labels = rng.integers(0, 2, b).astype(np.float32)
    weights = np.ones(b, np.float32)
    weights[::7] = 0.0                          # inert rows
    return ids, vals, labels, weights


def _jit_exact(fn):
    """JAX's jitted ``fn`` with every bf16 operation rounded as written."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False}))
        return compiled[0](*args)

    return call


def _specs(family, pd, cd):
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET,
              param_dtype=pd, compute_dtype=cd, init_std=0.1)
    if family == "ffm":
        return (jmodels.FieldFFMSpec(rank=3, **kw),
                models.FieldFFMSpec(rank=3, **kw))
    return jmodels.FieldFMSpec(rank=K, **kw), models.FieldFMSpec(rank=K, **kw)


def _carry(pspec, jp):
    flat = {"w0": np.asarray(jp["w0"])}
    flat.update({f"vw/{f}": np.asarray(t.astype(jnp.float32))
                 for f, t in enumerate(jp["vw"])})
    return models.params_from_numpy(pspec, flat, "cpu")


def _same_bits(got, want):
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("b,f,bucket,cap", [
    (40, 3, 17, 24), (B, F, BUCKET, B), (1, 2, 5, 1), (300, 4, 1000, 300),
    (256, 39, 30, 40)])
def test_device_aux_matches_host_aux_bitwise(b, f, bucket, cap):
    rng = np.random.default_rng(b + f)
    ids = (rng.zipf(1.3, (b, f)) % bucket).astype(np.int32)
    want = jscatter.compact_aux(ids, cap)
    host = scatter.compact_aux(ids, cap)
    got, nseg = scatter.device_compact_aux(torch.from_numpy(ids), cap)
    names = ("useg", "segstart", "segend", "order", "inv")
    for g, h, w, name in zip(got, host, want, names):
        assert g.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
        np.testing.assert_array_equal(h, w, err_msg=name)
    np.testing.assert_array_equal(
        nseg.numpy(), [np.unique(ids[:, j]).size for j in range(f)])


@pytest.mark.parametrize("case,cap", [("arange", 8), ("batch", 8),
                                      ("batch", CAP)])
def test_device_aux_overflow_matches_jax(case, cap):
    rng = np.random.default_rng(0)
    if case == "arange":
        # 30 unique ids, cap 8: segments 8.. (the LARGEST ids) lose their
        # slot; the first 8 stay exact.
        ids = rng.permutation(30).astype(np.int32)[:, None]
    else:
        ids = _batch(rng, overflow=True)[0]
    want, want_nseg = jax.vmap(
        lambda col: jscatter.device_compact_aux(col, cap), in_axes=1)(
            jnp.asarray(ids))
    got, nseg = scatter.device_compact_aux(torch.from_numpy(ids), cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(nseg.numpy(), np.asarray(want_nseg))
    assert int(nseg.max()) > cap
    if case == "arange":
        np.testing.assert_array_equal(got[0][0].numpy(), np.arange(cap))
        # inv still maps every lane to its true segment (>= cap: dropped).
        np.testing.assert_array_equal(np.sort(got[4][0].numpy()),
                                      np.arange(30))


LEVERS = {"plain": {}, "gfull+segtotal": dict(gfull_fused=True,
                                              segtotal_pallas=True),
          "fusedbwd": dict(fused_embed="require"),
          "selblk": dict(sel_blocked=True)}


@pytest.mark.parametrize("family,lever", [
    ("fm", "plain"), ("fm", "gfull+segtotal"), ("fm", "fusedbwd"),
    ("ffm", "plain"), ("ffm", "selblk")])
@pytest.mark.parametrize("policy", ["error", "drop"])
@pytest.mark.parametrize("mode,pd,cd", [("dedup", "float32", "float32"),
                                        ("dedup_sr", "bfloat16", "bfloat16")])
def test_compact_device_steps_match_jax(family, lever, policy, mode, pd, cd):
    """Three steps, the second with a field past the cap: under 'error'
    its loss is −inf on both sides, under 'drop' finite; the tables are
    the same bits after every step either way."""
    jspec, pspec = _specs(family, pd, cd)
    cfg = dict(learning_rate=0.05, reg_factors=1e-4, reg_linear=1e-5,
               reg_bias=1e-6, sparse_update=mode, seed=3,
               compact_device=True, compact_cap=CAP,
               compact_overflow=policy, **LEVERS[lever])
    jbody = (jsparse.make_field_ffm_sparse_sgd_body if family == "ffm"
             else jsparse.make_field_sparse_sgd_body)(
        jspec, jtrain.TrainConfig(**cfg))
    pstep = (sparse.make_field_ffm_sparse_sgd_body if family == "ffm"
             else sparse.make_field_sparse_sgd_body)(pspec, TrainConfig(**cfg))
    jstep = _jit_exact(jbody)
    jp = jspec.init(jax.random.key(0))
    pp = _carry(pspec, jp)
    rng = np.random.default_rng(5)
    for i in range(3):
        batch = _batch(rng, overflow=i == 1)
        jp, jl = jstep(jp, jnp.int32(i), *map(jnp.asarray, batch))
        pp, pl = pstep(pp, i, *map(torch.from_numpy, batch))
        assert np.isneginf(float(jl)) == (policy == "error" and i == 1)
        assert np.isneginf(float(pl)) == np.isneginf(float(jl))
        if mode == "dedup_sr":
            assert float(pl) == float(jl)
            for f in range(F):
                _same_bits(pp["vw"][f], jp["vw"][f])
        else:
            # float32 sums over the batch and the segments, in another
            # order: the reference's fp32 step tolerances.
            assert abs(float(pl) - float(jl)) < 1e-6 or np.isneginf(float(pl))
            for f in range(F):
                np.testing.assert_allclose(pp["vw"][f].numpy(),
                                           np.asarray(jp["vw"][f]),
                                           rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(pp["w0"]), float(jp["w0"]),
                                   rtol=1e-6, atol=1e-8)


def test_overflow_drop_acts_as_absent_features():
    """'drop' trains as if the ids past the cap-th unique of a field were
    absent (val = 0): bit for bit with reg = 0 (the reference's case)."""
    b = 48
    rng = np.random.default_rng(1)
    ids, vals, labels, weights = _batch(rng, b=b, overflow=True)
    _, pspec = _specs("fm", "float32", "float32")
    cfg = dict(learning_rate=0.05, sparse_update="dedup",
               compact_device=True)
    drop = sparse.make_field_sparse_sgd_body(
        pspec, TrainConfig(**cfg, compact_cap=CAP, compact_overflow="drop"))
    ref = sparse.make_field_sparse_sgd_body(
        pspec, TrainConfig(**cfg, compact_cap=b))
    vals_ref = vals.copy()
    for f in range(F):
        uniq = np.unique(ids[:, f])
        if uniq.size > CAP:
            vals_ref[np.isin(ids[:, f], uniq[CAP:]), f] = 0.0
    p1 = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    p2 = {"w0": p1["w0"].clone(), "vw": [t.clone() for t in p1["vw"]]}
    p1, l1 = drop(p1, 0, *map(torch.from_numpy, (ids, vals, labels, weights)))
    p2, l2 = ref(p2, 0, *map(torch.from_numpy, (ids, vals_ref, labels,
                                                weights)))
    assert np.isfinite(float(l1)) and float(l1) == float(l2)
    assert torch.equal(p1["w0"], p2["w0"])
    assert all(torch.equal(a, c) for a, c in zip(p1["vw"], p2["vw"]))


def test_multistep_poison_is_sticky():
    """The roll keeps an inner step's −inf when a later step is clean."""
    rng = np.random.default_rng(2)
    first = _batch(rng, overflow=True)
    second = _batch(rng)
    _, pspec = _specs("fm", "float32", "float32")
    cfg = TrainConfig(learning_rate=0.05, sparse_update="dedup",
                      compact_device=True, compact_cap=CAP)
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(first, second)]
    params = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    _, loss = sparse.make_field_sparse_multistep(pspec, cfg, 2)(
        params, 0, 2, *stacked)
    assert np.isneginf(float(loss))


@pytest.mark.parametrize("cfg", [
    dict(sparse_update="dedup", compact_device=True),
    dict(sparse_update="dedup", compact_device=True, host_dedup=True,
         compact_cap=8),
    dict(sparse_update="dedup", host_dedup=True, compact_cap=8,
         compact_overflow="drop"),
    dict(sparse_update="dedup", compact_device=True, compact_cap=8,
         compact_overflow="split"),
    dict(compact_overflow="drop"),
    dict(sparse_update="scatter_add", compact_device=True, compact_cap=8),
    dict(sparse_update="dedup", compact_device=True, compact_cap=8,
         use_pallas=True),
])
@pytest.mark.parametrize("family", ["fm", "ffm"])
def test_compact_device_guards_raise_the_same(cfg, family):
    jspec, pspec = _specs(family, "float32", "float32")
    jmake = (jsparse.make_field_ffm_sparse_sgd_body if family == "ffm"
             else jsparse.make_field_sparse_sgd_body)
    pmake = (sparse.make_field_ffm_sparse_sgd_body if family == "ffm"
             else sparse.make_field_sparse_sgd_body)
    with pytest.raises(ValueError) as want:
        jmake(jspec, jtrain.TrainConfig(**cfg))
    with pytest.raises(ValueError) as got:
        pmake(pspec, TrainConfig(**cfg))
    assert str(got.value) == str(want.value)


def test_error_policy_needs_a_non_negative_loss():
    with pytest.raises(ValueError, match="non-negative losses"):
        sparse._check_host_dedup(
            TrainConfig(sparse_update="dedup_sr", compact_device=True,
                        compact_cap=8), "exotic_negative_loss")


class _Source:
    """The same batch each call."""

    def __init__(self, batch):
        self.batch = batch

    def next_batch(self):
        return self.batch


def test_fit_raises_on_the_overflow_poison():
    rng = np.random.default_rng(3)
    _, pspec = _specs("fm", "float32", "float32")
    cfg = TrainConfig(num_steps=2, batch_size=B, learning_rate=0.05,
                      sparse_update="dedup", compact_device=True,
                      compact_cap=CAP)
    with pytest.raises(RuntimeError, match="overflow poisoned the loss"):
        fit_field_sparse(pspec, cfg, _Source(_batch(rng, overflow=True)),
                         device="cpu", logger=MetricsLogger())
    # 'drop' trains through, building no host aux.
    stats = {}
    fit_field_sparse(pspec, TrainConfig(**{**cfg.__dict__,
                                           "compact_overflow": "drop"}),
                     _Source(_batch(rng, overflow=True)), device="cpu",
                     stats=stats)
    assert np.isfinite(stats["loss"]).all() and stats["aux_ms"] == []


class _Seq:
    """The given batches in turn."""

    def __init__(self, batches):
        self.batches = list(batches)

    def next_batch(self):
        return self.batches.pop(0)


@pytest.mark.parametrize("logged", [False, True])
@pytest.mark.parametrize("steps_per_call", [1, 2])
def test_fit_raises_on_an_overflow_between_clean_log_steps(logged,
                                                           steps_per_call):
    """Only the second of four batches overflows; the logged losses are
    clean (one line, at the last step, with log_every=100), yet the run
    raises: the detector is a running fmin over every step's loss, read
    at each log line and at the end of fit."""
    rng = np.random.default_rng(4)
    _, pspec = _specs("fm", "float32", "float32")
    cfg = TrainConfig(num_steps=4, batch_size=B, learning_rate=0.05,
                      sparse_update="dedup", compact_device=True,
                      compact_cap=CAP, log_every=100)
    batches = [_batch(rng, overflow=(j == 1)) for j in range(4)]
    stats = {}
    with pytest.raises(RuntimeError, match="overflow poisoned the loss"):
        fit_field_sparse(pspec, cfg, _Seq(batches), device="cpu",
                         steps_per_call=steps_per_call, prefetch=0,
                         logger=MetricsLogger() if logged else None,
                         stats=stats)
    # Under 'drop' the same batches train through.
    fit_field_sparse(pspec, TrainConfig(**{**cfg.__dict__,
                                           "compact_overflow": "drop"}),
                     _Seq(batches), device="cpu",
                     steps_per_call=steps_per_call, prefetch=0, stats=stats)
    assert np.isfinite(stats["loss"]).all()


def test_cli_trains_with_the_device_aux(capsys):
    args = ["train", "--config", "criteo1tb_fm_r64", "--bucket", "64",
            "--synthetic", "600", "--steps", "2", "--batch-size", "128",
            "--sparse-update", "dedup_sr", "--compact-cap", "128",
            "--compact-device", "--test-fraction", "0", "--device", "cpu"]
    assert cli.main(args) == 0
    out = capsys.readouterr().out
    assert '"loss"' in out and "-inf" not in out
    with pytest.raises(SystemExit, match="--compact-overflow drop has no "
                                         "effect without --compact-cap"):
        cli.main(["train", "--config", "criteo1tb_fm_r64", "--synthetic",
                  "10", "--steps", "1", "--compact-overflow", "drop",
                  "--device", "cpu"])
