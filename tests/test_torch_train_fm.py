"""The port's flat-FM training (configs 1 and 2) against the JAX package:
the dense optax step (``train.make_train_step``), ``dp`` on one device,
the flat sparse step (``sparse.make_sparse_sgd_step``), ``FMTrainer``'s
stop and resume, ``evaluate_params(max_batches=)`` and ``fmtorch
train/eval/predict --config movielens_fm_r8``.

Shapes, cut to small widths: config 1's (two ids per row, a user in
``[0, 30)`` and an item in ``[30, 70)``, rank 8) and config 2's (39
fields of 16 buckets, global ids ``field·16 + zipf % 16``, rank 4), B =
64, with zero-weight tail lanes and a few ids out of range. Parameters
are drawn by JAX and carried across by ``params_from_numpy``.

Tolerances, and why:

- float32 tables: after 5 steps every parameter within ``rtol=1e-5,
  atol=1e-6`` of JAX's, the loss and ``grad_norm`` within ``rtol=1e-5``.
  XLA's CPU scatter adds a duplicated id's lanes in lane order, the port's
  device dedup in sorted order (kernel A's plain version on the CPU), and
  the batch sums add in another order: a few float32 ulps per step.
- bf16 tables: JAX's gradient is scattered in bf16, one rounding per
  duplicate lane (in the sparse step each lane's delta rounds to bf16
  before it is added), where the port sums each id's lanes in float32 and
  rounds once; bits cannot match. The dense step's parameters are held
  by how far they moved, with float32 or bf16 compute: ``‖port − jax‖ ≤
  0.2·‖jax − init‖`` (measured ≤ 11 %). The sparse
  step's cannot be (JAX's per-lane rounding loses the small deltas of
  config 1's factors, so its table barely moves: 63 % off by that
  measure); they are held against the port's float32 run from the same
  params: the port's bf16 run no farther from it than 1.25 times JAX's
  bf16 run (measured: 0.2-1.0 times). The loss within 1e-3 with float32
  compute; the sparse step also runs bf16 compute, whose scores round to
  bf16: its loss within 2⁻⁸ (half a bf16 ulp of a unit score).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu import sparse as jsparse
from fm_spark_tpu import train as jtrain
from fm_spark_tpu.parallel import make_mesh, make_parallel_train_step
from fm_spark_tpu.parallel import shard_batch, shard_params
from fm_spark_tpu_torch import cli, models, sparse
from fm_spark_tpu_torch import train as ptrain
from fm_spark_tpu_torch.checkpoint import Checkpointer
from fm_spark_tpu_torch.data import Batches, BernoulliBatches, movielens

B, STEPS = 64, 5
SHAPES = {
    # name: (num_features, rank, ids of one batch from a numpy rng)
    "config1": (70, 8, lambda rng: np.stack(
        [rng.integers(0, 30, B), 30 + rng.zipf(1.5, B) % 40], 1)),
    "config2": (39 * 16, 4, lambda rng: (
        np.arange(39) * 16 + rng.zipf(1.3, (B, 39)) % 16)),
}
REGS = {"none": (0.0, 0.0, 0.0), "triple": (1e-3, 1e-2, 3e-2)}


def _specs(shape, pd="float32", **kw):
    n, k, _ = SHAPES[shape]
    kw = dict(num_features=n, rank=k, param_dtype=pd, init_std=0.1, **kw)
    return jmodels.FMSpec(**kw), models.FMSpec(**kw)


def _carry(pspec, jp):
    flat = {k: np.asarray(jnp.asarray(v, jnp.float32)) for k, v in jp.items()}
    return models.params_from_numpy(pspec, flat, "cpu")


def _batches(shape, n=STEPS, seed=1, bad_ids=True):
    n_feat, _, make_ids = SHAPES[shape]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = make_ids(rng).astype(np.int32)
        if bad_ids:
            ids[0, 0], ids[1, -1], ids[2, 0] = -2, n_feat + 3, -n_feat - 1
        vals = rng.uniform(0.5, 1.5, ids.shape).astype(np.float32)
        labels = rng.integers(0, 2, B).astype(np.float32)
        weights = np.ones(B, np.float32)
        weights[-6:] = 0.0                       # padded tail lanes
        out.append((ids, vals, labels, weights))
    return out


def _t(batch):
    return [torch.from_numpy(a.copy()) for a in batch]


def _cfgs(sched, reg, **kw):
    r0, r1, r2 = REGS[reg]
    cfg = dict(learning_rate=0.2, lr_schedule=sched, reg_bias=r0,
               reg_linear=r1, reg_factors=r2, **kw)
    return jtrain.TrainConfig(**cfg), ptrain.TrainConfig(**cfg)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _hold(pp, jp, init=None, ref=None):
    """float32: every parameter within the stated tolerance of JAX's. bf16:
    with ``init`` (the initial params), within 20 % of how far JAX's
    moved; with ``ref`` (the port's float32 run from the same params), no
    farther from the float32 run than 1.25 times JAX's bf16 run."""
    for key in ("w0", "w", "v"):
        got, want = pp[key].float().numpy(), _np(jp[key])
        if init is not None:
            moved = np.linalg.norm(want - init[key])
            assert np.linalg.norm(got - want) <= 0.2 * moved, key
        elif ref is not None:
            exact = ref[key].numpy()
            assert (np.linalg.norm(got - exact)
                    <= 1.25 * np.linalg.norm(want - exact) + 1e-7), key
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=key)


def _reference(pspec, jp, make_step, batches, **kw):
    """The port's float32 run of ``make_step`` from JAX's params."""
    import dataclasses

    spec32 = dataclasses.replace(pspec, param_dtype="float32",
                                 compute_dtype="float32")
    p32 = _carry(spec32, jp)
    step, state = make_step(spec32, p32)
    for i, batch in enumerate(batches):
        state = step(state, i, batch)
    return p32


@pytest.mark.parametrize("pd,cd", [("float32", "float32"),
                                   ("bfloat16", "float32"),
                                   ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("reg", list(REGS))
@pytest.mark.parametrize("sched", ["inv_sqrt", "constant"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_dense_steps_match_jax(shape, sched, reg, pd, cd):
    jspec, pspec = _specs(shape, pd, compute_dtype=cd)
    jcfg, pcfg = _cfgs(sched, reg)
    jp = jspec.init(jax.random.key(0))
    init = None if pd == "float32" else {k: _np(v) for k, v in jp.items()}
    pp = _carry(pspec, jp)
    jopt, popt = jtrain.make_optimizer(jcfg), ptrain.make_optimizer(pcfg)
    jo, po = jopt.init(jp), popt.init(pp)
    jstep = jtrain.make_train_step(jspec, jcfg, jopt)
    pstep = ptrain.make_train_step(pspec, pcfg, popt)
    for batch in _batches(shape):
        jp, jo, jm = jstep(jp, jo, *map(jnp.asarray, batch))
        pp, po, pm = pstep(pp, po, *_t(batch))
        tol = dict(rtol=1e-5) if pd == "float32" else dict(rtol=0, atol=1e-3)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]), **tol)
        if pd == "float32":
            np.testing.assert_allclose(float(pm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-5)
    _hold(pp, jp, init=init)
    if sched == "inv_sqrt":            # the schedule's count, on the device
        assert int(po["schedule_count"]) == int(jo[-1].count) == STEPS


def test_dp_on_one_device_equals_single():
    """Config 2's strategy ``dp``: JAX's parallel step on a mesh of one
    device, against the port's step (the one ``fmtorch train`` runs for
    ``dp``), 5 steps from the same params."""
    jspec, pspec = _specs("config2")
    jcfg, pcfg = _cfgs("constant", "triple")
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    jp = jspec.init(jax.random.key(0))
    pp = _carry(pspec, jp)
    jopt = jtrain.make_optimizer(jcfg)
    jp = shard_params(jp, mesh, jspec, "dp")
    jo = jopt.init(jp)
    jstep = make_parallel_train_step(jspec, jcfg, mesh, "dp", jopt)
    pstep = ptrain.make_train_step(pspec, pcfg)
    po = ptrain.make_optimizer(pcfg).init(pp)
    for batch in _batches("config2"):
        jp, jo, jm = jstep(jp, jo, *shard_batch(batch, mesh))
        pp, po, pm = pstep(pp, po, *_t(batch))
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    _hold(pp, jp)


@pytest.mark.parametrize("pd", ["float32", "bfloat16"])
@pytest.mark.parametrize("sched,reg", [("inv_sqrt", "triple"),
                                       ("constant", "none")])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_sparse_sgd_steps_match_jax(shape, sched, reg, pd):
    """The flat lazy-L2 sparse step: only gathered rows of weighted lanes
    decay; its writes go through the device dedup."""
    jspec, pspec = _specs(shape, pd, compute_dtype=pd)
    jcfg, pcfg = _cfgs(sched, reg)
    jp = jspec.init(jax.random.key(0))
    pp = _carry(pspec, jp)

    def flat(spec, params):
        step = sparse.make_sparse_sgd_step(spec, pcfg)
        return lambda _, i, b: step(params, i, *_t(b)), None

    ref = (None if pd == "float32"
           else _reference(pspec, jp, flat, _batches(shape)))
    jstep = jsparse.make_sparse_sgd_step(jspec, jcfg)
    pstep = sparse.make_sparse_sgd_step(pspec, pcfg)
    for i, batch in enumerate(_batches(shape)):
        jp, jl = jstep(jp, jnp.int32(i), *map(jnp.asarray, batch))
        pp, pl = pstep(pp, i, *_t(batch))
        # bf16 compute: the scores round to bf16, so the loss is held to
        # half a bf16 ulp of a unit score.
        tol = dict(rtol=1e-5) if pd == "float32" else dict(rtol=0, atol=2**-8)
        np.testing.assert_allclose(float(pl), float(jl), **tol)
    _hold(pp, jp, ref=ref)


def test_sparse_sgd_step_keeps_the_reference_guards():
    _, pspec = _specs("config1")
    fspec = models.FieldFMSpec(num_features=8, rank=2, num_fields=2, bucket=4)
    with pytest.raises(ValueError, match="plain FM family only"):
        sparse.make_sparse_sgd_step(fspec, ptrain.TrainConfig())
    with pytest.raises(ValueError, match="plain SGD only"):
        sparse.make_sparse_sgd_step(pspec, ptrain.TrainConfig(optimizer="adam"))
    with pytest.raises(ValueError, match="gfull_fused"):
        sparse.make_sparse_sgd_step(pspec, ptrain.TrainConfig(gfull_fused=True))
    with pytest.raises(ValueError, match="TieredTrainer"):
        sparse.make_sparse_sgd_step(pspec,
                                    ptrain.TrainConfig(embed_tier="require"))
    with pytest.raises(ValueError, match="HOST-built"):
        ptrain.make_train_step(pspec, ptrain.TrainConfig(host_dedup=True))
    # The flat FFM builds, and so does a field spec (the field families'
    # generic dense step); a family with no dense step raises.
    ffm = models.FFMSpec(num_features=8, rank=2, num_fields=2)
    assert callable(ptrain.make_train_step(ffm, ptrain.TrainConfig()))
    assert callable(ptrain.make_train_step(fspec, ptrain.TrainConfig()))
    with pytest.raises(ValueError, match="no dense train step"):
        ptrain._dense_grads_fn(object())


def _trainer(pspec, jp, cfg):
    tr = ptrain.FMTrainer(pspec, cfg, device="cpu")
    from fm_spark_tpu_torch.checkpoint import copy_into

    copy_into(tr.params, _carry(pspec, jp))
    return tr


@pytest.mark.parametrize("bernoulli", [False, True])
def test_trainer_stop_and_resume_equals_the_uninterrupted_run(tmp_path,
                                                              bernoulli):
    """6 steps uninterrupted against 3 steps, a new trainer and process
    state, and a resume to 6 from the chain: params, optimizer count,
    step and ``loss_history`` equal bit for bit."""
    jspec, pspec = _specs("config1")
    _, cfg = _cfgs("inv_sqrt", "triple", log_every=1)
    jp = jspec.init(jax.random.key(0))
    data = [np.concatenate(a) for a in zip(*_batches("config1", 4,
                                                     bad_ids=False))]

    def source():
        if bernoulli:
            return BernoulliBatches(*data[:3], 0.4, seed=3)
        return Batches(*data[:3], B, seed=3)

    whole = _trainer(pspec, jp, cfg)
    whole.fit(source(), num_steps=6,
              checkpointer=Checkpointer(str(tmp_path / "a"), save_every=2))
    first = _trainer(pspec, jp, cfg)
    first.fit(source(), num_steps=3,
              checkpointer=Checkpointer(str(tmp_path / "b"), save_every=2))
    second = _trainer(pspec, jp, cfg)
    second.fit(source(), num_steps=6,
               checkpointer=Checkpointer(str(tmp_path / "b"), save_every=2))
    assert second.resumed["step"] == 3 and second.step_count == 6
    assert second.loss_history == whole.loss_history
    assert len(whole.loss_history) == 6
    for key in ("w0", "w", "v"):
        assert torch.equal(second.params[key], whole.params[key]), key
    assert int(second.opt_state["schedule_count"]) == 6


def test_trainer_refuses_the_unported_planes():
    """Every plane of the reference's ``fit`` is ported now (the
    supervisor and the elastic controller since item 12a): each refuses
    what the reference's refuses, with its message."""
    jspec, pspec = _specs("config1")
    tr = ptrain.FMTrainer(pspec, ptrain.TrainConfig(), device="cpu")
    jtr = jtrain.FMTrainer(jspec, jtrain.TrainConfig())
    for kw in ({"supervisor": object()}, {"elastic": object()}):
        with pytest.raises(ValueError) as want:
            jtr.fit(iter([]), **kw)
        with pytest.raises(ValueError) as got:
            tr.fit(iter([]), **kw)
        assert str(got.value) == str(want.value)
    # The divergence guard is served (the planes it needs are ported); it
    # refuses to run without a chain to roll back to, as the reference's.
    with pytest.raises(ValueError, match="needs a checkpointer"):
        tr.fit(iter([]), divergence_guard=object())
    with pytest.raises(ValueError, match="resumable batch source"):
        tr.fit(iter([]), checkpointer=object())


@pytest.mark.parametrize("max_batches", [None, 2])
def test_evaluate_params_matches_jax(max_batches):
    jspec, pspec = _specs("config2")
    jp = jspec.init(jax.random.key(2))
    pp = _carry(pspec, jp)
    batches = _batches("config2", 4, seed=5, bad_ids=False)
    want = jtrain.evaluate_params(jspec, jp, batches, max_batches=max_batches)
    got = ptrain.evaluate_params(pspec, pp, batches, max_batches=max_batches)
    assert got["count"] == want["count"] == B * (max_batches or 4) - 6 * (
        max_batches or 4)
    for key in ("auc", "logloss", "rmse"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-6)


def test_fmtorch_train_eval_predict_movielens(tmp_path, capsys):
    """``fmtorch`` on a synthesized ratings file, config 1 (a narrow
    batch): training logs falling loss lines and an eval; the model dir
    loads in JAX, whose predictions and metrics on the same file equal the
    port's ``predict`` (to its ``%.6g`` lines) and ``eval``."""
    from fm_spark_tpu.data import movielens as jmovielens
    from fm_spark_tpu.data import iterate_once

    path = str(tmp_path / "u.data")
    movielens.synthesize_ratings(path, 60, 90, 3000, seed=0)
    model = str(tmp_path / "model")
    assert cli.main(["train", "--config", "movielens_fm_r8", "--data", path,
                     "--steps", "12", "--batch-size", "512", "--log-every",
                     "4", "--model-out", model, "--device", "cpu"]) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    losses = [r["loss"] for r in out if "loss" in r]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert "auc" in next(r for r in out if "eval" in r)["eval"]
    assert cli.main(["eval", "--model", model, "--config", "movielens_fm_r8",
                     "--data", path, "--device", "cpu"]) == 0
    got_eval = json.loads(capsys.readouterr().out.splitlines()[-1])
    preds = str(tmp_path / "p.txt")
    assert cli.main(["predict", "--model", model, "--config",
                     "movielens_fm_r8", "--data", path, "--batch-size",
                     "1024", "--out", preds, "--device", "cpu"]) == 0
    got = np.loadtxt(preds)
    jspec, jp = jmodels.load_model(model)
    (ids, vals, labels), meta = jmovielens.load_ratings(path)
    assert jspec.num_features == meta["num_features"]
    want = np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals)))
    assert got.shape == want.shape == (3000,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want_eval = jtrain.evaluate_params(
        jspec, jp, iterate_once(ids, vals, labels, 8192))
    for key in ("auc", "logloss", "rmse", "count"):
        np.testing.assert_allclose(got_eval[key], want_eval[key], rtol=1e-5)
