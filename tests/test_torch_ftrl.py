"""The port's per-coordinate optimizers (``fm_spark_tpu_torch/optim``)
against the JAX package's ``optim``: the row rules, FTRL as the dense
optimizer of the flat FM's train step (config 1 and 2 shapes, cut to
small widths), the sparse adaptive step (``make_sparse_adaptive_step``,
FTRL and AdaGrad) and FTRL's state through a stop and resume of
``FMTrainer``.

Parameters are drawn by JAX and carried across by ``params_from_numpy``;
batches are numpy from a seed, with duplicate ids, zero-weight tail lanes
and ids out of range (past the table and below ``-n``: clamped in the
gather, dropped from the write). JAX's steps are compiled with
``xla_allow_excess_precision`` off.

Tolerances, and why:

- the row rules: bit for bit. Both sides round the same float32
  operations once each, in the same order (Python scalars rounded to
  float32 first, as JAX's weak types).
- the dense FTRL step, float32 tables: every parameter within
  ``rtol=1e-5, atol=1e-6`` of JAX's after 5 steps, the loss and
  ``grad_norm`` within ``rtol=1e-5``: the two sides sum a duplicated id's
  lanes and the batch in different orders (a few float32 ulps per step),
  which FTRL's closed form carries through ``√n`` and ``z``.
- bf16 tables: JAX scatters the gradient in bf16, one rounding per
  duplicate lane, where the port sums each id's lanes in float32 and
  rounds once, so bits cannot match; the parameters are held by how far
  they moved, ``‖port − jax‖ ≤ 0.2·‖jax − init‖`` (as the SGD dense
  step's in ``tests/test_torch_train_fm.py``), the loss within 1e-3.
- the sparse adaptive step, float32: the loss within ``rtol=1e-5``, the
  params within ``rtol=1e-5, atol=1e-6`` (FTRL) or ``atol=1e-6 +
  1e-3·lr`` (AdaGrad, whose first touch of a coordinate is scale-free,
  ``lr·g/(|g| + eps)``, so the ulps of a gradient that cancels reach the
  step, as Adam's do) and each table within 1e-4 of how far JAX's moved
  (L2); the slots within ``rtol=1e-5`` and 1e-4 of their largest value.
  Measured over four seeds: element gaps ≤ 1.9e-5 (AdaGrad) and ≤ 6e-8
  (FTRL), L2 gaps ≤ 7.2e-6 of the movement, slot gaps ≤ 1.2e-5 of the
  largest value. Rows and slots no lane touches bit-unchanged.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu import optim as joptim
from fm_spark_tpu import train as jtrain
from fm_spark_tpu_torch import models, optim
from fm_spark_tpu_torch import train as ptrain
from fm_spark_tpu_torch.checkpoint import Checkpointer, copy_into
from fm_spark_tpu_torch.data import Batches

B, STEPS = 64, 5
SHAPES = {
    # name: (num_features, rank, ids of one batch from a numpy rng)
    "config1": (70, 8, lambda rng: np.stack(
        [rng.integers(0, 30, B), 30 + rng.zipf(1.5, B) % 40], 1)),
    "config2": (39 * 16, 4, lambda rng: (
        np.arange(39) * 16 + rng.zipf(1.3, (B, 39)) % 16)),
}
TRIPLE = dict(reg_bias=1e-3, reg_linear=1e-2, reg_factors=3e-2)


def _exact(fn):
    """``fn`` (jitted or not) compiled with every operation rounded as
    written."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False}))
        return compiled[0](*args)

    return call


def _specs(shape, pd="float32", **kw):
    n, k, _ = SHAPES[shape]
    kw = dict(num_features=n, rank=k, param_dtype=pd, init_std=0.1, **kw)
    return jmodels.FMSpec(**kw), models.FMSpec(**kw)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _carry(pspec, jp):
    return models.params_from_numpy(
        pspec, {k: _np(v) for k, v in jp.items()}, "cpu")


def _batches(shape, n=STEPS, seed=1, bad_ids=True):
    n_feat, _, make_ids = SHAPES[shape]
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = make_ids(rng).astype(np.int32)
        if bad_ids:
            ids[0, 0], ids[1, -1] = n_feat + 3, -n_feat - 4
        vals = rng.uniform(0.5, 1.5, ids.shape).astype(np.float32)
        labels = rng.integers(0, 2, B).astype(np.float32)
        weights = np.ones(B, np.float32)
        weights[-6:] = 0.0                       # padded tail lanes
        out.append((ids, vals, labels, weights))
    return out


def _t(batch):
    return [torch.from_numpy(a.copy()) for a in batch]


# ------------------------------------------------------------ row rules


@pytest.mark.parametrize("rule", ["adagrad", "ftrl", "ftrl-l1l2", "init_z"])
def test_row_rules_equal_jax_bit_for_bit(rule):
    rng = np.random.default_rng(0)
    rows, g = (rng.normal(size=(40, 5)).astype(np.float32) for _ in range(2))
    g[::7] = 0.0                                  # untouched coordinates
    z = rng.normal(size=(40, 5)).astype(np.float32)
    n = rng.uniform(0, 2, (40, 5)).astype(np.float32)
    t = [torch.from_numpy(a.copy()) for a in (rows, z, n, g)]
    if rule == "adagrad":
        want = joptim.adagrad_rows(rows, n, g, 0.07)
        got = optim.adagrad_rows(t[0], t[2], t[3], 0.07)
    elif rule == "init_z":
        want = (joptim.ftrl_init_z(rows, 0.07, 1.3),)
        got = (optim.ftrl_init_z(t[0], 0.07, 1.3),)
    else:
        l1, l2 = (0.3, 0.01) if rule == "ftrl-l1l2" else (0.0, 0.0)
        want = joptim.ftrl_rows(rows, z, n, g, 0.07, 1.3, l1, l2)
        got = optim.ftrl_rows(*t, 0.07, 1.3, l1, l2)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_zero_gradient_is_a_fixpoint_and_l1_gives_exact_zeros():
    """With ``z`` seeded by ``ftrl_init_z`` a zero gradient leaves every
    weight where it was (within an ulp of the quotient β/α), as JAX's; a
    large l1 makes the proximal solution exactly 0."""
    spec = models.FMSpec(num_features=32, rank=4, init_std=0.05)
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    opt = ptrain.make_optimizer(ptrain.TrainConfig(optimizer="ftrl",
                                                   learning_rate=0.1))
    state = opt.init(params)
    before = {k: v.clone() for k, v in params.items()}
    zero = {k: torch.zeros_like(v) for k, v in params.items()}
    ptrain.apply_updates(params, opt.update(zero, state, params))
    for k in params:
        torch.testing.assert_close(params[k], before[k], rtol=0, atol=1e-6)
        assert torch.equal(state["n"][k], torch.zeros_like(params[k]))
    rows = torch.full((4, 2), 0.01)
    new, _, n2 = optim.ftrl_rows(rows, torch.zeros(4, 2), torch.zeros(4, 2),
                                 torch.full((4, 2), 1e-4), alpha=0.1,
                                 beta=1.0, l1=1.0, l2=0.0)
    assert torch.equal(new, torch.zeros_like(new)) and bool((n2 > 0).all())


# ------------------------------------------------------- the dense step


def _hold(pp, jp, init=None):
    for key in ("w0", "w", "v"):
        got, want = pp[key].float().numpy(), _np(jp[key])
        if init is None:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=key)
        else:
            moved = np.linalg.norm(want - init[key])
            assert np.linalg.norm(got - want) <= 0.2 * moved, key


@pytest.mark.parametrize("pd", ["float32", "bfloat16"])
@pytest.mark.parametrize("reg", ["none", "triple"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_dense_ftrl_step_matches_jax(shape, reg, pd):
    """Five dense steps with ``optimizer='ftrl'``: the reg triple routes
    into FTRL's proximal l2 per group (``_group_reg`` is the identity),
    the state ``z``/``n`` is float32 like the params, the deltas are cast
    to the gradient's dtype before ``apply_updates`` adds them."""
    jspec, pspec = _specs(shape, pd)
    kw = dict(learning_rate=0.2, optimizer="ftrl", lr_schedule="inv_sqrt",
              **(TRIPLE if reg == "triple" else {}))
    jcfg, pcfg = jtrain.TrainConfig(**kw), ptrain.TrainConfig(**kw)
    jp = jspec.init(jax.random.key(0))
    init = None if pd == "float32" else {k: _np(v) for k, v in jp.items()}
    pp = _carry(pspec, jp)
    jopt, popt = jtrain.make_optimizer(jcfg), ptrain.make_optimizer(pcfg)
    jo, po = jopt.init(jp), popt.init(pp)
    assert sorted(po) == ["n", "z"]
    jstep = _exact(jtrain.make_train_step(jspec, jcfg, jopt))
    pstep = ptrain.make_train_step(pspec, pcfg, popt)
    for batch in _batches(shape):
        jp, jo, jm = jstep(jp, jo, *map(jnp.asarray, batch))
        pp, po, pm = pstep(pp, po, *_t(batch))
        tol = dict(rtol=1e-5) if pd == "float32" else dict(rtol=0, atol=1e-3)
        np.testing.assert_allclose(float(pm["loss"]), float(jm["loss"]),
                                   **tol)
        if pd == "float32":
            np.testing.assert_allclose(float(pm["grad_norm"]),
                                       float(jm["grad_norm"]), rtol=1e-5)
    _hold(pp, jp, init)
    if pd == "float32":
        for slot in ("z", "n"):
            for key in ("w0", "w", "v"):
                np.testing.assert_allclose(
                    po[slot][key].numpy(), _np(getattr(jo, slot)[key]),
                    rtol=1e-5, atol=1e-6, err_msg=f"{slot}/{key}")


def test_ftrl_trainer_stop_and_resume_equals_the_uninterrupted_run(
        tmp_path):
    """FTRL's ``z``/``n`` are the optimizer's state: saved under ``opt/``
    in each step, restored into the trainer's tensors, so a run stopped at
    step 3 and resumed to 6 equals the uninterrupted one bit for bit."""
    jspec, pspec = _specs("config1")
    cfg = ptrain.TrainConfig(learning_rate=0.1, optimizer="ftrl",
                             log_every=1, **TRIPLE)
    jp = jspec.init(jax.random.key(0))
    data = [np.concatenate(a) for a in zip(*_batches("config1", 4,
                                                     bad_ids=False))]

    def trainer():
        tr = ptrain.FMTrainer(pspec, cfg, device="cpu")
        copy_into(tr.params, _carry(pspec, jp))
        tr.opt_state = tr.optimizer.init(tr.params)
        return tr

    def fit(tr, ckdir, steps):
        tr.fit(Batches(*data[:3], B, seed=3), num_steps=steps,
               checkpointer=Checkpointer(str(tmp_path / ckdir), save_every=2))

    whole = trainer()
    fit(whole, "a", 6)
    fit(trainer(), "b", 3)
    second = trainer()
    fit(second, "b", 6)
    assert second.resumed["step"] == 3 and second.step_count == 6
    assert second.loss_history == whole.loss_history
    for key in ("w0", "w", "v"):
        assert torch.equal(second.params[key], whole.params[key]), key
        for slot in ("z", "n"):
            assert torch.equal(second.opt_state[slot][key],
                               whole.opt_state[slot][key]), (slot, key)


# ------------------------------------------------ the sparse adaptive step


def _slots_np(slots):
    return {f"{t}/{s}": _np(v) if not isinstance(v, torch.Tensor)
            else v.numpy() for t in slots for s, v in slots[t].items()}


@pytest.mark.parametrize("use_linear", [True, False])
@pytest.mark.parametrize("optimizer", ["ftrl", "adagrad"])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_sparse_adaptive_step_matches_jax(shape, optimizer, use_linear):
    """Five steps with duplicate (Zipf) ids, zero weights and out-of-range
    ids; FTRL with its own beta, l1 and l2. Rows no lane touches (config
    1's shape leaves some), and their slots, stay bit-unchanged."""
    jspec, pspec = _specs(shape, use_linear=use_linear)
    lr = 0.1
    kw = dict(learning_rate=lr, optimizer=optimizer)
    jcfg, pcfg = jtrain.TrainConfig(**kw), ptrain.TrainConfig(**kw)
    terms = dict(beta=1.3, l1=1e-3, l2=1e-2)
    jp = jspec.init(jax.random.key(0))
    init = {k: _np(v) for k, v in jp.items()}
    pp = _carry(pspec, jp)
    jslots = joptim.init_adaptive_slots(optimizer, jspec, jp)
    pslots = optim.init_adaptive_slots(optimizer, pspec, pp)
    if optimizer == "ftrl":
        jslots = joptim.seed_ftrl_slots(jslots, jp, lr, 1.3)
        optim.seed_ftrl_slots(pslots, pp, lr, 1.3)
    v0 = pp["v"].clone()
    s0 = {k: v.copy() for k, v in _slots_np(pslots).items()}
    jstep = _exact(joptim.make_sparse_adaptive_step(jspec, jcfg, **terms))
    pstep = optim.make_sparse_adaptive_step(pspec, pcfg, **terms)
    touched = set()
    n = pspec.num_features
    for batch in _batches(shape):
        ids = batch[0]
        touched |= {int(i) % n for i in ids.reshape(-1) if -n <= i < n}
        jp, jslots, jl = jstep(jp, jslots, *map(jnp.asarray, batch))
        pp, pslots, pl = pstep(pp, pslots, *_t(batch))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    # AdaGrad's first touch is scale-free (lr·g/(|g| + eps)): the ulps of
    # a gradient that cancels reach the step itself, as Adam's do.
    atol = 1e-6 + (1e-3 * lr if optimizer == "adagrad" else 0.0)
    for key in ("w0", "w", "v"):
        got, want = pp[key].numpy(), _np(jp[key])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=atol,
                                   err_msg=key)
        if key != "w0" and (key == "v" or use_linear):
            assert (np.linalg.norm(got - want)
                    <= 1e-4 * np.linalg.norm(want - init[key])), key
    got, want = _slots_np(pslots), _slots_np(jslots)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   atol=1e-4 * np.abs(want[key]).max(),
                                   err_msg=key)
    untouched = np.array(sorted(set(range(n)) - touched), np.int64)
    assert untouched.size > 0 or shape == "config2"
    assert torch.equal(pp["v"][untouched], v0[untouched])
    for key, before in s0.items():
        np.testing.assert_array_equal(got[key][untouched], before[untouched])


@pytest.mark.parametrize("use_linear", [True, False])
@pytest.mark.parametrize("shape", list(SHAPES))
def test_sparse_step_grads_equal_the_dense_gradient(shape, use_linear):
    """``step.grads``, the totals the rule reads, against the dense step's
    gradient of the same batch (``train._dense_grads_fn``, held against
    JAX's in ``tests/test_torch_train_fm.py``): within ``rtol=1e-5,
    atol=1e-7`` (the two add the score's terms in another order), and
    exactly zero on the rows no in-range id touches."""
    _, pspec = _specs(shape, use_linear=use_linear)
    params = pspec.init(torch.Generator().manual_seed(3), device="cpu")
    step = optim.make_sparse_adaptive_step(pspec, ptrain.TrainConfig(
        optimizer="adagrad", learning_rate=0.1))
    batch = _t(_batches(shape, n=1)[0])
    got = step.grads(params, *batch)
    _, want = ptrain._dense_grads_fn(pspec)(params, *batch)
    for key in ("w0", "w", "v"):
        torch.testing.assert_close(got[key], want[key].float(), rtol=1e-5,
                                   atol=1e-7, msg=key)
        assert bool((got[key][want[key] == 0] == 0).all()), key


def test_duplicate_ids_update_the_schedule_exactly_once():
    """Two lanes of one id reach AdaGrad's ``n`` as their sum, squared
    once: ``n = (g_a + g_b)²``, as the reference's."""
    spec = models.FMSpec(num_features=16, rank=2, init_std=0.05,
                         use_bias=False, use_linear=False)
    params = spec.init(torch.Generator().manual_seed(1), device="cpu")
    p0 = params["v"].clone().numpy()
    step = optim.make_sparse_adaptive_step(spec, ptrain.TrainConfig(
        optimizer="adagrad", learning_rate=0.1, lr_schedule="constant"))
    ids = np.array([[3, 7], [3, 9]], np.int32)
    vals = np.ones((2, 2), np.float32)
    labels = np.array([1.0, 0.0], np.float32)
    slots = optim.init_adaptive_slots("adagrad", spec, params)
    step(params, slots, *_t((ids, vals, labels, np.ones(2, np.float32))))
    xv = p0[ids] * vals[..., None]
    s = xv.sum(axis=1)
    p = 1.0 / (1.0 + np.exp(-0.5 * ((s * s).sum(-1) - (xv * xv).sum((1, 2)))))
    dsc = (p - labels) / 2.0
    g = dsc[:, None, None] * (s[:, None, :] - xv)
    np.testing.assert_allclose(slots["v"]["n"][3].numpy(),
                               (g[0, 0] + g[1, 0]) ** 2, rtol=1e-5)


def test_sparse_adaptive_step_keeps_the_reference_rejections():
    spec = models.FMSpec(num_features=16, rank=2, init_std=0.05)
    with pytest.raises(ValueError, match="handles"):
        optim.make_sparse_adaptive_step(spec, ptrain.TrainConfig())
    with pytest.raises(ValueError, match="reg_\\* triple"):
        optim.make_sparse_adaptive_step(
            spec, ptrain.TrainConfig(optimizer="ftrl", reg_factors=1e-4))
    with pytest.raises(ValueError, match="flat FM family only"):
        optim.make_sparse_adaptive_step(
            models.FFMSpec(num_features=16, rank=2, num_fields=2),
            ptrain.TrainConfig(optimizer="ftrl"))
    with pytest.raises(ValueError, match="TieredTrainer"):
        optim.make_sparse_adaptive_step(spec, ptrain.TrainConfig(
            optimizer="adagrad", embed_tier="require"))
    with pytest.raises(ValueError, match="unknown adaptive"):
        optim.init_adaptive_slots("sgd", spec, {})


def test_fmtorch_train_ftrl_stops_resumes_and_runs_config5(tmp_path,
                                                           capsys):
    """``fmtorch train --optimizer ftrl``: config 1 on a synthesized
    ratings file, stopped at step 4 and resumed to 8 from the chain, equal
    bit for bit to the uninterrupted run (FTRL's ``z``/``n`` ride the
    chain under ``opt/``); config 5 narrowed (``--bucket 16``) trains its
    dense head by FTRL, ``opt/z`` and ``opt/n`` in its checkpoint."""
    import json
    import os

    from fm_spark_tpu_torch import cli
    from fm_spark_tpu_torch.data import movielens

    path = str(tmp_path / "u.data")
    movielens.synthesize_ratings(path, 60, 90, 3000, seed=0)

    def train(ck, steps, out=None):
        argv = ["train", "--config", "movielens_fm_r8", "--data", path,
                "--optimizer", "ftrl", "--steps", str(steps),
                "--batch-size", "256", "--log-every", "1",
                "--checkpoint-dir", str(tmp_path / ck),
                "--checkpoint-every", "2", "--test-fraction", "0",
                "--device", "cpu"]
        assert cli.main(argv + (["--model-out", out] if out else [])) == 0
        return [json.loads(x) for x in capsys.readouterr().out.splitlines()]

    whole = train("a", 8, str(tmp_path / "ma"))
    train("b", 4)
    resumed = train("b", 8, str(tmp_path / "mb"))
    assert next(r for r in resumed if "resumed" in r)["resumed"]["step"] == 4
    loss = {r["step"]: r["loss"] for r in whole if "loss" in r}
    assert {r["step"]: r["loss"] for r in resumed if "loss" in r} == {
        s: loss[s] for s in range(5, 9)}
    a = models.load_model(str(tmp_path / "ma"), device="cpu")[1]
    b = models.load_model(str(tmp_path / "mb"), device="cpu")[1]
    for key in ("w0", "w", "v"):
        assert torch.equal(a[key], b[key]), key
    assert cli.main(["train", "--config", "criteo1tb_deepfm", "--bucket",
                     "16", "--synthetic", "600", "--steps", "2",
                     "--batch-size", "128", "--optimizer", "ftrl",
                     "--checkpoint-dir", str(tmp_path / "d"),
                     "--checkpoint-every", "1", "--test-fraction", "0",
                     "--device", "cpu"]) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert all(np.isfinite(r["loss"]) for r in out if "loss" in r)
    names = os.listdir(tmp_path / "d" / "2" / "opt")
    assert sorted(names) == ["n", "z"]
