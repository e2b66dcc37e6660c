"""The captured training step's CPU side: what makes the port's fused
steps capturable as CUDA graphs, held against the JAX package.

- The learning rate on the device (``train._lr_at_tensor``) equals the
  reference's float32 schedule bit for bit.
- With no SR bits injected, the bf16 ``dedup_sr`` steps (FieldFM compact
  and per-lane, FieldFFM compact and per-lane) equal JAX's jitted steps
  bit for bit in the tables, and in the loss with bf16 compute: the port
  draws JAX's threefry key schedule. JAX's steps are compiled with
  ``xla_allow_excess_precision`` off, so XLA rounds every bf16 operation
  as the program writes it (on the CPU it may otherwise keep fp32
  between fused bf16 operations). A float32 sum over the batch adds in
  another order on each side: the loss with float32 compute is held
  within 2e-7, and ``w0`` at ``rtol=1e-6, atol=1e-8``.
- A roll of n = 4 steps over 7 steps (a full call and a tail of 3)
  equals 7 single steps bit for bit.
- Every capturable form runs under :class:`NoHostSync`, a dispatch mode
  that fails on what a graph cannot capture: a read of a device value on
  the host (``_local_scalar_dense``, ``equal``, ``is_nonzero``), a shape
  that depends on the data (``nonzero``, ``masked_select``, the unique
  ops, boolean-mask indexing) and a copy from the host (a tensor made
  from host data, a copy between devices). It is the CPU's proxy for
  "captures on the card"; the capture itself is held on the card
  (``tests/test_torch_package.py``, ``chip_smoke.py`` phase 13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fm_spark_tpu import models as jmodels
from fm_spark_tpu import sparse as jsparse
from fm_spark_tpu import train as jtrain
from fm_spark_tpu_torch import models, sparse
from fm_spark_tpu_torch.ops import scatter
from fm_spark_tpu_torch.train import TrainConfig, _lr_at, _lr_at_tensor

B, F, BUCKET, CAP = 48, 4, 24, 24
FM_K, FFM_K = 4, 3
aten = torch.ops.aten


class NoHostSync(TorchDispatchMode):
    """Raises on every operation that a CUDA graph cannot capture."""

    BANNED = {aten._local_scalar_dense.default, aten.item.default,
              aten.equal.default, aten.is_nonzero.default,
              aten.nonzero.default, aten.masked_select.default,
              aten._unique.default, aten._unique2.default,
              aten.unique_dim.default, aten.unique_consecutive.default,
              aten.repeat_interleave.Tensor, aten.lift_fresh.default}
    INDEXING = {aten.index.Tensor, aten.index_put.default,
                aten.index_put_.default, aten._index_put_impl_.default}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in self.BANNED:
            raise AssertionError(f"{func} cannot be captured")
        if func in self.INDEXING and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] if i is not None):
            raise AssertionError(f"{func} with a boolean mask: its shape "
                                 "depends on the data")
        if func is aten._to_copy.default and "device" in kwargs:
            if torch.device(kwargs["device"]) != args[0].device:
                raise AssertionError("a copy between devices")
        if func is aten.copy_.default and args[0].device != args[1].device:
            raise AssertionError("a copy between devices")
        return func(*args, **kwargs)


@pytest.mark.parametrize("bad", [
    lambda x: x.sum().item(), lambda x: x[x > 0], lambda x: x.nonzero(),
    lambda x: torch.unique(x), lambda x: x[torch.tensor(1)],
    lambda x: torch.tensor([1.0, 2.0]), lambda x: x.masked_select(x > 0),
    lambda x: bool(x.sum() > 0), lambda x: torch.equal(x, x),
    lambda x: x.to("meta"),
], ids=["item", "mask-index", "nonzero", "unique", "scalar-tensor-index",
        "from-host", "masked_select", "bool", "equal", "device-copy"])
def test_the_guard_catches_what_a_graph_cannot_capture(bad):
    x = torch.arange(6.0)
    with pytest.raises(AssertionError), NoHostSync():
        bad(x)


@pytest.mark.parametrize("schedule", ["inv_sqrt", "constant"])
@pytest.mark.parametrize("lr", [0.05, 0.1, 0.3, 1e-3])
def test_lr_on_the_device_equals_the_reference_schedule(schedule, lr):
    cfg = TrainConfig(learning_rate=lr, lr_schedule=schedule)
    rng = np.random.default_rng(0)
    steps = np.unique(np.concatenate([
        np.arange(4096), rng.integers(0, 10**7, 4096),
        [10**7, 2**24 - 1, 2**24, 2**24 + 1]])).astype(np.int32)
    want = np.array([_lr_at(cfg)(int(i)) for i in steps], np.float32)
    got = _lr_at_tensor(cfg)(torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))
    one = _lr_at_tensor(cfg)(torch.tensor(266, dtype=torch.int32))
    assert one.shape == () and float(one) == _lr_at(cfg)(266)


# ------------------------------------------------ JAX parity, no injection


def _jit_exact(fn):
    """JAX's jitted ``fn`` with every bf16 operation rounded as written."""
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False}))
        return compiled[0](*args)

    return call


def _specs(family, pd="bfloat16", cd="bfloat16"):
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET,
              param_dtype=pd, compute_dtype=cd, init_std=0.1)
    if family == "ffm":
        return (jmodels.FieldFFMSpec(rank=FFM_K, **kw),
                models.FieldFFMSpec(rank=FFM_K, **kw))
    # FieldFM's two other forms: the transposed tables, the unfused linear.
    kw.update({"fm-col": dict(table_layout="col"),
               "fm-unfused": dict(fused_linear=False)}.get(family, {}))
    return (jmodels.FieldFMSpec(rank=FM_K, **kw),
            models.FieldFMSpec(rank=FM_K, **kw))


def _carry(pspec, jp):
    flat = {"w0": np.asarray(jp["w0"])}
    flat.update({f"vw/{f}": np.asarray(t.astype(jnp.float32))
                 for f, t in enumerate(jp["vw"])})
    return models.params_from_numpy(pspec, flat, "cpu")


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = (rng.zipf(1.3, (B, F)) % BUCKET).astype(np.int32)
        vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
        labels = rng.integers(0, 2, B).astype(np.float32)
        weights = np.ones(B, np.float32)
        weights[-5:] = 0.0                      # padded tail lanes
        out.append((ids, vals, labels, weights))
    return out


def _aux(cfg, ids):
    if not cfg.get("host_dedup"):
        return None
    return (scatter.compact_aux(ids, CAP) if cfg.get("compact_cap")
            else scatter.dedup_aux(ids))


COMPACT = dict(host_dedup=True, compact_cap=CAP)
PARITY = {
    "fm-compact": ("fm", COMPACT),
    "fm-compact-gfull-segtotal": ("fm", dict(**COMPACT, gfull_fused=True,
                                             segtotal_pallas=True)),
    "fm-compact-fusedbwd": ("fm", dict(**COMPACT, fused_embed="require")),
    "fm-lane-device-sort": ("fm", {}),
    "fm-lane-host-aux": ("fm", dict(host_dedup=True)),
    "fm-lane-pallas-gather": ("fm", dict(use_pallas=True)),
    "ffm-compact": ("ffm", COMPACT),
    "ffm-compact-selblk": ("ffm", dict(**COMPACT, sel_blocked=True)),
    "ffm-lane-device-sort": ("ffm", {}),
}


@pytest.mark.parametrize("cd", ["bfloat16", "float32"])
@pytest.mark.parametrize("form", list(PARITY))
def test_bf16_dedup_sr_steps_equal_jax_without_injected_bits(form, cd):
    family, lever = PARITY[form]
    jspec, pspec = _specs(family, "bfloat16", cd)
    cfg = dict(learning_rate=0.05, reg_factors=1e-4, reg_linear=1e-5,
               reg_bias=1e-6, sparse_update="dedup_sr", seed=3, **lever)
    jmake, pmake = ((jsparse.make_field_ffm_sparse_sgd_body,
                     sparse.make_field_ffm_sparse_sgd_body) if family == "ffm"
                    else (jsparse.make_field_sparse_sgd_body,
                          sparse.make_field_sparse_sgd_body))
    jstep = _jit_exact(jmake(jspec, jtrain.TrainConfig(**cfg)))
    pstep = pmake(pspec, TrainConfig(**cfg))
    jp = jspec.init(jax.random.key(0))
    pp = _carry(pspec, jp)
    for i, batch in enumerate(_batches(3)):
        aux = _aux(cfg, batch[0])
        jp, jl = jstep(jp, jnp.int32(i), *map(jnp.asarray, batch),
                       None if aux is None else tuple(map(jnp.asarray, aux)))
        pp, pl = pstep(pp, i, *map(torch.from_numpy, batch),
                       None if aux is None else
                       tuple(map(torch.from_numpy, aux)))
        if cd == "bfloat16":
            assert float(pl) == float(jl)
        else:
            # The mean of float32 losses: a sum over the batch in another
            # order on each side.
            assert abs(float(pl) - float(jl)) <= 2e-7
        for f in range(F):
            got = pp["vw"][f].float().numpy().view(np.int32)
            want = np.asarray(jp["vw"][f], np.float32).view(np.int32)
            np.testing.assert_array_equal(got, want)
        np.testing.assert_allclose(float(pp["w0"]), float(jp["w0"]),
                                   rtol=1e-6, atol=1e-8)


# ------------------------------------------------------------ the roll


@pytest.mark.parametrize("family,lever", [
    ("fm", dict(**COMPACT, fused_embed="require")),
    ("fm", dict(compact_device=True, compact_cap=CAP)),
    ("ffm", dict(**COMPACT, sel_blocked=True))])
def test_roll_of_four_over_seven_steps_equals_seven_steps(family, lever):
    _, pspec = _specs(family)
    cfg = TrainConfig(learning_rate=0.05, sparse_update="dedup_sr", seed=2,
                      **lever)
    batches = _batches(7, seed=4)
    body = (sparse.make_field_ffm_sparse_sgd_body if family == "ffm"
            else sparse.make_field_sparse_sgd_body)(pspec, cfg)
    p1 = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    p2 = {"w0": p1["w0"].clone(), "vw": [t.clone() for t in p1["vw"]]}
    losses = []
    for i, b in enumerate(batches):
        aux = _aux(lever, b[0])
        p1, loss = body(p1, 5 + i, *map(torch.from_numpy, b),
                        None if aux is None else
                        tuple(map(torch.from_numpy, aux)))
        losses.append(float(loss))
    mstep = sparse.make_field_sparse_multistep(pspec, cfg, 4)
    got = []
    for lo, hi in ((0, 4), (4, 7)):
        group = batches[lo:hi]
        stacked = [torch.from_numpy(np.stack(a)) for a in zip(*group)]
        aux = None
        if lever.get("host_dedup"):
            aux = tuple(torch.from_numpy(np.stack(a)) for a in
                        zip(*[_aux(lever, g[0]) for g in group]))
        p2, loss = mstep(p2, 5 + lo, hi - lo, *stacked, aux)
        got.append(float(loss))
    assert got == [losses[3], losses[6]]
    assert torch.equal(p1["w0"], p2["w0"])
    assert all(torch.equal(a, c) for a, c in zip(p1["vw"], p2["vw"]))


def test_roll_refuses_a_count_past_its_length():
    _, pspec = _specs("fm")
    mstep = sparse.make_field_sparse_multistep(pspec, TrainConfig(), 2)
    params = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*_batches(2))]
    with pytest.raises(ValueError, match="m must be in"):
        mstep(params, 0, 3, *stacked)


# ------------------------------------------------- the capturable forms


CAPTURABLE = {
    "fm-compact-segtotal": ("fm", "dedup_sr", dict(**COMPACT, gfull_fused=True,
                                                   segtotal_pallas=True)),
    "fm-compact-fusedbwd": ("fm", "dedup_sr", dict(**COMPACT,
                                                   fused_embed="require")),
    "fm-devaux-error": ("fm", "dedup_sr", dict(
        compact_device=True, compact_cap=8, gfull_fused=True,
        segtotal_pallas=True)),
    "fm-devaux-drop": ("fm", "dedup", dict(
        compact_device=True, compact_cap=8, compact_overflow="drop",
        fused_embed="require")),
    "fm-lane-sr": ("fm", "dedup_sr", {}),
    "fm-lane-host-aux": ("fm", "dedup_sr", dict(host_dedup=True)),
    "fm-scatter-add": ("fm", "scatter_add", {}),
    "fm-pallas": ("fm", "scatter_add", dict(use_pallas=True)),
    "fm-pallas-dedup": ("fm", "dedup", dict(use_pallas=True)),
    "ffm-selblk-pallas-rows": ("ffm", "scatter_add", dict(
        use_pallas=True, sel_blocked=True, fused_embed="require")),
    "ffm-compact-sr": ("ffm", "dedup_sr", COMPACT),
    "ffm-devaux": ("ffm", "dedup_sr", dict(compact_device=True,
                                           compact_cap=8, sel_blocked=True)),
    "ffm-sel": ("ffm", "scatter_add", {}),
    "fm-col-compact-segtotal": ("fm-col", "dedup_sr", dict(
        **COMPACT, gfull_fused=True, segtotal_pallas=True)),
    "fm-col-devaux-drop": ("fm-col", "dedup", dict(
        compact_device=True, compact_cap=8, compact_overflow="drop")),
    "fm-unfused-scatter-add": ("fm-unfused", "scatter_add", {}),
}


@pytest.mark.parametrize("form", list(CAPTURABLE))
def test_capturable_forms_make_no_host_sync(form):
    """The body and the roll as a graph runs them (the step a 0-dim int32
    tensor, the SR bits from the schedule) under the guard; the roll's
    second call gives the loss a −inf first step would leave."""
    family, mode, lever = CAPTURABLE[form]
    _, pspec = _specs(family, "bfloat16", "bfloat16")
    cfg = TrainConfig(learning_rate=0.05, reg_factors=1e-4, reg_bias=1e-6,
                      sparse_update=mode, **lever)
    body = (sparse.make_field_ffm_sparse_sgd_body if family == "ffm"
            else sparse.make_field_sparse_sgd_body)(pspec, cfg)
    params = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    batches = _batches(2, seed=6)
    auxes = [_aux(lever, b[0]) for b in batches]
    step = torch.tensor(3, dtype=torch.int32)
    batch = [torch.from_numpy(a) for a in batches[0]]
    aux = None if auxes[0] is None else tuple(map(torch.from_numpy, auxes[0]))
    with NoHostSync():
        params, loss = body(params, step, *batch, aux)
    assert loss.shape == ()
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*batches)]
    aux = None if auxes[0] is None else tuple(
        torch.from_numpy(np.stack(a)) for a in zip(*auxes))
    with NoHostSync():
        loss = sparse._roll(body, params, step, 2, *stacked, aux)
    assert loss.shape == ()


@pytest.mark.parametrize("pd,sched", [("float32", "inv_sqrt"),
                                      ("bfloat16", "constant")])
@pytest.mark.parametrize("form", ["dense", "flat-sparse"])
def test_flat_fm_steps_make_no_host_sync(form, pd, sched):
    """The flat FM's dense optax step (``train.make_train_step``'s body,
    the schedule's count on the device) and its sparse step (the step a
    0-dim int32 tensor), as their graphs run them, with ids out of range
    and zero weights."""
    from fm_spark_tpu_torch import train

    spec = models.FMSpec(num_features=40, rank=4, param_dtype=pd,
                         compute_dtype=pd, init_std=0.1)
    cfg = TrainConfig(learning_rate=0.05, lr_schedule=sched, reg_bias=1e-3,
                      reg_linear=1e-2, reg_factors=1e-2)
    params = spec.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(-45, 45, (B, 3)).astype(np.int32)
    batch = [torch.from_numpy(a) for a in (
        ids, rng.random((B, 3)).astype(np.float32),
        rng.integers(0, 2, B).astype(np.float32),
        (rng.random(B) > 0.2).astype(np.float32))]
    if form == "dense":
        opt = train.make_optimizer(cfg)
        state = opt.init(params)
        body = train.make_train_step(spec, cfg, opt).body
        with NoHostSync():
            loss, norm = body(params, state, *batch)
    else:
        body = sparse.make_sparse_sgd_step(spec, cfg).body
        step = torch.tensor(3, dtype=torch.int32)
        with NoHostSync():
            _, loss = body(params, step, *batch)
    assert loss.shape == () and bool(torch.isfinite(loss))


@pytest.mark.parametrize("form", ["sparse-ftrl", "sparse-adagrad",
                                  "dense-ftrl", "dense-ffm", "dense-deepfm"])
def test_adaptive_and_flat_family_steps_make_no_host_sync(form):
    """The sparse adaptive step (FTRL and AdaGrad, the one set per
    distinct id), the dense step with FTRL, and the dense steps of the
    flat FFM and DeepFM, as their graphs run them, with ids out of range
    and zero weights."""
    from fm_spark_tpu_torch import optim, train

    kw = dict(num_features=40, rank=4, init_std=0.1)
    if form == "dense-ffm":
        spec = models.FFMSpec(num_fields=3, **kw)
    elif form == "dense-deepfm":
        spec = models.DeepFMSpec(num_fields=3, mlp_dims=(8, 8), **kw)
    else:
        spec = models.FMSpec(**kw)
    params = spec.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(2)
    ids = rng.integers(-45, 45, (B, 3)).astype(np.int32)
    batch = [torch.from_numpy(a) for a in (
        ids, rng.random((B, 3)).astype(np.float32),
        rng.integers(0, 2, B).astype(np.float32),
        (rng.random(B) > 0.2).astype(np.float32))]
    if form.startswith("sparse"):
        name = form.split("-")[1]
        cfg = TrainConfig(learning_rate=0.05, optimizer=name)
        slots = optim.init_adaptive_slots(name, spec, params)
        body = optim.make_sparse_adaptive_step(spec, cfg, l1=1e-3).body
        with NoHostSync():
            _, _, loss = body(params, slots, *batch)
    else:
        cfg = TrainConfig(learning_rate=0.05, reg_bias=1e-3, reg_linear=1e-2,
                          reg_factors=1e-2,
                          optimizer="ftrl" if form == "dense-ftrl" else "adam")
        opt = train.make_optimizer(cfg)
        state = opt.init(params)
        body = train.make_train_step(spec, cfg, opt).body
        with NoHostSync():
            loss, norm = body(params, state, *batch)
    assert loss.shape == () and bool(torch.isfinite(loss))


# --------------------------------------------------- the entry points


def test_captured_entry_points_run_the_body_on_the_cpu():
    jspec, pspec = _specs("fm")
    cfg = TrainConfig(learning_rate=0.05, sparse_update="dedup_sr", **COMPACT)
    body = sparse.make_field_sparse_sgd_body(pspec, cfg)
    step = sparse.make_field_sparse_sgd_step(pspec, cfg)
    p1 = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    p2 = {"w0": p1["w0"].clone(), "vw": [t.clone() for t in p1["vw"]]}
    for i, b in enumerate(_batches(2)):
        aux = tuple(map(torch.from_numpy, _aux(COMPACT, b[0])))
        p1, l1 = body(p1, i, *map(torch.from_numpy, b), aux)
        p2, l2 = step(p2, i, *map(torch.from_numpy, b), aux)
        assert float(l1) == float(l2)
    assert all(torch.equal(a, c) for a, c in zip(p1["vw"], p2["vw"]))
    assert step.captured.capture_s == []        # nothing captured here
    with pytest.raises(ValueError, match="expected a FieldFFMSpec"):
        sparse.make_field_ffm_sparse_sgd_step(pspec, cfg)
    with pytest.raises(ValueError, match="expected a FieldFMSpec"):
        sparse.make_field_sparse_sgd_step(_specs("ffm")[1], cfg)


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_precompile_returns_the_step_without_stepping_the_params(
        steps_per_call):
    _, pspec = _specs("ffm")
    cfg = TrainConfig(learning_rate=0.05, sparse_update="dedup_sr",
                      sel_blocked=True, **COMPACT)
    params = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    before = [t.clone() for t in params["vw"]]
    step = sparse.precompile_field_sparse_step(pspec, cfg, B, steps_per_call,
                                               params=params)
    assert all(torch.equal(a, c) for a, c in zip(before, params["vw"]))
    b = _batches(1)[0]
    aux = tuple(map(torch.from_numpy, _aux(COMPACT, b[0])))
    args = [torch.from_numpy(a) for a in b]
    if steps_per_call == 1:
        _, loss = step(params, 0, *args, aux)
    else:
        _, loss = step(params, 0, 1, *(a[None] for a in args),
                       tuple(a[None] for a in aux))
    assert np.isfinite(float(loss))


def test_every_kernel_counter_is_known_to_the_graphs():
    from fm_spark_tpu_torch import ops

    counts = ops.kernel_launches()
    assert len(counts) == len(ops.KERNEL_COUNTERS) == 8
    assert all(isinstance(n, int) for n in counts.values())


# -------------------------------------------------- serving's predict


def _serving_case(family, cd, num_fields=F):
    kw = dict(num_features=num_fields * BUCKET, num_fields=num_fields,
              bucket=BUCKET, param_dtype=cd, compute_dtype=cd, init_std=0.1)
    spec = {"fm": lambda: models.FieldFMSpec(rank=FM_K, **kw),
            "fm-col": lambda: models.FieldFMSpec(rank=FM_K, table_layout="col",
                                                 **kw),
            "fm-unfused": lambda: models.FieldFMSpec(rank=FM_K,
                                                     fused_linear=False, **kw),
            "ffm": lambda: models.FieldFFMSpec(rank=FFM_K, **kw),
            "deepfm": lambda: models.FieldDeepFMSpec(
                rank=FM_K, mlp_dims=(16, 16, 16), **kw)}[family]()
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, BUCKET, (64, num_fields))
                           .astype(np.int32))
    vals = torch.from_numpy(rng.random((64, num_fields)).astype(np.float32))
    return spec, params, ids, vals


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["fm", "ffm", "deepfm", "fm-col",
                                    "fm-unfused"])
def test_every_served_predict_is_capturable(family, cd):
    """What the engine captures per bucket on the card: ``spec.predict``
    (and FieldFFM's kernel form, which the card's ``scores`` takes) runs
    under the guard and gives the same predictions as outside it."""
    spec, params, ids, vals = _serving_case(family, cd)
    want = spec.predict(params, ids, vals)
    with NoHostSync():
        got = spec.predict(params, ids, vals).float()
        if family == "ffm":
            spec._scores_sel(params, ids, vals)
    assert torch.equal(got, want.float())


@pytest.mark.parametrize("family", ["fm", "ffm", "deepfm"])
def test_the_planes_around_a_replay_make_no_host_sync(family, tmp_path):
    """What the obs and fault planes put around a served replay and a
    captured training step: the ``serve/batch`` span and the
    ``serve_request`` phase around ``spec.predict``, the ``train_step``
    fault point under an active plan inside the ``step_window`` phase, the
    window's retroactive span and the capture engine's step boundary; with
    the plane configured and a watchdog armed, they read the host clock
    only and the predictions are unchanged."""
    from fm_spark_tpu_torch import obs
    from fm_spark_tpu_torch.obs import introspect
    from fm_spark_tpu_torch.resilience import faults, watchdog

    spec, params, ids, vals = _serving_case(family, "float32")
    want = spec.predict(params, ids, vals)
    obs.configure(str(tmp_path / "run"))
    introspect.configure(obs.run_dir(), profile=False)
    faults.activate("train_step@99=error")
    watchdog.configure({"serve_request": 60.0, "step_window": 60.0},
                       action="raise")
    try:
        with NoHostSync():
            with obs.span("serve/batch", rows=64, bucket=64, gen_step=0), \
                    watchdog.phase("serve_request"):
                got = spec.predict(params, ids, vals)
            with watchdog.phase("step_window"):
                faults.inject("train_step")
                got2 = spec.predict(params, ids, vals)
            obs.emit_span("train/steps", 0.0, 1e-3, steps=1)
            introspect.observe_step_time(1.0)
            introspect.tick()
    finally:
        watchdog.clear()
        faults.clear()
        obs.shutdown()
    assert torch.equal(got, want) and torch.equal(got2, want)


def test_a_capture_of_more_than_64_fields_refuses_with_its_reason(
        monkeypatch):
    """F = 65: the forward kernel takes its table pointers from a device
    array, staged once per set of table addresses by a call outside the
    capture (the engine's warm-up call before each bucket's capture). A
    capture that finds them staged records no copy from the host and
    scores as the plain version; one that finds them unstaged refuses with
    its reason. On the CPU the plain version scores under the guard (the
    capture itself is held on the card, ``tests/test_torch_package.py``)."""
    from fm_spark_tpu_torch.ops import KernelUnavailable, fused_fwd

    spec, params, ids, vals = _serving_case("fm", "float32", num_fields=65)
    assert fused_fwd.PARAM_FIELDS == 64
    want = spec.predict(params, ids, vals)
    monkeypatch.setattr(fused_fwd, "_capturing", lambda: True)
    with pytest.raises(KernelUnavailable, match="65 fields > 64 tables are "
                       "not staged"):
        fused_fwd.stage_table_pointers(params["vw"])
    monkeypatch.setattr(fused_fwd, "_capturing", lambda: False)
    staged = fused_fwd.stage_table_pointers(params["vw"])
    assert staged.tolist() == [t.data_ptr() for t in params["vw"]]
    monkeypatch.setattr(fused_fwd, "_capturing", lambda: True)
    with NoHostSync():
        assert fused_fwd.stage_table_pointers(params["vw"]) is staged
        got = spec.predict(params, ids, vals)
    assert torch.equal(got, want)
    small = _serving_case("fm", "float32", num_fields=64)
    small[0].predict(*small[1:])          # 64 fields pass in the parameters


# ------------------------------------ the sharded and field dense steps


@pytest.fixture(scope="module")
def gloo_world_1():
    """A gloo process group of one rank in this process (the sharded
    steps' collectives run through it, as they would on one card)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    yield
    dist.destroy_process_group()


SHARDED = {
    "sharded-fm-lane": ("fm", dict(sparse_update="dedup_sr")),
    "sharded-fm-device-compact": ("fm", dict(
        sparse_update="dedup_sr", compact_device=True, compact_cap=CAP,
        segtotal_pallas=True, gfull_fused=True)),
    "sharded-fm-score-sharded-bf16-wire": ("fm", dict(
        sparse_update="dedup", score_sharded=True,
        collective_dtype="bfloat16")),
    "sharded-ffm": ("ffm", dict(sparse_update="dedup", compact_device=True,
                                compact_cap=CAP)),
    "sharded-deepfm": ("deepfm", dict(sparse_update="dedup",
                                      optimizer="adam")),
    "sharded-deepfm-deep-sharded": ("deepfm", dict(
        sparse_update="dedup", optimizer="adam", deep_sharded=True,
        compact_device=True, compact_cap=CAP)),
}


@pytest.mark.parametrize("form", list(SHARDED))
def test_sharded_steps_make_no_host_sync(gloo_world_1, form):
    """The field-sharded bodies (FieldFM in three forms, FieldFFM,
    FieldDeepFM with each head) eager at world 1 under gloo, with their
    collectives, as their graphs run them (the step a 0-dim int32
    tensor; bf16 tables and compute)."""
    from fm_spark_tpu_torch import parallel
    from fm_spark_tpu_torch.parallel import deepfm_step

    family, lever = SHARDED[form]
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET,
              param_dtype="bfloat16", compute_dtype="bfloat16",
              init_std=0.1)
    if family == "deepfm":
        spec = models.FieldDeepFMSpec(rank=FM_K, mlp_dims=(8, 8), **kw)
    else:
        spec = _specs(family)[1]
    cfg = TrainConfig(learning_rate=0.05, reg_factors=1e-4, **lever)
    mesh = parallel.make_field_mesh(device="cpu")
    canonical = spec.init(torch.Generator().manual_seed(1), device="cpu")
    step_t = torch.tensor(2, dtype=torch.int32)
    batch = [torch.from_numpy(a) for a in _batches(1)[0]]
    if family == "deepfm":
        params = deepfm_step.shard_field_deepfm_params(
            deepfm_step.stack_field_deepfm_params(spec, canonical, 1), mesh)
        body, init_opt = deepfm_step.make_field_deepfm_sharded_body(
            spec, cfg, mesh)
        opt = init_opt(params)
        with NoHostSync():
            _, _, loss = body(params, opt, step_t, *batch)
    else:
        params = parallel.shard_field_params(
            parallel.stack_field_params(spec, canonical, 1), mesh)
        make = (parallel.make_field_ffm_sharded_body if family == "ffm"
                else parallel.make_field_sharded_sgd_body)
        with NoHostSync():
            _, loss = make(spec, cfg, mesh)(params, step_t, *batch)
    assert loss.shape == () and bool(torch.isfinite(loss))


@pytest.mark.parametrize("form", ["field-dense-fm", "field-dense-ffm",
                                  "field-dense-deepfm", "dp", "row"])
def test_field_dense_and_parallel_steps_make_no_host_sync(gloo_world_1,
                                                          form):
    """The field families' generic dense step (``train.make_train_step``
    of a FieldFM, FieldFFM, FieldDeepFM) and the dense parallel steps
    (``dp`` of a FieldFM, ``row`` of the flat FM) at world 1 under gloo,
    as their graphs run them."""
    from fm_spark_tpu_torch import parallel, train

    cfg = TrainConfig(learning_rate=0.05, optimizer="adam", reg_bias=1e-3,
                      reg_factors=1e-2)
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET,
              init_std=0.1)
    if form == "row":
        spec = models.FMSpec(num_features=40, rank=4, init_std=0.1)
    elif form == "field-dense-ffm":
        spec = models.FieldFFMSpec(rank=FFM_K, **kw)
    elif form == "field-dense-deepfm":
        spec = models.FieldDeepFMSpec(rank=FM_K, mlp_dims=(8, 8), **kw)
    else:
        spec = models.FieldFMSpec(rank=FM_K, **kw)
    params = spec.init(torch.Generator().manual_seed(1), device="cpu")
    batch = [torch.from_numpy(a) for a in _batches(1)[0]]
    if form == "row":
        batch[0] = batch[0] * 2 - 3              # ids out of range too
    opt = train.make_optimizer(cfg)
    if form in ("dp", "row"):
        mesh = parallel.make_mesh(1, 1, device="cpu")
        params = parallel.shard_params(params, mesh, spec, form)
        body = parallel.make_parallel_train_step(spec, cfg, mesh, form,
                                                 opt).body
    else:
        body = train.make_train_step(spec, cfg, opt).body
    state = opt.init(params)
    with NoHostSync():
        loss, norm = body(params, state, *batch)
    assert loss.shape == () and bool(torch.isfinite(loss))
