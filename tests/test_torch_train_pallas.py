"""The port's ``use_pallas`` path and per-lane dedup forms of the fused
sparse-SGD steps (FieldFM and FieldFFM) against the JAX package's, which
runs its Pallas row kernels in interpret mode here.

Parameters are drawn by JAX and carried across by ``params_from_numpy``;
batches are numpy from a seed, with duplicate ids and zero-weight rows;
the SR bits of ``dedup_sr`` on bf16 tables are JAX's own, injected.
Tolerances are the reference's (``tests/test_sparse_pallas.py``): the
loss within ``rtol=1e-5`` and tables within ``rtol=1e-4, atol=1e-6`` in
float32; where bf16 is involved the bounds of the port's other step
tests: the loss within 1e-3 and tables within ``atol=1e-2`` (FieldFM) or
``rtol=3e-2, atol=3e-3`` (FieldFFM).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu import sparse as jsparse
from fm_spark_tpu import train as jtrain
from fm_spark_tpu.ops import scatter as jscatter
from fm_spark_tpu_torch import models, sparse
from fm_spark_tpu_torch.ops import ffm_sel, rows, scatter
from fm_spark_tpu_torch.train import TrainConfig, fit_field_sparse

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, BUCKET = 48, 3, 16
FM_K, FFM_K = 4, 3


def _fm_specs(pd, cd, **kw):
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET,
              rank=FM_K, param_dtype=pd, compute_dtype=cd, init_std=0.1,
              **kw)
    return jmodels.FieldFMSpec(**kw), models.FieldFMSpec(**kw)


def _ffm_specs(pd, cd):
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET,
              rank=FFM_K, param_dtype=pd, compute_dtype=cd, init_std=0.2)
    return jmodels.FieldFFMSpec(**kw), models.FieldFFMSpec(**kw)


def _params(jspec, pspec, seed=0):
    """JAX-initialised params with a random linear column, and the port's
    copy of them."""
    jp = jspec.init(jax.random.key(seed))
    rng = np.random.default_rng(seed)
    flat = {"w0": np.float32(0.1)}
    for f, t in enumerate(jp["vw"]):
        arr = np.array(t.astype(jnp.float32))
        arr[:, -1] = rng.normal(size=arr.shape[0]) * 0.2
        flat[f"vw/{f}"] = arr
    jp = {"w0": jnp.float32(0.1),
          "vw": [jnp.asarray(flat[f"vw/{f}"].copy()).astype(jspec.pdtype)
                 for f in range(F)]}
    return jp, models.params_from_numpy(pspec, flat, "cpu")


def _jax_noise(seed):
    base = jax.random.key(seed + 0x5EED)

    def noise(step, field, shape):
        bits = jax.random.bits(jscatter.sr_key(base, step, field), shape,
                               jnp.uint32) & jnp.uint32(0xFFFF)
        return torch.from_numpy(np.asarray(bits).astype(np.int32))

    return noise


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        # Heavy duplication within fields: the dedup the update kernel needs.
        ids = rng.integers(0, 8, (B, F)).astype(np.int32)
        vals = rng.normal(size=(B, F)).astype(np.float32)
        labels = rng.integers(0, 2, B).astype(np.float32)
        weights = (np.arange(B) % 3 != 1).astype(np.float32)   # zero rows
        out.append((ids, vals, labels, weights))
    return out


def _run(jbody, pbody, jp, pp, host, steps=2):
    """``steps`` steps of both bodies on the same batches; the losses."""
    losses = []
    for i, (ids, vals, labels, weights) in enumerate(_batches(steps)):
        aux = scatter.dedup_aux(ids) if host else None
        jp, jl = jbody(jp, jnp.int32(i), jnp.asarray(ids), jnp.asarray(vals),
                       jnp.asarray(labels), jnp.asarray(weights),
                       None if aux is None else tuple(map(jnp.asarray, aux)))
        pp, pl = pbody(pp, i, *(torch.from_numpy(a.copy()) for a in
                                (ids, vals, labels, weights)),
                       None if aux is None else
                       tuple(torch.from_numpy(a.copy()) for a in aux))
        losses.append((float(jl), float(pl)))
    return jp, pp, losses


def _check(jp, pp, losses, exact, bf16_tol):
    for jl, pl in losses:
        if exact:
            assert pl == pytest.approx(jl, rel=1e-5)
        else:
            assert abs(jl - pl) < 1e-3
    tol = dict(rtol=1e-4, atol=1e-6) if exact else bf16_tol
    for f in range(F):
        np.testing.assert_allclose(
            pp["vw"][f].float().numpy(),
            np.asarray(jp["vw"][f].astype(jnp.float32)), **tol,
            err_msg=f"field {f}")
    np.testing.assert_allclose(float(pp["w0"]), float(jp["w0"]), **tol)


# (sparse_update, use_pallas, host_dedup): the use_pallas forms, and the
# per-lane dedup forms by the device sort and by the host aux.
FORMS = ([(m, True, False) for m in ("scatter_add", "dedup", "dedup_sr")]
         + [(m, False, h) for m in ("dedup", "dedup_sr") for h in (False, True)])


def _cfg(mode, pallas, host, **kw):
    return dict(learning_rate=0.2, lr_schedule="inv_sqrt", reg_factors=1e-3,
                reg_linear=1e-4, reg_bias=1e-5, sparse_update=mode, seed=3,
                use_pallas=pallas, host_dedup=host, **kw)


@pytest.mark.parametrize("mode,pallas,host", FORMS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fm_steps_match_jax(mode, pallas, host, dtype):
    jspec, pspec = _fm_specs(dtype, dtype)
    cfg = _cfg(mode, pallas, host)
    jbody = jax.jit(jsparse.make_field_sparse_sgd_body(
        jspec, jtrain.TrainConfig(**cfg)))
    pbody = sparse.make_field_sparse_sgd_body(pspec, TrainConfig(**cfg),
                                              sr_noise=_jax_noise(3))
    jp, pp = _params(jspec, pspec)
    jp, pp, losses = _run(jbody, pbody, jp, pp, host)
    _check(jp, pp, losses, dtype == "float32", dict(rtol=0, atol=1e-2))
    assert pp["vw"][0].dtype == pspec.pdtype
    # The CPU runs the kernels' plain versions: no launch.
    assert rows.gather_launches == rows.update_launches == 0


FFM_FORMS = FORMS + [("scatter_add", True, False, "kernels"),
                     ("dedup_sr", True, False, "kernels")]


@pytest.mark.parametrize("form", FFM_FORMS,
                         ids=["-".join(map(str, f)) for f in FFM_FORMS])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_ffm_steps_match_jax(form, cd):
    mode, pallas, host = form[:3]
    lever = (dict(sel_blocked=True, fused_embed="require")
             if form[3:] == ("kernels",) else {})
    pd = "bfloat16" if mode == "dedup_sr" and cd == "bfloat16" else "float32"
    jspec, pspec = _ffm_specs(pd, cd)
    cfg = _cfg(mode, pallas, host, **lever)
    jbody = jax.jit(jsparse.make_field_ffm_sparse_sgd_body(
        jspec, jtrain.TrainConfig(**cfg)))
    pbody = sparse.make_field_ffm_sparse_sgd_body(pspec, TrainConfig(**cfg),
                                                  sr_noise=_jax_noise(3))
    jp, pp = _params(jspec, pspec, seed=1)
    jp, pp, losses = _run(jbody, pbody, jp, pp, host)
    _check(jp, pp, losses, pd == cd == "float32",
           dict(rtol=3e-2, atol=3e-3))
    assert rows.gather_launches == rows.update_launches == 0
    assert ffm_sel.scores_launches == ffm_sel.bwd_launches == 0


@pytest.mark.parametrize("ffm", [False, True], ids=["fm", "ffm"])
def test_multistep_equals_single_steps(ffm):
    _, pspec = (_ffm_specs if ffm else _fm_specs)("bfloat16", "bfloat16")
    cfg = TrainConfig(learning_rate=0.05, sparse_update="dedup_sr",
                      use_pallas=True)
    noise = _jax_noise(0)
    batches = _batches(3, seed=4)
    p1 = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    p2 = {"w0": p1["w0"].clone(), "vw": [t.clone() for t in p1["vw"]]}
    step = (sparse.make_field_ffm_sparse_sgd_body if ffm
            else sparse.make_field_sparse_sgd_body)(pspec, cfg, sr_noise=noise)
    for i, b in enumerate(batches):
        p1, l1 = step(p1, 5 + i, *map(torch.from_numpy, b))
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*batches)]
    mstep = sparse.make_field_sparse_multistep(pspec, cfg, 4, sr_noise=noise)
    p2, l2 = mstep(p2, 5, 3, *stacked)
    assert float(l1) == float(l2)
    assert all(torch.equal(a, b) for a, b in zip(p1["vw"], p2["vw"]))
    assert torch.equal(p1["w0"], p2["w0"])


@pytest.mark.parametrize("cfg,spec_kw", [
    (dict(use_pallas=True), dict(fused_linear=False)),
    (dict(use_pallas=True), dict(table_layout="col")),
    (dict(use_pallas=True, sparse_update="dedup", host_dedup=True), {}),
    (dict(use_pallas=True, sparse_update="dedup_sr", host_dedup=True,
          compact_cap=8), {}),
    (dict(sparse_update="dedup"), dict(fused_linear=False)),
])
def test_fm_guards_raise_the_reference_messages(cfg, spec_kw):
    jspec, pspec = _fm_specs("float32", "float32", **spec_kw)
    with pytest.raises(ValueError) as want:
        jsparse.make_field_sparse_sgd_body(jspec, jtrain.TrainConfig(**cfg))
    with pytest.raises(ValueError) as got:
        sparse.make_field_sparse_sgd_body(pspec, TrainConfig(**cfg))
    assert str(got.value) == str(want.value)


def test_ffm_guard_use_pallas_with_host_dedup():
    jspec, pspec = _ffm_specs("float32", "float32")
    cfg = dict(use_pallas=True, sparse_update="dedup", host_dedup=True)
    with pytest.raises(ValueError) as want:
        jsparse.make_field_ffm_sparse_sgd_body(jspec,
                                               jtrain.TrainConfig(**cfg))
    with pytest.raises(ValueError) as got:
        sparse.make_field_ffm_sparse_sgd_body(pspec, TrainConfig(**cfg))
    assert str(got.value) == str(want.value)


def test_fit_trains_with_the_per_lane_host_aux():
    from fm_spark_tpu_torch import data

    _, pspec = _fm_specs("float32", "float32")
    ids, vals, labels = data.synthetic_ctr(600, F * BUCKET, F, seed=0)
    ids = data.field_local(ids, BUCKET)
    cfg = TrainConfig(num_steps=4, learning_rate=0.2, lr_schedule="constant",
                      sparse_update="dedup", host_dedup=True)
    stats = {}
    params = fit_field_sparse(pspec, cfg, data.Batches(ids, vals, labels, 64),
                              device="cpu", stats=stats)
    assert len(stats["aux_ms"]) >= 4 and np.isfinite(stats["loss"]).all()
    # The device sort in place of the host aux: the same ints, so the
    # same segments and sums.
    again = fit_field_sparse(
        pspec, TrainConfig(**{**cfg.__dict__, "host_dedup": False}),
        data.Batches(ids, vals, labels, 64), device="cpu")
    for a, b in zip(params["vw"], again["vw"]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _cli(*args):
    # One intra-op thread: the tiny steps spend most of their time in
    # thread hand-offs otherwise, on a shared host.
    return subprocess.run([sys.executable, "-m", "fm_spark_tpu_torch", *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600, env={**os.environ,
                                            "OMP_NUM_THREADS": "1"})


@pytest.mark.parametrize("config,extra", [
    ("criteo1tb_fm_r64", ()),
    ("avazu_ffm_r16", ("--sel-blocked", "--fused-embed", "require")),
], ids=["fm", "ffm"])
def test_cli_trains_with_use_pallas_and_jax_loads_the_model(tmp_path, config,
                                                            extra):
    out = tmp_path / "model"
    proc = _cli("train", "--config", config, "--bucket", "64", "--synthetic",
                "2000", "--steps", "3", "--batch-size", "256", "--use-pallas",
                *extra, "--device", "cpu", "--model-out", str(out))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    assert [x["step"] for x in lines[:3]] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in lines[:3])
    launched = json.loads(proc.stderr.strip().splitlines()[-1])
    assert launched["kernel_launches"]["gather_rows"] == 0  # the CPU: plain
    assert launched["kernel_launches"]["update_rows_add"] == 0
    proc = _cli("eval", "--model", str(out), "--synthetic", "300",
                "--batch-size", "128", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["count"] == 300.0 and np.isfinite(metrics["logloss"])
    spec, params = models.load_model(str(out), device="cpu")
    jspec, jp = jmodels.load_model(str(out))
    assert jspec.num_fields == spec.num_fields and jspec.rank == spec.rank
    for f in range(spec.num_fields):
        np.testing.assert_array_equal(np.asarray(jp["vw"][f], np.float32),
                                      params["vw"][f].float().numpy())


def test_cli_refuses_use_pallas_with_host_dedup():
    proc = _cli("train", "--config", "criteo1tb_fm_r64", "--bucket", "64",
                "--synthetic", "100", "--steps", "1", "--use-pallas",
                "--host-dedup", "--sparse-update", "dedup", "--device", "cpu")
    assert proc.returncode != 0
    assert ("host_dedup/compact_device and use_pallas are exclusive"
            in proc.stderr)
