"""The port's FieldFFM training against the JAX package: the fused
sparse-SGD step in every ported form, its guards and lever plan, the
multistep loop, the training loop and the CLI.

Parameters are drawn by JAX and carried across by ``params_from_numpy``;
batches are numpy from a seed; the SR bits of ``dedup_sr`` on bf16 tables
are JAX's own, injected. Tolerances are the reference's
(``tests/test_sel_blocked.py``): parameters within ``rtol=2e-5,
atol=2e-6`` and the loss within 1e-6 in float32 storage and compute;
``rtol=3e-2, atol=3e-3`` and 1e-3 where bf16 is involved.
"""

import dataclasses
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
from fm_spark_tpu.ops import PallasUnavailable
from fm_spark_tpu.ops import scatter as jscatter
from fm_spark_tpu_torch import configs, data, models, sparse
from fm_spark_tpu_torch.ops import KernelUnavailable, ffm_sel, scatter
from fm_spark_tpu_torch.train import (TrainConfig, evaluate_params,
                                      fit_field_sparse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, K, BUCKET, CAP = 128, 4, 4, 32, 32


def _specs(pd="float32", cd="float32", **kw):
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET, rank=K,
              param_dtype=pd, compute_dtype=cd, init_std=0.2, **kw)
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
        ids = (rng.zipf(1.3, (B, F)) % BUCKET).astype(np.int32)
        vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
        labels = rng.integers(0, 2, B).astype(np.float32)
        weights = np.ones(B, np.float32)
        weights[-5:] = 0.0                      # padded tail lanes
        out.append((ids, vals, labels, weights))
    return out


COMPACT = dict(host_dedup=True, compact_cap=CAP)
# "segtotal": the compact totals by kernel A (segtotal_pallas), which
# takes FFM's rows on the card too; CAP keeps the reference's Pallas
# kernel inside its VMEM budget.
LEVERS = {"sel": {}, "blocked": dict(sel_blocked=True),
          "kernels": dict(sel_blocked=True, fused_embed="require"),
          "segtotal": dict(segtotal_pallas=True)}
FORMS = (
    [("float32", cd, "scatter_add", lever)
     for cd in ("float32", "bfloat16")
     for lever in ("sel", "blocked", "kernels")]
    + [("float32", "float32", "dedup", "sel"),
       ("float32", "float32", "dedup", "kernels"),
       ("bfloat16", "bfloat16", "dedup", "blocked"),
       ("bfloat16", "bfloat16", "dedup_sr", "sel"),
       ("bfloat16", "bfloat16", "dedup_sr", "kernels"),
       ("bfloat16", "float32", "dedup_sr", "blocked"),
       ("float32", "float32", "dedup", "segtotal"),
       ("bfloat16", "bfloat16", "dedup_sr", "segtotal")])


@pytest.mark.parametrize("pd,cd,mode,lever", FORMS)
def test_three_steps_match_jax(pd, cd, mode, lever):
    jspec, pspec = _specs(pd, cd)
    cfg = dict(learning_rate=0.05, reg_factors=1e-3, reg_linear=1e-4,
               reg_bias=1e-5, sparse_update=mode, seed=3,
               lr_schedule="inv_sqrt" if mode != "scatter_add" else "constant",
               **(COMPACT if mode != "scatter_add" else {}), **LEVERS[lever])
    jstep = jax.jit(jsparse.make_field_ffm_sparse_sgd_body(
        jspec, jtrain.TrainConfig(**cfg)))
    pstep = sparse.make_field_ffm_sparse_sgd_body(
        pspec, TrainConfig(**cfg), sr_noise=_jax_noise(3))
    jp, pp = _params(jspec, pspec)
    exact = pd == cd == "float32"
    tol = dict(rtol=2e-5, atol=2e-6) if exact else dict(rtol=3e-2, atol=3e-3)
    for i, (ids, vals, labels, weights) in enumerate(_batches(3)):
        aux = scatter.compact_aux(ids, CAP) if mode != "scatter_add" else None
        jp, jl = jstep(jp, jnp.int32(i), jnp.asarray(ids), jnp.asarray(vals),
                       jnp.asarray(labels), jnp.asarray(weights),
                       None if aux is None else tuple(map(jnp.asarray, aux)))
        pp, pl = pstep(pp, i, *(torch.from_numpy(a.copy()) for a in
                                (ids, vals, labels, weights)),
                       None if aux is None else
                       tuple(torch.from_numpy(a.copy()) for a in aux))
        assert abs(float(jl) - float(pl)) < (1e-6 if exact else 1e-3)
        for f in range(F):
            np.testing.assert_allclose(
                pp["vw"][f].float().numpy(),
                np.asarray(jp["vw"][f].astype(jnp.float32)), **tol)
        np.testing.assert_allclose(float(pp["w0"]), float(jp["w0"]), **tol)
    assert pp["vw"][0].dtype == pspec.pdtype


@pytest.mark.parametrize("cfg", [
    dict(gfull_fused=True),
    dict(embed_tier="require"),
    dict(embed_tier="sometimes"),
    dict(collective_dtype="bfloat16"),
    dict(score_sharded=True),
    dict(deep_sharded=True),
    dict(optimizer="adam"),
    dict(compact_cap=CAP),                                   # no host_dedup
    dict(host_dedup=True, compact_cap=CAP),                  # scatter_add
    dict(fused_embed="sometimes"),
])
def test_reference_guards_raise_the_same(cfg):
    jspec, pspec = _specs()
    with pytest.raises(ValueError) as want:
        jsparse.make_field_ffm_sparse_sgd_body(jspec, jtrain.TrainConfig(**cfg))
    with pytest.raises(ValueError) as got:
        sparse.make_field_ffm_sparse_sgd_body(pspec, TrainConfig(**cfg))
    # The embed-tier refusal names the port's own tiered trainer.
    assert str(got.value) == str(want.value).replace(
        "fm_spark_tpu.embed.", "fm_spark_tpu_torch.embed.")


def test_bodies_refuse_the_other_family():
    _, pspec = _specs()
    fm = models.FieldFMSpec(num_features=F * BUCKET, num_fields=F,
                            bucket=BUCKET, rank=K)
    with pytest.raises(ValueError, match="expected a FieldFFMSpec"):
        sparse.make_field_ffm_sparse_sgd_body(fm, TrainConfig())
    with pytest.raises(ValueError, match="expected a FieldFMSpec"):
        sparse.make_field_sparse_sgd_body(pspec, TrainConfig())


@pytest.mark.parametrize("cfg", [
    dict(fused_embed="off", sel_blocked=True),
    dict(fused_embed="auto", sel_blocked=True),
    dict(fused_embed="auto"),
    dict(fused_embed="require", sel_blocked=True),
])
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_fused_embed_plan_matches_jax(cfg, cd):
    jspec, pspec = _specs(cd=cd)
    jfam, jreason = jsparse.fused_embed_plan(jspec, jtrain.TrainConfig(**cfg))
    pfam, preason = sparse.fused_embed_plan(pspec, TrainConfig(**cfg))
    assert pfam == jfam
    if jfam is None and "sel_blocked" in jreason:
        assert "(set sel_blocked=True)" in preason


def test_require_without_sel_blocked_raises():
    jspec, pspec = _specs()
    with pytest.raises(PallasUnavailable):
        jsparse.make_field_ffm_sparse_sgd_body(
            jspec, jtrain.TrainConfig(fused_embed="require"))
    with pytest.raises(KernelUnavailable, match="set sel_blocked=True"):
        sparse.make_field_ffm_sparse_sgd_body(
            pspec, TrainConfig(fused_embed="require"))
    # A shape whose slab does not fit in shared memory: 'auto' falls back
    # with the reason, 'require' raises it.
    big = models.FieldFFMSpec(num_features=60 * 8, num_fields=60, bucket=8,
                              rank=64)
    fam, reason = sparse.fused_embed_plan(
        big, TrainConfig(fused_embed="auto", sel_blocked=True))
    assert fam is None and "shared memory" in reason
    with pytest.raises(KernelUnavailable, match="shared memory"):
        sparse.make_field_ffm_sparse_sgd_body(
            big, TrainConfig(fused_embed="require", sel_blocked=True))


def test_multistep_equals_single_steps():
    _, pspec = _specs("bfloat16", "bfloat16")
    cfg = TrainConfig(learning_rate=0.05, sparse_update="dedup_sr",
                      sel_blocked=True, fused_embed="require", **COMPACT)
    noise = _jax_noise(0)
    batches = _batches(3, seed=4)
    p1 = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    p2 = {"w0": p1["w0"].clone(), "vw": [t.clone() for t in p1["vw"]]}
    step = sparse.make_field_ffm_sparse_sgd_body(pspec, cfg, sr_noise=noise)
    for i, b in enumerate(batches):
        p1, l1 = step(p1, 5 + i, *map(torch.from_numpy, b),
                      tuple(map(torch.from_numpy,
                                scatter.compact_aux(b[0], CAP))))
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*batches)]
    aux = tuple(torch.from_numpy(np.stack(a)) for a in
                zip(*[scatter.compact_aux(b[0], CAP) for b in batches]))
    mstep = sparse.make_field_sparse_multistep(pspec, cfg, 4, sr_noise=noise)
    p2, l2 = mstep(p2, 5, 3, *stacked, aux)
    assert float(l1) == float(l2)
    assert all(torch.equal(a, b) for a, b in zip(p1["vw"], p2["vw"]))
    assert torch.equal(p1["w0"], p2["w0"])


def test_fit_trains_and_evaluate_matches_jax(capsys):
    jspec, pspec = _specs(cd="bfloat16")
    ids, vals, labels = data.synthetic_ctr(2000, F * BUCKET, F, seed=0)
    ids = data.field_local(ids, BUCKET)
    cfg = TrainConfig(num_steps=8, learning_rate=0.2, lr_schedule="constant",
                      sel_blocked=True, fused_embed="auto")
    stats = {}
    params = fit_field_sparse(pspec, cfg, data.Batches(ids, vals, labels, B),
                              device="cpu", steps_per_call=3, stats=stats)
    assert "FieldFFMSpec served by kernel family 'ffm_sel'" in \
        capsys.readouterr().err
    assert len(stats["loss"]) == 3 and np.isfinite(stats["loss"]).all()
    again = fit_field_sparse(pspec, cfg, data.Batches(ids, vals, labels, B),
                             device="cpu", prefetch=0)
    assert all(torch.equal(a, b) for a, b in zip(params["vw"], again["vw"]))
    batches = list(data.iterate_once(ids, vals, labels, 512))
    got = evaluate_params(pspec, params, batches)
    jp = {"w0": jnp.float32(float(params["w0"])),
          "vw": [jnp.asarray(t.numpy()) for t in params["vw"]]}
    want = jtrain.evaluate_params(jspec, jp, batches)
    assert got["count"] == want["count"] == 2000
    assert got["logloss"] == pytest.approx(want["logloss"], abs=1e-3)
    assert got["auc"] == pytest.approx(want["auc"], abs=1e-3)


def test_configs_build_the_ffm_spec_as_jax():
    from fm_spark_tpu import configs as jconfigs

    for kw in ({}, dict(bucket=64, compute_dtype="bfloat16")):
        got = configs.get_config("avazu_ffm_r16", **kw).spec()
        want = jconfigs.get_config("avazu_ffm_r16", **kw).spec()
        assert got == models.FieldFFMSpec(**dataclasses.asdict(want))
    with pytest.raises(ValueError, match="table_layout='col' is a field_fm"):
        configs.get_config("avazu_ffm_r16", table_layout="col").spec()


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "fm_spark_tpu_torch", *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600)


def test_cli_trains_evaluates_and_predicts_ffm(tmp_path):
    out = tmp_path / "model"
    proc = _cli("train", "--config", "avazu_ffm_r16", "--bucket", "64",
                "--synthetic", "2000", "--steps", "3", "--batch-size", "512",
                "--sel-blocked", "--fused-embed", "require", "--device", "cpu",
                "--model-out", str(out))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    assert [x["step"] for x in lines[:3]] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in lines[:3])
    assert lines[3]["eval"]["count"] == 400.0
    launched = json.loads(proc.stderr.strip().splitlines()[-1])
    assert launched["kernel_launches"]["ffm_sel_bwd"] == 0   # the CPU: plain
    spec, params = models.load_model(str(out), device="cpu")
    assert spec == configs.get_config("avazu_ffm_r16", bucket=64).spec()

    proc = _cli("eval", "--model", str(out), "--synthetic", "300",
                "--batch-size", "128", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    assert metrics["count"] == 300.0 and np.isfinite(metrics["logloss"])

    proc = _cli("predict", "--model", str(out), "--synthetic", "40",
                "--batch-size", "16", "--device", "cpu")
    assert proc.returncode == 0, proc.stderr[-3000:]
    preds = np.array([float(x) for x in proc.stdout.split()])
    assert preds.shape == (40,) and ((preds > 0) & (preds < 1)).all()

    # The JAX package loads the dir and scores the same examples alike
    # (%.6g predictions: 6 significant digits).
    jspec, jp = jmodels.load_model(str(out))
    ids, vals, _ = data.synthetic_ctr(40, spec.num_features, spec.num_fields,
                                      seed=1)
    ids = data.field_local(ids, spec.bucket)
    want = np.asarray(jspec.predict(jp, jnp.asarray(ids), jnp.asarray(vals)))
    np.testing.assert_allclose(preds, want, rtol=1e-5, atol=1e-6)


def test_cli_refuses_sel_blocked_for_field_fm():
    proc = _cli("train", "--config", "criteo1tb_fm_r64", "--bucket", "64",
                "--synthetic", "100", "--steps", "1", "--sel-blocked",
                "--device", "cpu")
    assert proc.returncode != 0
    assert ("--sel-blocked is the single-chip FieldFFM body's lever (it "
            "blocks the [B, F, F, k] sel tensor; found 1 device(s), "
            "FieldFMSpec)") in proc.stderr
    assert ffm_sel.scores_launches == 0
