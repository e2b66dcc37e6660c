"""The port's training slice against the JAX package: the fused sparse-SGD
step, its guards, the training loop, metrics, batching, configs and the
CLI.

Parameters are drawn by JAX and carried across by ``params_from_numpy``;
batches are numpy from a seed; the SR noise of ``dedup_sr`` on bf16
tables is JAX's own bits, injected. Step parity uses the reference's own
tolerances (``tests/test_pallas_fused.py``): loss within 1e-6 and
parameters within ``atol=1e-5`` for float32 storage and compute, loss
within 1e-3 and parameters within ``atol=1e-2`` where bf16 is involved.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import configs as jconfigs
from fm_spark_tpu import data as jdata
from fm_spark_tpu import sparse as jsparse
from fm_spark_tpu import train as jtrain
from fm_spark_tpu.models.field_fm import FieldFMSpec as JaxFieldFMSpec
from fm_spark_tpu.ops import scatter as jscatter
from fm_spark_tpu.utils import metrics as jmetrics
from fm_spark_tpu_torch import DeviceUnavailable, configs, data, models, sparse
from fm_spark_tpu_torch.ops import fused_bwd, scatter, segsum
from fm_spark_tpu_torch.train import (TrainConfig, _lr_at, evaluate_params,
                                      fit_field_sparse)
from fm_spark_tpu_torch.utils import metrics

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, K, BUCKET, CAP = 256, 5, 8, 96, 96


def _specs(pd="float32", cd="float32", **kw):
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET, rank=K,
              param_dtype=pd, compute_dtype=cd, init_std=0.1, **kw)
    return JaxFieldFMSpec(**kw), models.FieldFMSpec(**kw)


def _carry(jspec, pspec, jp):
    flat = {"w0": np.asarray(jp["w0"])}
    flat.update({f"vw/{f}": np.asarray(t.astype(jnp.float32))
                 for f, t in enumerate(jp["vw"])})
    return models.params_from_numpy(pspec, flat, "cpu")


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
        weights[-7:] = 0.0                      # padded tail lanes
        out.append((ids, vals, labels, weights))
    return out


COMPACT = dict(host_dedup=True, compact_cap=CAP)
LEVERS = {"plain": {}, "gfull": dict(gfull_fused=True),
          "segtotal": dict(segtotal_pallas=True),
          "gfull+segtotal": dict(gfull_fused=True, segtotal_pallas=True),
          "fusedbwd": dict(fused_embed="require")}
FORMS = (
    [("float32", "float32", "scatter_add", "plain"),
     ("bfloat16", "bfloat16", "scatter_add", "plain")]
    + [(pd, cd, mode, lever)
       for pd, cd in (("float32", "float32"), ("bfloat16", "bfloat16"))
       for mode in ("dedup", "dedup_sr") for lever in LEVERS]
    + [("bfloat16", "float32", "dedup_sr", "gfull+segtotal"),
       ("bfloat16", "float32", "dedup_sr", "fusedbwd")])


@pytest.mark.parametrize("pd,cd,mode,lever", FORMS)
def test_three_steps_match_jax(pd, cd, mode, lever):
    jspec, pspec = _specs(pd, cd)
    cfg = dict(learning_rate=0.05, reg_factors=1e-4, reg_linear=1e-5,
               reg_bias=1e-6, sparse_update=mode, seed=3,
               lr_schedule="inv_sqrt" if lever != "plain" else "constant",
               **(COMPACT if mode != "scatter_add" else {}), **LEVERS[lever])
    jstep = jax.jit(jsparse.make_field_sparse_sgd_body(
        jspec, jtrain.TrainConfig(**cfg)))
    pstep = sparse.make_field_sparse_sgd_body(pspec, TrainConfig(**cfg),
                                              sr_noise=_jax_noise(3))
    jp = jspec.init(jax.random.key(0))
    pp = _carry(jspec, pspec, jp)
    launches = segsum.launches, fused_bwd.launches
    exact = pd == cd == "float32"
    for i, (ids, vals, labels, weights) in enumerate(_batches(3)):
        aux = scatter.compact_aux(ids, CAP) if mode != "scatter_add" else None
        jp, jl = jstep(jp, jnp.int32(i), jnp.asarray(ids), jnp.asarray(vals),
                       jnp.asarray(labels), jnp.asarray(weights),
                       None if aux is None else tuple(map(jnp.asarray, aux)))
        pp, pl = pstep(pp, i, *(torch.from_numpy(a) for a in
                                (ids, vals, labels, weights)),
                       None if aux is None else
                       tuple(map(torch.from_numpy, aux)))
        assert abs(float(jl) - float(pl)) < (1e-6 if exact else 1e-3)
        for f in range(F):
            np.testing.assert_allclose(
                pp["vw"][f].double().numpy(),
                np.asarray(jp["vw"][f], np.float64),
                rtol=0, atol=1e-5 if exact else 1e-2)
        assert abs(float(jp["w0"]) - float(pp["w0"])) < (1e-5 if exact else 1e-2)
    assert pp["vw"][0].dtype == pspec.pdtype
    # On the CPU the wrappers run their plain versions: no launch.
    assert (segsum.launches, fused_bwd.launches) == launches


# use_pallas and the per-lane dedup forms are ported (and tested in
# tests/test_torch_train_pallas.py), and compact_device (tested in
# tests/test_torch_compact_device.py). The last two forms that raised,
# the col layout and the unfused linear (ROADMAP Queue 1 item 7), are
# ported too (tests/test_torch_field_fm_layouts.py): their cases, under
# their old ids, now build and take a step equal to JAX's.
UNPORTED = [
    pytest.param(dict(sparse_update="dedup", **COMPACT),
                 dict(table_layout="col"), "table_layout='col'",
                 id="cfg4-spec_kw4-table_layout='col'"),
    pytest.param({}, dict(fused_linear=False), "fused_linear=False",
                 id="cfg5-spec_kw5-fused_linear=False"),
]


@pytest.mark.parametrize("cfg,spec_kw,match", UNPORTED)
def test_unported_forms_raise_with_their_roadmap_item(cfg, spec_kw, match):
    jspec, pspec = _specs(**spec_kw)
    assert match in repr(pspec)
    step = sparse.make_field_sparse_sgd_body(pspec, TrainConfig(**cfg))
    jstep = jsparse.make_field_sparse_sgd_body(jspec,
                                               jtrain.TrainConfig(**cfg))
    jp = jspec.init(jax.random.key(0))
    flat = {"w0": np.asarray(jp["w0"])}
    for group in ("vw", "v", "w"):
        flat.update({f"{group}/{f}": np.asarray(t)
                     for f, t in enumerate(jp.get(group, []))})
    pp = models.params_from_numpy(pspec, flat, "cpu")
    batch = _batches(1)[0]
    aux = (scatter.compact_aux(batch[0], CAP)
           if cfg.get("compact_cap") else None)
    jp, jl = jstep(jp, jnp.int32(0), *map(jnp.asarray, batch),
                   None if aux is None else tuple(map(jnp.asarray, aux)))
    pp, pl = step(pp, 0, *(torch.from_numpy(a.copy()) for a in batch),
                  None if aux is None else tuple(map(torch.from_numpy, aux)))
    assert abs(float(jl) - float(pl)) < 1e-6
    for group in ("vw", "v", "w"):
        for want, got in zip(jp.get(group, []), pp.get(group, [])):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("cfg", [
    dict(compact_cap=CAP),                                   # no host_dedup
    dict(host_dedup=True, compact_cap=CAP),                  # scatter_add
    dict(segtotal_pallas=True),
    dict(sparse_update="dedup", host_dedup=True, compact_cap=CAP,
         compact_overflow="drop"),
    dict(optimizer="adam"),
    dict(collective_dtype="bfloat16"),
    dict(fused_embed="sometimes"),
])
def test_reference_guards_raise_the_same(cfg):
    jspec, pspec = _specs()
    with pytest.raises(ValueError) as want:
        jsparse.make_field_sparse_sgd_body(jspec, jtrain.TrainConfig(**cfg))
    with pytest.raises(ValueError) as got:
        sparse.make_field_sparse_sgd_body(pspec, TrainConfig(**cfg))
    assert str(got.value) == str(want.value)


def test_multistep_equals_single_steps_and_keeps_a_neg_inf_loss(monkeypatch):
    _, pspec = _specs("bfloat16", "bfloat16")
    cfg = TrainConfig(learning_rate=0.05, sparse_update="dedup_sr",
                      gfull_fused=True, **COMPACT)
    noise = _jax_noise(0)
    batches = _batches(3, seed=4)
    p1 = pspec.init(torch.Generator().manual_seed(1), device="cpu")
    p2 = {"w0": p1["w0"].clone(), "vw": [t.clone() for t in p1["vw"]]}
    step = sparse.make_field_sparse_sgd_body(pspec, cfg, sr_noise=noise)
    for i, b in enumerate(batches):
        p1, l1 = step(p1, 5 + i, *map(torch.from_numpy, b),
                      tuple(map(torch.from_numpy, scatter.compact_aux(b[0], CAP))))
    stacked = [torch.from_numpy(np.stack(a)) for a in zip(*batches)]
    aux = tuple(torch.from_numpy(np.stack(a)) for a in
                zip(*[scatter.compact_aux(b[0], CAP) for b in batches]))
    mstep = sparse.make_field_sparse_multistep(pspec, cfg, 4, sr_noise=noise)
    p2, l2 = mstep(p2, 5, 3, *stacked, aux)
    assert float(l1) == float(l2)
    assert all(torch.equal(a, b) for a, b in zip(p1["vw"], p2["vw"]))
    assert torch.equal(p1["w0"], p2["w0"])

    # A -inf loss (the compact overflow poison) sticks over later steps.
    losses = iter([float("-inf"), 0.5])
    monkeypatch.setattr(sparse, "make_field_sparse_sgd_body",
                        lambda *a, **k: lambda p, *b: (p, torch.tensor(
                            next(losses))))
    _, loss = sparse.make_field_sparse_multistep(pspec, cfg, 2)(
        p2, 0, 2, *stacked, aux)
    assert float(loss) == float("-inf")


def test_lr_schedule_matches_jax():
    for sched in ("inv_sqrt", "constant"):
        kw = dict(learning_rate=0.07, lr_schedule=sched)
        jlr = jsparse._lr_at(jtrain.TrainConfig(**kw))
        plr = _lr_at(TrainConfig(**kw))
        for i in (0, 1, 7, 1000, 123457):
            got = plr(i)
            assert got.dtype == np.float32
            assert got == np.asarray(jlr(jnp.int32(i)))
    with pytest.raises(ValueError):
        _lr_at(TrainConfig(lr_schedule="cosine"))


def test_configs_and_train_config_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(TrainConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jtrain.TrainConfig)])
    assert set(configs.CONFIGS) == set(jconfigs.CONFIGS)
    for name, pc in configs.CONFIGS.items():
        jc = jconfigs.CONFIGS[name]
        for field in dataclasses.fields(pc):
            if field.name != "description":
                assert getattr(pc, field.name) == getattr(jc, field.name)
        assert pc.train_config(num_steps=3) == TrainConfig(
            **dataclasses.asdict(jc.train_config(num_steps=3)))
    c3 = configs.get_config("criteo1tb_fm_r64", param_dtype="bfloat16")
    assert c3.spec() == models.FieldFMSpec(
        **dataclasses.asdict(jconfigs.get_config(
            "criteo1tb_fm_r64", param_dtype="bfloat16").spec()))
    c5 = configs.get_config("criteo1tb_deepfm", param_dtype="bfloat16")
    assert c5.spec() == models.FieldDeepFMSpec(
        **dataclasses.asdict(jconfigs.get_config(
            "criteo1tb_deepfm", param_dtype="bfloat16").spec()))
    # The flat family: config 2's hashed size, config 1's from the data.
    assert configs.get_config("criteo_kaggle_fm_r32").spec() == models.FMSpec(
        **dataclasses.asdict(jconfigs.get_config(
            "criteo_kaggle_fm_r32").spec()))
    c1, jc1 = (configs.get_config("movielens_fm_r8"),
               jconfigs.get_config("movielens_fm_r8"))
    assert c1.spec(2625) == models.FMSpec(**dataclasses.asdict(jc1.spec(2625)))
    for cfg in (c1, jc1):
        with pytest.raises(ValueError, match="takes num_features from"):
            cfg.spec()
    with pytest.raises(KeyError):
        configs.get_config("nope")


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    scores = (rng.normal(size=1000) * 2).astype(np.float32)
    labels = rng.integers(0, 2, 1000).astype(np.float32)
    weights = (rng.random(1000) > 0.2).astype(np.float32)
    per = (np.log1p(np.exp(scores)) - labels * scores).astype(np.float32)
    js, ps = jmetrics.init_metrics(), metrics.init_metrics()
    for sl in (slice(0, 600), slice(600, 1000)):
        js = jmetrics.update_metrics(js, *(jnp.asarray(a[sl]) for a in
                                           (scores, labels, per, weights)))
        ps = metrics.update_metrics(ps, *(torch.from_numpy(a[sl]) for a in
                                          (scores, labels, per, weights)))
    want = {k: float(v) for k, v in jmetrics.finalize_metrics(js).items()}
    got = metrics.finalize_metrics(ps)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-7)
    empty = metrics.finalize_metrics(metrics.init_metrics())
    assert empty["auc"] == 0.5 and empty["count"] == 0.0


def test_batches_and_split_follow_the_jax_order():
    ids, vals, labels = data.synthetic_ctr(1000, F * BUCKET, F, seed=2)
    tr_p, te_p = data.train_test_split(ids, vals, labels, 0.2, seed=4)
    tr_j, te_j = jdata.train_test_split(ids, vals, labels, 0.2, seed=4)
    for a, b in zip(tr_p + te_p, tr_j + te_j):
        np.testing.assert_array_equal(a, b)
    pb = data.Batches(*tr_p, 300, seed=9)
    jb = jdata.Batches(*tr_j, 300, seed=9)
    for _ in range(7):                          # crosses two epochs
        for a, b in zip(pb.next_batch(), jb.next_batch()):
            np.testing.assert_array_equal(a, b)
    assert pb.state() == jb.state()


def test_dedup_aux_batches_and_prefetcher():
    ids, vals, labels = data.synthetic_ctr(600, F * BUCKET, F, seed=2)
    ids = data.field_local(ids, BUCKET)
    src = data.DedupAuxBatches(data.Batches(ids, vals, labels, B, seed=1),
                               cap=CAP)
    want = data.DedupAuxBatches(data.Batches(ids, vals, labels, B, seed=1),
                                cap=CAP)
    with data.Prefetcher(src, depth=2, device="cpu") as pf:
        for _ in range(3):
            got = pf.next_batch()
            ref = want.next_batch()
            for g, r in zip(got[:4], ref[:4]):
                assert isinstance(g, torch.Tensor)
                np.testing.assert_array_equal(g.numpy(), r)
            for g, r in zip(got[4], ref[4]):
                np.testing.assert_array_equal(g.numpy(), r)
        assert pf.state() == {"epoch": 1, "index": 0, "seed": 1}
    assert len(src.aux_ms) >= 3
    with pytest.raises(RuntimeError, match="closed"):
        pf.next_batch()
    with pytest.raises(ValueError, match="'error' or 'split'"):
        data.DedupAuxBatches(src, cap=CAP, overflow="drop")
    # 'split' is the reference's host policy (tests/test_torch_ingest.py).
    data.DedupAuxBatches(src, cap=CAP, overflow="split")
    # cap=0: the per-lane dedup aux, the reference's.
    batch = data.DedupAuxBatches(
        data.Batches(ids, vals, labels, B, seed=1)).next_batch()
    for g, r in zip(batch[4], jscatter.dedup_aux(batch[0])):
        np.testing.assert_array_equal(g, r)
    tiny = data.DedupAuxBatches(data.Batches(ids, vals, labels, B), cap=4)
    with data.Prefetcher(tiny, device="cpu") as pf:
        with pytest.raises(scatter.CompactCapOverflow):
            pf.next_batch()


def test_fit_trains_and_evaluate_matches_jax():
    jspec, pspec = _specs("bfloat16", "bfloat16")
    ids, vals, labels = data.synthetic_ctr(3000, F * BUCKET, F, seed=0)
    ids = data.field_local(ids, BUCKET)
    cfg = TrainConfig(num_steps=12, learning_rate=0.2, lr_schedule="constant",
                      sparse_update="dedup_sr", fused_embed="require",
                      **COMPACT)
    stats = {}
    params = fit_field_sparse(pspec, cfg, data.Batches(ids, vals, labels, B),
                              device="cpu", steps_per_call=5, stats=stats)
    assert len(stats["loss"]) == 3 and len(stats["step_ms"]) == 3
    assert len(stats["aux_ms"]) >= 12
    assert np.isfinite(stats["loss"]).all()
    # The same steps one at a time, fed without the prefetcher.
    again = fit_field_sparse(pspec, cfg, data.Batches(ids, vals, labels, B),
                             device="cpu", prefetch=0)
    assert all(torch.equal(a, b) for a, b in zip(params["vw"], again["vw"]))
    batches = list(data.iterate_once(ids, vals, labels, 512))
    got = evaluate_params(pspec, params, batches)
    jp = {"w0": jnp.float32(float(params["w0"])),
          "vw": [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
                 for t in params["vw"]]}
    want = jtrain.evaluate_params(jspec, jp, batches)
    assert got["count"] == want["count"] == 3000
    # bf16 scores: the port accumulates in fp32, JAX in bf16.
    assert got["logloss"] == pytest.approx(want["logloss"], abs=5e-3)
    assert got["auc"] == pytest.approx(want["auc"], abs=5e-3)
    if not torch.cuda.is_available():     # no silent move to the CPU
        with pytest.raises(DeviceUnavailable):
            fit_field_sparse(pspec, cfg, data.Batches(ids, vals, labels, B))


def test_cli_trains_saves_and_the_model_loads(tmp_path):
    out = tmp_path / "model"
    cmd = [sys.executable, "-m", "fm_spark_tpu_torch", "train", "--config",
           "criteo1tb_fm_r64", "--synthetic", "2000", "--steps", "3",
           "--batch-size", "256", "--device", "cpu", "--model-out", str(out)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [__import__("json").loads(x) for x in proc.stdout.splitlines()]
    assert [x["step"] for x in lines[:3]] == [1, 2, 3]
    assert all(np.isfinite(x["loss"]) for x in lines[:3])
    assert lines[3]["eval"]["count"] == 400.0
    assert lines[4] == {"saved": str(out)}
    spec, params = models.load_model(str(out), device="cpu")
    assert spec == configs.get_config("criteo1tb_fm_r64").spec()
    proc = subprocess.run(
        [sys.executable, "-m", "fm_spark_tpu_torch", "predict", "--model",
         str(out), "--synthetic", "20", "--batch-size", "8", "--device",
         "cpu"], cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    preds = np.array([float(x) for x in proc.stdout.split()])
    assert preds.shape == (20,) and ((preds > 0) & (preds < 1)).all()
