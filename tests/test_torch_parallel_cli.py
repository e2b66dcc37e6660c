"""``fmtorch train --distributed`` end to end on the CPU, and the sharded
steps at a mesh of one.

- Two processes, each ``fmtorch train --distributed --coordinator
  127.0.0.1:PORT --num-processes 2 --process-id R`` (a gloo group) on
  config 3 narrowed to 16 buckets with ``--ckpt-sharded`` and the device
  compact aux (modelled on the reference's ``tests/multihost_worker.py``):
  both print the same losses, each rank writes its fields into the chain,
  the same command resumes it, and the chain reads back into a
  single-card ``fmtorch eval --checkpoint-dir``; the rank-0 model equals
  the chain's tables. The group is joined under a timeout of its own and
  killed on failure.
- At a mesh of one (no process group) the field-sharded FieldFM step
  equals the single-card fused body bit for bit, in every form the
  sharded step takes.
- The reference's refusals, with its messages.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_parallel_harness as h
from fm_spark_tpu_torch import cli, models, parallel, sparse
from fm_spark_tpu_torch.ops import scatter
from fm_spark_tpu_torch.train import TrainConfig

TRAIN = ["train", "--config", "criteo1tb_fm_r64", "--bucket", "16",
         "--synthetic", "1200", "--batch-size", "128", "--test-fraction", "0",
         "--sparse-update", "dedup", "--compact-device", "--compact-cap", "64",
         "--compact-overflow", "drop", "--device", "cpu", "--obs-dir", "none",
         "--checkpoint-every", "2", "--prefetch", "0"]


def _launch(args, world, timeout_s=60.0, stderr=None):
    """Run ``fmtorch`` on ``world`` ranks of a fresh gloo group; returns
    each rank's stdout JSON lines (and appends each rank's stderr to the
    list ``stderr``). Every process is killed past ``timeout_s``."""
    port = h.free_port()
    env = dict(os.environ, PYTHONPATH=h.REPO, OMP_NUM_THREADS="1",
               FM_SPARK_OBS_DIR="none")
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-m", "fm_spark_tpu_torch", *args, "--distributed",
         "--coordinator", f"127.0.0.1:{port}", "--num-processes", str(world),
         "--process-id", str(r)], env=env, cwd=h.REPO,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout_s)
            outs.append((p.returncode, out.decode(), err.decode()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(rc, err[-2000:]) for rc, _, err in outs if rc]
    assert not bad, bad
    if stderr is not None:
        stderr.extend(err for _, _, err in outs)
    return [[json.loads(x) for x in out.splitlines() if x.startswith("{")]
            for _, out, _ in outs]


def _losses(lines):
    return [(x["step"], x["loss"]) for x in lines if "loss" in x]


def _metric_lines(path):
    with open(path) as f:
        return [json.loads(x) for x in f]


def test_distributed_train_ckpt_sharded_resumes_and_evals(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    log = str(tmp_path / "metrics.jsonl")
    first = _launch(TRAIN + ["--steps", "4", "--checkpoint-dir", ck,
                             "--ckpt-sharded", "--metrics", log], 2)
    assert _losses(first[0]) == _losses(first[1])
    assert _losses(first[0])[-1][0] == 4
    # Rank 0 alone appends to --metrics: one line per log step.
    assert [x["step"] for x in _metric_lines(log)] == [1, 2, 3, 4]
    state = json.load(open(os.path.join(ck, "4", "state.json")))
    assert state["layout"] == "sharded"
    assert state["mesh"] == {"feat": 2, "row": 1}
    # Rank 0 owns fields 0-19 and rank 1 fields 20-38 (39 pad to 40).
    assert {"vw/0", "vw/38", "w0"} <= set(state["arrays"])
    out = str(tmp_path / "m")
    second = _launch(TRAIN + ["--steps", "6", "--checkpoint-dir", ck,
                              "--ckpt-sharded", "--model-out", out], 2)
    assert any(x.get("resumed", {}).get("step") == 4 for x in second[0])
    assert _losses(second[0]) == _losses(second[1])
    assert _losses(second[0])[-1][0] == 6
    rc = cli.main(["eval", "--checkpoint-dir", ck, "--config",
                   "criteo1tb_fm_r64", "--bucket", "16", "--synthetic",
                   "300", "--device", "cpu"])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert lines[0] == {"checkpoint_step": 6}
    assert np.isfinite(lines[1]["logloss"])
    spec, saved = models.load_model(out, device="cpu")
    from fm_spark_tpu_torch.checkpoint import Checkpointer

    restored = Checkpointer(ck).restore()
    for f in (0, 20, 38):
        assert torch.equal(saved["vw"][f], restored["params"][f"vw/{f}"])
    # A sharded chain does not resume as canonical, nor on another mesh.
    with pytest.raises(SystemExit, match="add --ckpt-sharded"):
        cli.main(TRAIN + ["--steps", "8", "--checkpoint-dir", ck])


def test_distributed_train_ranks_print_the_same_losses(tmp_path):
    """Two ranks, the canonical chain, config 4's FieldFFM narrowed, with
    the in-fit and final evals on the sharded layout."""
    args = ["train", "--config", "avazu_ffm_r16", "--bucket", "16",
            "--synthetic", "800", "--batch-size", "64", "--steps", "3",
            "--test-fraction", "0.2", "--eval-every", "2",
            "--sparse-update", "dedup",
            "--device", "cpu", "--obs-dir", "none", "--prefetch", "0",
            "--checkpoint-dir", str(tmp_path / "ck"),
            "--checkpoint-every", "3"]
    out = _launch(args, 2)
    assert _losses(out[0]) == _losses(out[1])
    evals = [[{k: v for k, v in x.items() if k != "ts"} for x in o
              if "eval" in x or "eval_logloss" in x] for o in out]
    assert evals[0] == evals[1]
    assert [x.get("step") for x in evals[0]] == [2, None]
    state = json.load(open(tmp_path / "ck" / "3" / "state.json"))
    assert state["layout"] == "canonical"


def test_distributed_dp_and_row_through_the_cli(tmp_path, capsys):
    """``--strategy dp`` on two ranks (config 1's flat FM, each rank
    reading its own rows, the gradient all-reduced) with ``--embed-tier
    auto``, ``--eval-every`` and ``--metrics``: the tier falls back to the
    in-memory tables and says why, both ranks print the same losses and
    evals, and the metrics file holds one line per log step;
    ``--strategy row`` on one process (a mesh of one, no group) trains
    and saves a model that evals."""
    log = str(tmp_path / "dp.jsonl")
    args = ["train", "--config", "movielens_fm_r8", "--synthetic", "2000",
            "--batch-size", "256", "--steps", "3", "--strategy", "dp",
            "--device", "cpu", "--obs-dir", "none", "--test-fraction", "0.2",
            "--eval-every", "2", "--embed-tier", "auto", "--hot-rows", "256",
            "--embed-bucket-rows", "128", "--metrics", log]
    err = []
    out = _launch(args, 2, stderr=err)
    assert all("embed-tier auto: in-HBM fallback (strategy 'dp' shards or "
               "replicates its tables" in e for e in err)
    assert _losses(out[0]) == _losses(out[1])
    assert [s for s, _ in _losses(out[0])] == [1, 2, 3]
    assert [x for x in out[0] if "eval" in x] == \
        [x for x in out[1] if "eval" in x]
    lines = _metric_lines(log)
    assert [x["step"] for x in lines if "loss" in x] == [1, 2, 3]
    assert all(np.isfinite(x["grad_norm"]) for x in lines if "loss" in x)
    assert [x["step"] for x in lines if "eval_logloss" in x] == [2]
    model = str(tmp_path / "row")
    rc = cli.main(["train", "--config", "movielens_fm_r8", "--synthetic",
                   "2000", "--batch-size", "256", "--steps", "3",
                   "--strategy", "row", "--device", "cpu", "--obs-dir",
                   "none", "--model-out", model])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert [x["step"] for x in lines if "loss" in x] == [1, 2, 3]
    assert any("eval" in x for x in lines)
    assert cli.main(["eval", "--model", model, "--synthetic", "300",
                     "--device", "cpu"]) == 0


F, BK, K, B = 5, 32, 4, 64
WORLD1 = {
    "lane-dedup-reg": dict(learning_rate=0.1, reg_factors=1e-2,
                           reg_linear=1e-3, reg_bias=1e-3,
                           sparse_update="dedup"),
    "lane-scatter-add": dict(sparse_update="scatter_add"),
    "device-compact-segtotal-sr": dict(sparse_update="dedup_sr",
                                       compact_cap=64, compact_device=True,
                                       segtotal_pallas=True),
    "host-compact-gfull": dict(sparse_update="dedup", compact_cap=64,
                               host_dedup=True, gfull_fused=True),
    "pallas-rows": dict(sparse_update="dedup", use_pallas=True),
}


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", list(WORLD1))
def test_world_1_sharded_fm_equals_the_single_card_body(form, dt):
    cfg = TrainConfig(**WORLD1[form])
    spec = models.FieldFMSpec(num_features=F * BK, num_fields=F, bucket=BK,
                              rank=K, param_dtype=dt, compute_dtype=dt,
                              init_std=0.1)
    p1 = spec.init(torch.Generator().manual_seed(0), device="cpu")
    mesh = parallel.make_field_mesh(device="cpu")
    p2 = parallel.shard_field_params(
        parallel.stack_field_params(spec, p1, 1), mesh)
    single = sparse.make_field_sparse_sgd_body(spec, cfg)
    shard = parallel.make_field_sharded_sgd_body(spec, cfg, mesh)
    rng = np.random.default_rng(0)
    for i in range(3):
        ids = (rng.zipf(1.3, (B, F)) % BK).astype(np.int32)
        batch = [torch.from_numpy(a) for a in (
            ids, rng.uniform(0.5, 1.5, (B, F)).astype(np.float32),
            rng.integers(0, 2, B).astype(np.float32),
            (rng.random(B) > 0.1).astype(np.float32))]
        aux = caux = None
        if cfg.host_dedup:
            host = scatter.compact_aux(ids, cfg.compact_cap)
            aux = tuple(torch.from_numpy(a) for a in host)
            caux = parallel.shard_compact_aux(host, mesh)
        _, l1 = single(p1, i, *batch, aux)
        _, l2 = shard(p2, i, *batch, caux)
        assert torch.equal(l1, l2)
    assert torch.equal(p1["w0"], p2["w0"])
    for f in range(F):
        assert torch.equal(p1["vw"][f], p2["vw"][f]), f


def _raises(match, argv):
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)


def test_distributed_flags_keep_the_reference_guards():
    base = ["train", "--config", "criteo1tb_fm_r64", "--bucket", "16",
            "--synthetic", "300", "--steps", "1", "--device", "cpu",
            "--obs-dir", "none"]
    _raises("require --distributed", base + ["--coordinator", "x:1"])
    _raises("must be given together", base + ["--distributed",
                                              "--coordinator", "x:1"])
    _raises("--ckpt-sharded applies to multi-device", base + [
        "--ckpt-sharded"])
    _raises("needs multiple devices", base + ["--row-shards", "2"])
    _raises("exclusive", base + ["--batch-per-chip", "64", "--batch-size",
                                 "64"])
    _raises("FM family only", base + ["--strategy", "row"])
    flat = ["train", "--config", "movielens_fm_r8", "--synthetic", "300",
            "--steps", "1", "--device", "cpu", "--obs-dir", "none"]
    _raises("cannot be served: strategy 'row' shards or replicates", flat + [
        "--strategy", "row", "--embed-tier", "require", "--hot-rows", "256",
        "--embed-bucket-rows", "128"])
    _raises("--divergence-guard requires strategy 'single'", flat + [
        "--strategy", "row", "--divergence-guard", "--checkpoint-dir", "x"])
    # dp under --distributed (a group of one here) is the parallel step.
    _raises("--divergence-guard requires strategy 'single'", flat + [
        "--strategy", "dp", "--divergence-guard", "--checkpoint-dir", "x",
        "--distributed", "--coordinator", f"127.0.0.1:{h.free_port()}",
        "--num-processes", "1", "--process-id", "0"])
    import torch.distributed as dist

    assert not dist.is_initialized()       # the failed run left the group
    _raises("--force to run 'row'", [
        "train", "--config", "criteo_kaggle_fm_r32", "--synthetic", "300",
        "--steps", "1", "--strategy", "row", "--device", "cpu",
        "--obs-dir", "none"])


def test_each_rank_reads_its_own_rows():
    """``--distributed``'s per-rank input shard: every 2nd in-memory row
    from the rank's index, batches of ``B / n``, the ranks' rows disjoint
    and equal in number; a packed slice's cursor leaves out its bounds."""
    args = cli.build_parser().parse_args(
        ["train", "--config", "movielens_fm_r8", "--synthetic", "301",
         "--batch-size", "64", "--test-fraction", "0", "--steps", "1"])
    from fm_spark_tpu_torch import configs

    cfg = configs.get_config("movielens_fm_r8")
    tconfig = cfg.train_config(batch_size=64)
    whole = cli._train_source(args, cfg, tconfig)[0]
    parts = [cli._train_source(args, cfg, tconfig, (p, 2))[0]
             for p in range(2)]
    assert [b.batch_size for b in parts] == [32, 32]
    assert [len(b.labels) for b in parts] == [150, 150]
    for p, b in enumerate(parts):
        np.testing.assert_array_equal(b.ids, whole.ids[p:300:2])

    class Slice:
        def state(self):
            return {"epoch": 1, "index": 3, "lo": 10, "hi": 20}

    assert cli._RankCursor(Slice()).state() == {"epoch": 1, "index": 3}


def test_sharded_steps_keep_the_reference_rejects():
    mesh = parallel.make_field_mesh(device="cpu")
    ffm = models.FieldFFMSpec(num_features=F * BK, num_fields=F, bucket=BK,
                              rank=K)
    for lever, match in [(dict(use_pallas=True), "single-chip experiment"),
                         (dict(sel_blocked=True), "sel_blocked"),
                         (dict(gfull_fused=True), "gfull_fused"),
                         (dict(score_sharded=True), "score_sharded"),
                         (dict(deep_sharded=True), "deep_sharded"),
                         (dict(fused_embed="require"), "fused_embed")]:
        with pytest.raises(ValueError, match=match):
            parallel.make_field_ffm_sharded_body(ffm, TrainConfig(**lever),
                                                 mesh)
    fm = models.FieldFMSpec(num_features=F * BK, num_fields=F, bucket=BK,
                            rank=K)
    with pytest.raises(ValueError, match="deep_sharded"):
        parallel.make_field_sharded_sgd_body(fm, TrainConfig(
            deep_sharded=True), mesh)
    with pytest.raises(ValueError, match="collective_dtype"):
        parallel.make_field_sharded_sgd_body(fm, TrainConfig(
            collective_dtype="float16"), mesh)
    with pytest.raises(ValueError, match="collective_dtype"):
        parallel.make_parallel_train_step(
            models.FMSpec(num_features=8, rank=2),
            TrainConfig(collective_dtype="bfloat16"),
            parallel.make_mesh(device="cpu"))


@pytest.mark.parametrize("model,kw", [
    ("fm", dict(cap=12288, device_aux=True)),
    ("fm", dict(psum_dtype="bfloat16")),
    ("ffm", dict(n_row=2)),
    ("deepfm", dict(deep_sharded=True)),
    ("deepfm", dict(n_row=2, cap=16384))])
def test_projection_counts_equal_the_reference(model, kw):
    """The per-rank counts are the reference's, term for term; the time
    model takes its time inputs as arguments with no default."""
    from fm_spark_tpu.parallel import projection as jproj
    from fm_spark_tpu_torch.parallel import projection as pproj

    args = (131072, 39, 64, 4)
    assert (pproj.field_sharded_costs(*args, model=model, **kw)
            == jproj.field_sharded_costs(*args, model=model, **kw))
    times = dict(dispatch_ms=2.5, replicated_score_ms_per_128k=2.0)
    got = pproj.project_aggregate(1e6, *args, model=model, link_gbps=100.0,
                                  **times, **kw)
    want = jproj.project_aggregate(1e6, *args, model=model, ici_gbps=100.0,
                                   **times, **kw)
    assert got["per_chip"] == want["per_chip"]
    assert got["t_projected_ms"] == want["t_projected_ms"]
    with pytest.raises(TypeError):
        pproj.project_aggregate(1e6, *args, model=model)


def test_precompile_and_eval_on_the_sharded_layout():
    """``precompile_field_sharded_step`` gives the step (nothing is
    captured on the CPU) and the sharded eval equals ``evaluate_params``
    of the gathered tables at a mesh of one."""
    from fm_spark_tpu_torch.train import evaluate_params

    spec = models.FieldFMSpec(num_features=F * BK, num_fields=F, bucket=BK,
                              rank=K, init_std=0.1)
    mesh = parallel.make_field_mesh(device="cpu")
    canonical = spec.init(torch.Generator().manual_seed(0), device="cpu")
    local = parallel.shard_field_params(
        parallel.stack_field_params(spec, canonical, 1), mesh)
    step = parallel.precompile_field_sharded_step(
        spec, TrainConfig(compact_device=True, compact_cap=B,
                          sparse_update="dedup"), mesh, B, params=local)
    assert step.captured.capture_s == []
    with pytest.raises(ValueError, match="host-built aux"):
        parallel.precompile_field_sharded_step(
            spec, TrainConfig(host_dedup=True, compact_cap=B,
                              sparse_update="dedup"), mesh, B, params=local)
    rng = np.random.default_rng(3)
    batches = [((rng.zipf(1.3, (B, F)) % BK).astype(np.int32),
                rng.uniform(0.5, 1.5, (B, F)).astype(np.float32),
                rng.integers(0, 2, B).astype(np.float32),
                np.ones(B, np.float32)) for _ in range(2)]
    got = parallel.evaluate_field_sharded(spec, mesh, local, batches)
    want = evaluate_params(spec, canonical, batches)
    for key in ("auc", "logloss", "count"):
        assert got[key] == pytest.approx(want[key], rel=1e-6), key
    # The dense strategies' warm start and eval on a (data, feat) mesh.
    flat = models.FMSpec(num_features=64, rank=4, init_std=0.1)
    dmesh = parallel.make_mesh(device="cpu")
    fp = parallel.shard_params(flat.init(torch.Generator().manual_seed(1),
                                         device="cpu"), dmesh, flat, "row")
    cfg = TrainConfig()
    from fm_spark_tpu_torch.train import make_optimizer

    dstep = parallel.precompile_parallel_train_step(
        flat, cfg, dmesh, "row", batch_size=B, nnz=3, params=fp,
        opt_state=make_optimizer(cfg).init(fp))
    assert dstep.captured.capture_s == []
    ids = rng.integers(0, 64, (B, 3)).astype(np.int32)
    fb = (ids, np.ones((B, 3), np.float32),
          rng.integers(0, 2, B).astype(np.float32), np.ones(B, np.float32))
    from fm_spark_tpu_torch.utils import metrics as metrics_lib

    ms = parallel.make_parallel_eval_step(flat, dmesh, "row")(
        fp, metrics_lib.init_metrics(), *parallel.shard_batch(fb, dmesh))
    want = evaluate_params(flat, fp, [fb])
    assert metrics_lib.finalize_metrics(ms)["logloss"] == pytest.approx(
        want["logloss"], rel=1e-6)


@pytest.mark.parametrize("family", ["fm", "deepfm"])
def test_sharded_roll_equals_the_steps(family):
    """The sharded roll (``steps_per_call``) of 3 steps in calls of 2 and
    1 equals 3 single sharded steps bit for bit, a FieldDeepFM's Adam
    state carried through."""
    from fm_spark_tpu_torch.parallel import deepfm_step

    kw = dict(num_features=F * BK, num_fields=F, bucket=BK, rank=K,
              init_std=0.1)
    spec = (models.FieldDeepFMSpec(mlp_dims=(8,), **kw) if family == "deepfm"
            else models.FieldFMSpec(**kw))
    cfg = TrainConfig(sparse_update="dedup", compact_device=True,
                      compact_cap=B, optimizer="adam" if family == "deepfm"
                      else "sgd")
    mesh = parallel.make_field_mesh(device="cpu")
    canonical = spec.init(torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(4)
    batches = [[torch.from_numpy(a) for a in (
        (rng.zipf(1.3, (B, F)) % BK).astype(np.int32),
        rng.uniform(0.5, 1.5, (B, F)).astype(np.float32),
        rng.integers(0, 2, B).astype(np.float32), np.ones(B, np.float32))]
        for _ in range(3)]
    stacked = [torch.stack([b[j] for b in batches]) for j in range(4)]
    if family == "deepfm":
        shard = deepfm_step.shard_field_deepfm_params
        stack = deepfm_step.stack_field_deepfm_params
        p1, p2 = (shard(stack(spec, canonical, 1), mesh) for _ in range(2))
        one = deepfm_step.make_field_deepfm_sharded_step(spec, cfg, mesh)
        roll = deepfm_step.make_field_deepfm_sharded_multistep(spec, cfg,
                                                               mesh, 2)
        o1, o2 = one.init_opt_state(p1), roll.init_opt_state(p2)
        for i, b in enumerate(batches):
            _, _, l1 = one(p1, o1, i, *b)
        roll(p2, o2, 0, 2, *[t[:2] for t in stacked])
        _, _, l2 = roll(p2, o2, 2, 1, *[t[2:] for t in stacked])
        assert torch.equal(o1["mu"]["mlp"][0]["kernel"],
                           o2["mu"]["mlp"][0]["kernel"])
    else:
        p1, p2 = (parallel.shard_field_params(
            parallel.stack_field_params(spec, canonical, 1), mesh)
            for _ in range(2))
        one = parallel.make_field_sharded_sgd_step(spec, cfg, mesh)
        roll = parallel.make_field_sharded_multistep(spec, cfg, mesh, 2)
        for i, b in enumerate(batches):
            _, l1 = one(p1, i, *b)
        roll(p2, 0, 2, *[t[:2] for t in stacked])
        _, l2 = roll(p2, 2, 1, *[t[2:] for t in stacked])
    assert torch.equal(l1, l2)
    assert torch.equal(p1["vw"], p2["vw"])
