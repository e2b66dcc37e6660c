"""The port's checkpoint chain and resumable training against the JAX
package's (mirroring ``tests/test_checkpoint.py`` and
``tests/test_checkpoint_chain.py`` where this slice ports them).

- The chain: a round trip keeps bf16 bits; None on a fresh dir; the
  walk-back past flipped bytes, a truncated save and a missing manifest,
  each journaled; ``CheckpointChainBroken`` when nothing verifies; an
  explicit step failing loudly; tombstones honoured; ``max_to_keep``; a
  save's snapshot taken before the next step writes the params; a failed
  write raising at the next boundary; a FieldDeepFM's nested params and
  Adam state saved beside them (``opt/``) and restored bit for bit, and
  a chain without optimizer state restoring an empty one.
- The chain's writers: ``demote`` (tombstone, then the pointer
  republished; idempotent), ``demote_newer_than`` (one atomic range
  stone), an explicit restore of a demoted step refused, a crash between
  the tombstone and the pointer (the ``ckpt_demote`` fault point patched
  to raise) recovered by the next demotion, ENOSPC on a chain file
  running the emergency GC once (tombstoned steps, manifests of steps
  that are gone, ``.tmp`` leftovers; never ``last_good``'s step) and
  retrying once, and a second ENOSPC raising. Across packages: the
  port's tombstones veto the same steps under JAX's reader, and JAX's
  stones copied into a port chain veto the same steps in the port's
  ``ChainFollower``.
- Training: kill-and-resume equals the uninterrupted run bit for bit
  (FieldFM compact bf16 ``dedup_sr`` with the host aux at
  ``steps_per_call`` 1 and 2, and FieldFFM); the preemption flush; a
  poisoned ``'error'`` run saves nothing.
- Both CLIs: ``preprocess`` → ``train --data <packed> --checkpoint-dir``
  → stop → resume → ``eval --data``. The resumed steps equal JAX's
  jitted step replayed from the port's checkpoint, its cursor restored
  into JAX's ``PackedBatches``: bit for bit in the bf16 ``dedup_sr``
  form (JAX compiled with ``xla_allow_excess_precision`` off, as
  ``tests/test_torch_capture.py``; ``w0``, a float32 sum over the batch
  in another order, within ``rtol=1e-6``), within the reference's fp32
  tolerances in the fp32 form.
"""

import dataclasses
import errno
import json
import os
import shutil
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import cli as jcli
from fm_spark_tpu import configs as jconfigs
from fm_spark_tpu import sparse as jsparse
from fm_spark_tpu import train as jtrain
from fm_spark_tpu.data import DedupAuxBatches as JDedupAuxBatches
from fm_spark_tpu.data import criteo as jcriteo
from fm_spark_tpu.data import packed as jpacked
from fm_spark_tpu_torch import data, models
from fm_spark_tpu_torch.checkpoint import (CheckpointChainBroken,
                                           Checkpointer, CheckpointIOError,
                                           PreemptionGuard, copy_into)
from fm_spark_tpu_torch.train import TrainConfig, fit_field_sparse
from fm_spark_tpu_torch.utils.logging import EventLog

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B, F, BUCKET, CAP = 128, 4, 32, 64


def _params(pd="bfloat16", seed=0):
    spec = models.FieldFMSpec(num_features=F * BUCKET, rank=4, num_fields=F,
                              bucket=BUCKET, param_dtype=pd, init_std=0.1)
    return spec, spec.init(torch.Generator().manual_seed(seed), device="cpu")


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


def _same(a, b):
    return (torch.equal(_bits(a["w0"]), _bits(b["w0"]))
            and len(a["vw"]) == len(b["vw"])
            and all(torch.equal(_bits(x), _bits(y))
                    for x, y in zip(a["vw"], b["vw"])))


def _save_two(ckdir, params):
    ck = Checkpointer(str(ckdir))
    ck.save(1, params, {"epoch": 0}, {"loss_history": [0.9]})
    ck.save(2, params, {"epoch": 1}, {"loss_history": [0.9, 0.8]})
    ck.close()


def _array_files(ckdir, step):
    d = os.path.join(str(ckdir), str(step))
    return [os.path.join(d, "w0.npy")] + [
        os.path.join(d, "vw", f"{f}.npy") for f in range(F)]


# --------------------------------------------------------------- chain


def test_round_trip_keeps_the_bf16_bits(tmp_path):
    _, params = _params()
    journal = EventLog()
    ck = Checkpointer(str(tmp_path), journal=journal)
    ck.save(3, params, {"epoch": 0, "index": 5}, {"note": "x"})
    ck.wait()
    assert ck.last_good_step() == 3 and ck.latest_step() == 3
    state = json.loads((tmp_path / "3" / "state.json").read_text())
    assert state["layout"] == "canonical" and state["step"] == 3
    assert state["arrays"]["vw/0"]["dtype"] == "bfloat16"
    stored = np.load(tmp_path / "3" / "vw" / "0.npy")
    assert stored.dtype == np.uint16             # the bits, not a widening
    np.testing.assert_array_equal(stored,
                                  params["vw"][0].view(torch.int16).numpy()
                                  .view(np.uint16))
    manifest = json.loads((tmp_path / "manifests" / "3.json").read_text())
    assert manifest["step"] == 3 and manifest["meta_crc"]
    assert manifest["checksums"]["vw/0"].startswith("bfloat16:(32, 5):")
    assert [e["event"] for e in journal.records] == ["checkpoint_verified"]
    _, fresh = _params(seed=9)
    got = Checkpointer(str(tmp_path)).restore(fresh)
    assert got["step"] == 3 and got["pipeline"] == {"epoch": 0, "index": 5}
    assert got["extra"] == {"note": "x"}
    assert _same(got["params"], params)
    copy_into(fresh, got["params"])
    assert _same(fresh, params)
    with pytest.raises(ValueError, match="float32"):
        copy_into(_params("float32")[1], got["params"])


def test_optimizer_state_saves_beside_the_params_and_restores(tmp_path):
    """A FieldDeepFM's nested params and Adam state (``opt/`` keys) round
    trip bit for bit and copy into fresh tensors; a chain saved without
    optimizer state (the SGD families') restores an empty one."""
    from fm_spark_tpu_torch.models.io import flatten
    from fm_spark_tpu_torch.train import make_optimizer

    spec = models.FieldDeepFMSpec(num_features=F * BUCKET, rank=4,
                                  num_fields=F, bucket=BUCKET,
                                  mlp_dims=(8, 8), param_dtype="bfloat16")
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    opt = make_optimizer(TrainConfig(optimizer="adam"))
    state = opt.init({"w0": params["w0"], "mlp": params["mlp"]})
    state["count"].fill_(7)
    state["mu"]["mlp"][1]["kernel"].normal_()
    ck = Checkpointer(str(tmp_path / "deep"))
    ck.save(4, params, {"epoch": 0}, opt_state=state)
    ck.wait()
    assert (tmp_path / "deep" / "4" / "opt" / "mu" / "mlp" / "1"
            / "kernel.npy").exists()
    fresh = spec.init(torch.Generator().manual_seed(1), device="cpu")
    fresh_state = opt.init({"w0": fresh["w0"], "mlp": fresh["mlp"]})
    got = Checkpointer(str(tmp_path / "deep")).restore(fresh)
    copy_into(fresh, got["params"])
    copy_into(fresh_state, got["opt_state"])
    for a, b in ((params, fresh), (state, fresh_state)):
        fa, fb = flatten(a), flatten(b)
        assert sorted(fa) == sorted(fb)
        assert all(torch.equal(_bits(fa[k]), _bits(fb[k])) for k in fa)
    assert int(fresh_state["count"]) == 7
    with pytest.raises(ValueError, match="checkpoint holds"):
        copy_into(opt.init({"w0": fresh["w0"]}), got["opt_state"])
    _, fm_params = _params()
    ck = Checkpointer(str(tmp_path / "fm"))
    ck.save(1, fm_params)
    ck.wait()
    restored = Checkpointer(str(tmp_path / "fm")).restore(fm_params)
    assert restored["opt_state"] == {}
    copy_into({}, restored["opt_state"])


def test_restore_none_on_a_fresh_dir(tmp_path):
    _, params = _params()
    assert Checkpointer(str(tmp_path / "empty")).restore(params) is None


@pytest.mark.parametrize("damage", ["flip", "truncate", "manifest"])
def test_restore_walks_back_past_a_damaged_newest_step(tmp_path, damage):
    _, params = _params()
    _save_two(tmp_path, params)
    if damage == "manifest":
        # A torn save: step 2's data renamed into place, then the crash,
        # before its manifest and the pointer's advance.
        os.unlink(tmp_path / "manifests" / "2.json")
        (tmp_path / "last_good.json").write_text('{"step": 1}')
    for p in _array_files(tmp_path, 2) if damage != "manifest" else []:
        with open(p, "r+b") as f:
            if damage == "truncate":
                f.truncate(max(os.path.getsize(p) // 2, 1))
            else:
                f.seek(-4, os.SEEK_END)
                f.write(b"\xde\xad\xbe\xef")
    journal = EventLog()
    got = Checkpointer(str(tmp_path), journal=journal).restore(params)
    assert got["step"] == 1 and got["extra"]["loss_history"] == [0.9]
    events = [e["event"] for e in journal.records]
    assert events == [{"flip": "checkpoint_corrupt",
                       "truncate": "checkpoint_unreadable",
                       "manifest": "checkpoint_unverified_skipped"}[damage],
                      "checkpoint_walked_back", "checkpoint_stale_removed"]
    # The damaged step is gone and the pointer names the restored one.
    ck = Checkpointer(str(tmp_path))
    assert ck.all_steps() == [1] and ck.last_good_step() == 1
    assert sorted(os.listdir(tmp_path / "manifests")) == ["1.json"]


def test_chain_broken_when_nothing_verifies(tmp_path):
    _, params = _params()
    ck = Checkpointer(str(tmp_path))
    ck.save(1, params)
    ck.wait()
    with open(_array_files(tmp_path, 1)[1], "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(CheckpointChainBroken, match="none passed"):
        Checkpointer(str(tmp_path)).restore(params)


def test_explicit_step_restore_fails_loudly(tmp_path):
    _, params = _params()
    _save_two(tmp_path, params)
    ck = Checkpointer(str(tmp_path))
    assert ck.restore(params, step=1)["step"] == 1
    with open(_array_files(tmp_path, 1)[0], "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(CheckpointChainBroken, match="checksums"):
        ck.restore(params, step=1)
    with pytest.raises(FileNotFoundError):
        ck.restore(params, step=7)
    assert ck.restore(params)["step"] == 2          # the walk-back is fine


@pytest.mark.parametrize("stone", ["2.json", "range_1_2.json"])
def test_a_tombstoned_step_is_skipped(tmp_path, stone):
    _, params = _params()
    _save_two(tmp_path, params)
    os.makedirs(tmp_path / "tombstones")
    (tmp_path / "tombstones" / stone).write_text('{"step": 2}')
    journal = EventLog()
    ck = Checkpointer(str(tmp_path), journal=journal)
    assert ck.tombstoned_steps() == {2} and ck.is_tombstoned(2)
    assert ck.restore(params)["step"] == 1
    assert journal.records[0]["event"] == "checkpoint_demoted_skipped"
    with pytest.raises(CheckpointChainBroken, match="tombstone"):
        ck.restore(params, step=2)
    # The vetoed step stays, the pointer moves to the restored one, and a
    # resumed run's save of the vetoed step is refused with an event.
    assert ck.all_steps() == [1, 2] and ck.last_good_step() == 1
    assert ck.save(2, params) is False
    assert journal.records[-1] == {**journal.records[-1],
                                   "event": "checkpoint_save_skipped",
                                   "step": 2, "reason": "tombstoned"}
    # A vetoed step is not the chain's frontier: step 3 saves unforced.
    assert ck.save(3, params) is True
    ck.wait()
    assert ck.restore(params)["step"] == 3 and ck.last_good_step() == 3


def test_max_to_keep_keeps_the_newest_steps(tmp_path):
    _, params = _params()
    ck = Checkpointer(str(tmp_path), save_every=2, max_to_keep=2)
    for step in range(1, 8):
        ck.maybe_save(step, params)
    ck.save(7, params, force=True)
    ck.close()
    assert ck.all_steps() == [6, 7] and ck.last_good_step() == 7
    assert sorted(os.listdir(tmp_path / "manifests")) == ["6.json", "7.json"]
    assert ck.save(5, params) is False                # behind the chain
    assert ck.due_window(6, 3) and not ck.due_window(7, 1)


def test_the_snapshot_is_taken_before_the_next_step(tmp_path):
    _, params = _params("float32")
    want = {"w0": params["w0"].clone(), "vw": [t.clone() for t in params["vw"]]}
    ck = Checkpointer(str(tmp_path))
    ck.save(1, params)
    for t in params["vw"]:          # the next step writes in place at once
        t.add_(1.0)
    ck.close()
    assert _same(Checkpointer(str(tmp_path)).restore(params)["params"], want)


def test_a_failed_write_raises_at_the_next_boundary(tmp_path, monkeypatch):
    _, params = _params()

    def broken(*a, **k):
        raise OSError(28, "No space left on device")
    monkeypatch.setattr(np.lib.format, "write_array", broken)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, params)
    with pytest.raises(CheckpointIOError) as err:
        ck.wait()
    assert err.value.errno == 28
    assert os.listdir(tmp_path) == []            # no step, no temporary
    ck.close()


# ------------------------------------------------------------ training


def _problem(family="fm"):
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET,
              param_dtype="bfloat16", compute_dtype="bfloat16",
              init_std=0.1)
    spec = (models.FieldFFMSpec(rank=3, **kw) if family == "ffm"
            else models.FieldFMSpec(rank=4, **kw))
    lever = (dict(sel_blocked=True, fused_embed="require") if family == "ffm"
             else dict(fused_embed="require"))
    cfg = TrainConfig(num_steps=7, batch_size=B, learning_rate=0.1,
                      lr_schedule="inv_sqrt", sparse_update="dedup_sr",
                      host_dedup=True, compact_cap=CAP, seed=2, **lever)
    rng = np.random.default_rng(0)
    n = 5 * B // 2
    ids = (rng.zipf(1.3, (n, F)) % BUCKET).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (n, F)).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.float32)
    return spec, cfg, (ids, vals, labels)


def _fit(spec, cfg, arrays, ckdir=None, steps=None, spc=1, source=None,
         guard=None):
    stats = {}
    ck = Checkpointer(str(ckdir), save_every=2) if ckdir else None
    params = fit_field_sparse(
        spec, dataclasses.replace(cfg, num_steps=steps or cfg.num_steps),
        source or data.Batches(*arrays, B, seed=7), device="cpu",
        steps_per_call=spc, stats=stats, checkpointer=ck,
        preemption_guard=guard)
    return params, stats


@pytest.mark.parametrize("family, spc, stop", [
    ("fm", 1, 3), ("fm", 2, 4), ("fm", 2, 3), ("ffm", 1, 4)])
def test_kill_and_resume_equals_uninterrupted(tmp_path, family, spc, stop):
    spec, cfg, arrays = _problem(family)
    golden, s_gold = _fit(spec, cfg, arrays, tmp_path / "golden", spc=spc)
    _, s_part = _fit(spec, cfg, arrays, tmp_path / "ck", steps=stop, spc=spc)
    assert s_part["end"] == stop and s_part["resumed"] is None
    resumed, s_res = _fit(spec, cfg, arrays, tmp_path / "ck", spc=spc)
    assert s_res["start"] == stop and s_res["resumed"]["step"] == stop
    assert _same(golden, resumed)
    # The per-call losses from the resume point on: the same calls end at
    # the same steps when ``stop`` is on the stride.
    if stop % spc == 0:
        n = len(s_res["loss"])
        assert s_res["loss"] == s_gold["loss"][-n:]
    # The saved cursor is that of the last batch a step consumed, not of
    # the prefetcher's read-ahead.
    cursor = data.Batches(*arrays, B, seed=7)
    for _ in range(stop):
        cursor.next_batch()
    assert s_res["resumed"]["pipeline"] == cursor.state()
    # Without a checkpointer the same run trains the same bits.
    plain, _ = _fit(spec, cfg, arrays, spc=spc)
    assert _same(plain, golden)


class _TripWire:
    """A batch source that SIGTERMs this process when it hands out its
    ``at``-th batch."""

    def __init__(self, inner, at):
        self.inner, self.at, self.n = inner, at, 0

    def state(self):
        return self.inner.state()

    def restore(self, state):
        self.inner.restore(state)

    def next_batch(self):
        self.n += 1
        if self.n == self.at:
            os.kill(os.getpid(), signal.SIGTERM)
        return self.inner.next_batch()


def test_the_preemption_guard_flushes_and_resumes(tmp_path):
    spec, cfg, arrays = _problem()
    golden, _ = _fit(spec, cfg, arrays)
    with PreemptionGuard() as guard:
        _, stats = _fit(spec, cfg, arrays, tmp_path, guard=guard,
                        source=_TripWire(data.Batches(*arrays, B, seed=7), 4))
    stopped = stats["end"]
    assert 1 <= stopped < cfg.num_steps
    ck = Checkpointer(str(tmp_path))
    assert ck.latest_step() == stopped == ck.last_good_step()
    resumed, stats = _fit(spec, cfg, arrays, tmp_path)
    assert stats["start"] == stopped
    assert _same(resumed, golden)


def test_a_poisoned_error_run_saves_nothing(tmp_path):
    spec, cfg, arrays = _problem()
    cfg = dataclasses.replace(cfg, host_dedup=False, compact_device=True,
                              compact_cap=4, fused_embed="off")
    with pytest.raises(RuntimeError, match="poisoned"):
        _fit(spec, cfg, arrays, tmp_path)
    assert Checkpointer(str(tmp_path)).all_steps() == []


# --------------------------------------------------------- both CLIs


def _jit_exact(fn):
    compiled = []

    def call(*args):
        if not compiled:
            compiled.append(jax.jit(fn).lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False}))
        return compiled[0](*args)

    return call


def _port_cli(*args):
    proc = subprocess.run([sys.executable, "-m", "fm_spark_tpu_torch", *args],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=600, env={**os.environ,
                                            "OMP_NUM_THREADS": "1"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return [json.loads(x) for x in proc.stdout.splitlines()
            if x.startswith("{")]


def _chain_params(ckdir, step):
    d = os.path.join(ckdir, str(step))
    state = json.loads(open(os.path.join(d, "state.json")).read())
    arrays = {}
    for key, info in state["arrays"].items():
        arr = np.load(os.path.join(d, info["file"]))
        arrays[key] = (arr.view(jnp.bfloat16) if info["dtype"] == "bfloat16"
                       else arr)
    return arrays, state["pipeline"]


@pytest.mark.parametrize("form", ["bf16-dedup_sr", "fp32-dedup"])
def test_cli_train_resume_and_eval_match_jax(tmp_path, form):
    bucket = 64
    tsv = str(tmp_path / "day.tsv")
    jcriteo.synthesize_tsv(tsv, 1500, seed=4)
    packed = str(tmp_path / "packed")
    _port_cli("preprocess", "--config", "criteo1tb_fm_r64", "--bucket",
              str(bucket), "--input", tsv, "--out-dir", packed)
    jcriteo.preprocess(tsv, str(tmp_path / "jraw"), bucket)
    jpacked.shuffle_packed(str(tmp_path / "jraw"), str(tmp_path / "jpacked"),
                           seed=0)
    for name in ("ids.bin", "labels.bin", "meta.json"):
        with open(os.path.join(packed, name), "rb") as a, \
                open(str(tmp_path / "jpacked" / name), "rb") as b:
            assert a.read() == b.read()
    dt = "bfloat16" if form.startswith("bf16") else "float32"
    mode = "dedup_sr" if form.endswith("dedup_sr") else "dedup"
    train = ["train", "--config", "criteo1tb_fm_r64", "--bucket",
             str(bucket), "--data", packed, "--batch-size", "256",
             "--param-dtype", dt, "--compute-dtype", dt, "--sparse-update",
             mode, "--host-dedup", "--compact-cap", "128", "--fused-embed",
             "require", "--device", "cpu", "--checkpoint-every", "2"]
    full = _port_cli(*train, "--steps", "6", "--checkpoint-dir",
                     str(tmp_path / "ck1"), "--model-out",
                     str(tmp_path / "m1"))
    _port_cli(*train, "--steps", "3", "--checkpoint-dir", str(tmp_path / "ck2"))
    rest = _port_cli(*train, "--steps", "6", "--checkpoint-dir",
                     str(tmp_path / "ck2"), "--model-out",
                     str(tmp_path / "m2"))
    lf = {x["step"]: x["loss"] for x in full if "loss" in x}
    lr = {x["step"]: x["loss"] for x in rest if "loss" in x}
    assert sorted(lr) == [4, 5, 6] and all(lr[k] == lf[k] for k in lr)
    with np.load(tmp_path / "m1" / "params.npz") as a, \
            np.load(tmp_path / "m2" / "params.npz") as b:
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    resumed = next(x["resumed"] for x in rest if "resumed" in x)
    assert resumed["step"] == 3

    # JAX replays steps 4..6 from the port's step-3 checkpoint.
    jcfg = jconfigs.get_config("criteo1tb_fm_r64", bucket=bucket,
                               param_dtype=dt, compute_dtype=dt)
    jspec = jcfg.spec()
    tconfig = jcfg.train_config(batch_size=256, sparse_update=mode,
                                host_dedup=True, compact_cap=128,
                                fused_embed="require")
    flat, cursor = _chain_params(str(tmp_path / "ck2"), 3)
    assert cursor == resumed["pipeline"]
    shutil.rmtree(tmp_path / "ck2" / "6")        # the port's own final step
    jp = {"w0": jnp.asarray(flat["w0"]),
          "vw": [jnp.asarray(flat[f"vw/{f}"]) for f in range(jspec.num_fields)]}
    jds = jpacked.PackedDataset(packed)
    cut = int(len(jds) * 0.8)
    source = jpacked.PackedBatches(jds, 256, seed=jcfg.seed,
                                   row_range=(0, cut), bucket=bucket)
    source.restore(cursor)
    batches = JDedupAuxBatches(source, cap=128)
    step = _jit_exact(jsparse.make_field_sparse_sgd_body(jspec, tconfig))
    for i in (3, 4, 5):
        b = batches.next_batch()
        jp, jl = step(jp, jnp.int32(i), *map(jnp.asarray, b[:4]),
                      tuple(map(jnp.asarray, b[4])))
        if dt == "bfloat16":
            assert float(jl) == lr[i + 1]
        else:
            assert abs(float(jl) - lr[i + 1]) < 1e-6
    with np.load(tmp_path / "m2" / "params.npz") as got:
        for f in range(jspec.num_fields):
            want = np.asarray(jp["vw"][f].astype(jnp.float32))
            if dt == "bfloat16":
                np.testing.assert_array_equal(got[f"vw/{f}"], want)
            else:
                np.testing.assert_allclose(got[f"vw/{f}"], want, rtol=0,
                                           atol=1e-5)
        np.testing.assert_allclose(float(got["w0"]), float(jp["w0"]),
                                   rtol=1e-6, atol=1e-8)

    # eval --data: the port's CLI on its model against JAX's evaluation
    # of the same params over the same packed rows.
    got = _port_cli("eval", "--model", str(tmp_path / "m2"), "--config",
                    "criteo1tb_fm_r64", "--bucket", str(bucket), "--data",
                    packed, "--batch-size", "512", "--device", "cpu")[-1]
    want = jtrain.evaluate_params(
        jspec, jp, jcli.iter_packed_once(jds, 512, bucket=bucket))
    assert got["count"] == want["count"] == 1500
    tol = 5e-3 if dt == "bfloat16" else 1e-5      # bf16 scores: fp32 vs bf16 sums
    assert got["logloss"] == pytest.approx(want["logloss"], abs=tol)
    assert got["auc"] == pytest.approx(want["auc"], abs=tol)


def test_cli_trains_from_a_text_file_and_predicts_from_a_packed_dir(tmp_path):
    tsv = str(tmp_path / "day.tsv")
    jcriteo.synthesize_tsv(tsv, 700, seed=6)
    common = ["--config", "criteo1tb_fm_r64", "--bucket", "64"]
    lines = _port_cli("train", *common, "--data", tsv, "--steps", "2",
                      "--batch-size", "128", "--device", "cpu",
                      "--model-out", str(tmp_path / "m"))
    assert [x["step"] for x in lines if "loss" in x] == [1, 2]
    assert next(x["eval"] for x in lines if "eval" in x)["count"] == 140.0
    got = _port_cli("eval", "--model", str(tmp_path / "m"), *common,
                    "--data", tsv, "--device", "cpu")[-1]
    assert got["count"] == 700.0
    _port_cli("preprocess", *common, "--no-shuffle", "--input", tsv,
              "--out-dir", str(tmp_path / "packed"))
    # The same rows through the packed dir: the same metrics.
    assert _port_cli("eval", "--model", str(tmp_path / "m"), *common,
                     "--data", str(tmp_path / "packed"), "--device",
                     "cpu")[-1] == got
    out = tmp_path / "preds.txt"
    _port_cli("predict", "--model", str(tmp_path / "m"), *common, "--data",
              str(tmp_path / "packed"), "--batch-size", "256", "--device",
              "cpu", "--out", str(out))
    preds = np.loadtxt(out)
    assert preds.shape == (700,) and ((preds > 0) & (preds < 1)).all()


def test_durable_writes_are_atomic_and_failures_counted(tmp_path):
    from fm_spark_tpu.utils import durable as jdurable
    from fm_spark_tpu_torch.utils import durable

    durable.reset_failure_counts()
    path = str(tmp_path / "x.json")
    assert durable.atomic_write_json(path, {"step": 3}, sync_dir=True)
    assert os.listdir(tmp_path) == ["x.json"]
    assert durable.read_json(path) == jdurable.read_json(path) == {"step": 3}
    missing = str(tmp_path / "no" / "x.json")
    with pytest.raises(OSError):
        durable.atomic_write_json(missing, {}, path_class="ckpt")
    assert durable.atomic_write_text(missing, "", best_effort=True) is False
    assert durable.io_failure_counts() == {"total": 2, "ckpt": 1,
                                           "unscoped": 1, "best_effort": 1}
    durable.reset_failure_counts()


def test_a_resume_past_a_corrupt_step_writes_that_step_anew(tmp_path):
    spec, cfg, arrays = _problem()
    cfg = dataclasses.replace(cfg, num_steps=4)
    golden, _ = _fit(spec, cfg, arrays)
    _fit(spec, cfg, arrays, tmp_path)                # saves 2 and 4
    with open(os.path.join(str(tmp_path), "4", "vw", "0.npy"), "r+b") as f:
        f.seek(-4, os.SEEK_END)
        f.write(b"\xde\xad\xbe\xef")
    resumed, stats = _fit(spec, cfg, arrays, tmp_path)
    assert stats["start"] == 2 and _same(resumed, golden)
    # Step 4 is the resumed run's now, and verifies.
    got = Checkpointer(str(tmp_path)).restore(resumed)
    assert got["step"] == 4 and _same(got["params"], golden)


@pytest.mark.parametrize("damage", [("flip", "truncate"),
                                    ("flip", "manifest")])
def test_the_resumed_saves_rewrite_every_stale_step(tmp_path, damage):
    """Steps 4 and 6 both damaged (4 first): the restore walks back to 2,
    and the resumed run's cadence saves of 4 and 6 are written anew and
    verify."""
    _, params = _params("float32")
    ck = Checkpointer(str(tmp_path))
    for step in (2, 4, 6):
        ck.save(step, params)
    ck.close()
    for step, how in zip((4, 6), damage):
        if how == "manifest":
            os.unlink(tmp_path / "manifests" / f"{step}.json")
            (tmp_path / "last_good.json").write_text('{"step": 4}')
            continue
        for p in _array_files(tmp_path, step):
            with open(p, "r+b") as f:
                if how == "truncate":
                    f.truncate(max(os.path.getsize(p) // 2, 1))
                else:
                    f.seek(-4, os.SEEK_END)
                    f.write(b"\xde\xad\xbe\xef")
    journal = EventLog()
    ck = Checkpointer(str(tmp_path), save_every=2, journal=journal)
    assert ck.restore(params)["step"] == 2
    assert journal.records[-1]["event"] == "checkpoint_stale_removed"
    assert sorted(journal.records[-1]["steps"]) == [4, 6]
    assert ck.all_steps() == [2] and ck.last_good_step() == 2
    for t in params["vw"]:
        t.add_(1.0)
    want = {"w0": params["w0"].clone(), "vw": [t.clone() for t in params["vw"]]}
    assert ck.maybe_save(4, params) is True
    assert ck.maybe_save(6, params) is True
    ck.close()
    assert ck.all_steps() == [2, 4, 6] and ck.last_good_step() == 6
    assert not [e for e in journal.records
                if e["event"] == "checkpoint_save_skipped"]
    for step in (4, 6):
        got = Checkpointer(str(tmp_path)).restore(params, step=step)
        assert _same(got["params"], want)


# ------------------------------------------ demotion and the emergency GC
#
# The counterparts of tests/test_checkpoint_chain.py's demotion drills,
# the SIGKILL-mid-demotion drill among them (an injected exit at
# ckpt_demote, planned through FM_SPARK_FAULTS in a subprocess).


def _demo_chain(ckdir, steps=(1, 2, 3), journal=None):
    _, params = _params("float32")
    ck = Checkpointer(str(ckdir), max_to_keep=10, journal=journal)
    for s in steps:
        ck.save(s, {"w0": params["w0"] * s, "vw": [t * s for t in params["vw"]]},
                {"epoch": s}, force=True)
    ck.wait()
    return ck, params


def test_demote_tombstones_and_republishes_last_good(tmp_path):
    journal = EventLog()
    ck, params = _demo_chain(tmp_path, journal=journal)
    assert ck.last_good_step() == 3
    assert ck.demote(3, reason="drift verdict") is True
    assert ck.last_good_step() == 2
    assert ck.is_tombstoned(3) and not ck.is_tombstoned(2)
    stone = json.loads((tmp_path / "tombstones" / "3.json").read_text())
    assert stone["step"] == 3 and stone["reason"] == "drift verdict"
    events = [e["event"] for e in journal.records]
    assert events[-2:] == ["generation_demoted", "last_good_republished"]
    assert ck.restore(params)["step"] == 2
    assert ck.demote(3) is False                     # idempotent
    assert ck.all_steps() == [1, 2, 3]               # bytes intact
    ck.close()


def test_demote_newer_than_is_one_atomic_range(tmp_path):
    ck, params = _demo_chain(tmp_path, steps=(1, 2, 3, 4))
    assert ck.demote_newer_than(2, reason="drift day") == [3, 4]
    assert ck.tombstoned_steps() == {3, 4} and ck.last_good_step() == 2
    assert os.listdir(tmp_path / "tombstones") == ["range_2_4.json"]
    stone = json.loads((tmp_path / "tombstones" / "range_2_4.json").read_text())
    assert (stone["newer_than"], stone["through"], stone["steps"]) == (2, 4,
                                                                       [3, 4])
    # Saves after the rollback land past the range and are trusted.
    ck.save(5, params)
    ck.wait()
    assert ck.last_good_step() == 5 and ck.restore(params)["step"] == 5
    assert ck.demote_newer_than(5) == []
    ck.close()


def test_explicit_restore_of_a_demoted_step_refuses(tmp_path):
    ck, params = _demo_chain(tmp_path)
    ck.demote(3, reason="drift")
    with pytest.raises(CheckpointChainBroken, match="tombstone"):
        ck.restore(params, step=3)
    ck.close()


def test_a_crash_between_tombstone_and_pointer_recovers(tmp_path, monkeypatch):
    """The ckpt_demote fault point sits after the tombstone and before the
    republished pointer: the failure leaves a pointer that vouches for
    vetoed steps, readers veto them anyway, and the next demotion repairs
    the pointer."""
    from fm_spark_tpu_torch.checkpoint import ChainFollower
    from fm_spark_tpu_torch.resilience import faults

    ck, params = _demo_chain(tmp_path)

    def crash(point):
        if point == "ckpt_demote":
            raise RuntimeError("killed inside the demotion window")
    monkeypatch.setattr(faults, "inject", crash)
    with pytest.raises(RuntimeError, match="demotion window"):
        ck.demote_newer_than(1, reason="drift")
    monkeypatch.undo()
    assert ck.tombstoned_steps() == {2, 3} and ck.last_good_step() == 3
    assert ChainFollower(str(tmp_path)).restore(params)["step"] == 1
    assert ck.demote_newer_than(1, reason="drift") == []
    assert ck.last_good_step() == 1
    monkeypatch.setattr(faults, "inject", crash)
    with pytest.raises(RuntimeError):
        ck.demote(1)
    monkeypatch.undo()
    assert ck.last_good_step() == 1                  # stale: vouches for 1
    assert ck.demote(1) is False and ck.last_good_step() is None
    assert ChainFollower(str(tmp_path)).restore(params) is None
    ck.close()


_DEMOTE_CHILD = """
import sys
sys.path.insert(0, {repo!r})
from fm_spark_tpu_torch.checkpoint import Checkpointer
Checkpointer({ckdir!r}, max_to_keep=10).demote_newer_than(1, reason="drift")
print("survived")
"""


def test_an_exit_at_ckpt_demote_recovers_in_the_next_process(tmp_path):
    """The planned ``ckpt_demote@1=exit:29`` kills a process inside the
    demotion window (the range tombstone durable, ``last_good`` not yet
    republished): no reader trusts the vetoed steps, and the next
    process's demotion repairs the pointer."""
    from fm_spark_tpu_torch.checkpoint import ChainFollower

    ck, params = _demo_chain(tmp_path / "ck")
    ck.close()
    env = {**os.environ, "FM_SPARK_FAULTS": "ckpt_demote@1=exit:29"}
    proc = subprocess.run(
        [sys.executable, "-c", _DEMOTE_CHILD.format(
            repo=REPO, ckdir=str(tmp_path / "ck"))],
        env=env, capture_output=True, text=True, timeout=240)
    assert proc.returncode == 29 and "survived" not in proc.stdout
    ck = Checkpointer(str(tmp_path / "ck"), max_to_keep=10)
    assert ck.tombstoned_steps() == {2, 3} and ck.last_good_step() == 3
    assert ChainFollower(str(tmp_path / "ck")).restore(params)["step"] == 1
    assert ck.restore(params)["step"] == 1
    assert ck.demote_newer_than(1, reason="drift") == []
    assert ck.last_good_step() == 1
    ck.close()


def test_enospc_runs_the_emergency_gc_once_and_retries(tmp_path, monkeypatch):
    journal = EventLog()
    ck, params = _demo_chain(tmp_path, steps=(1, 2, 3, 4), journal=journal)
    ck.demote_newer_than(2, reason="drift")          # 3 and 4 vetoed
    # The crash window's stale pointer vouches for a vetoed step: that step
    # is never a victim.
    (tmp_path / "last_good.json").write_text('{"step": 4}')
    os.unlink(tmp_path / "manifests" / "1.json")
    shutil.rmtree(tmp_path / "1")
    (tmp_path / "manifests" / "1.json").write_text("{}")   # a step gone
    (tmp_path / "last_good.json.tmp").write_text("torn")
    from fm_spark_tpu_torch.utils import durable

    real = durable.atomic_write_json
    calls = []

    def full_once(path, obj, **kw):
        calls.append(os.path.basename(path))
        if len(calls) == 1:
            raise OSError(errno.ENOSPC, "No space left on device")
        return real(path, obj, **kw)
    monkeypatch.setattr(durable, "atomic_write_json", full_once)
    ck.save(5, params)
    ck.wait()
    assert calls[:2] == ["5.json", "5.json"]         # one retry
    gc = [e for e in journal.records if e["event"] == "ckpt_emergency_gc"]
    assert len(gc) == 1 and gc[0]["steps"] == [3] and gc[0]["manifests"] == [1]
    assert ck.all_steps() == [2, 4, 5] and ck.last_good_step() == 5
    assert sorted(os.listdir(tmp_path / "manifests")) == ["2.json", "4.json",
                                                          "5.json"]
    assert not (tmp_path / "last_good.json.tmp").exists()
    assert ck.restore(params)["step"] == 5
    ck.close()


def test_enospc_twice_raises(tmp_path, monkeypatch):
    ck, params = _demo_chain(tmp_path, steps=(1,))
    from fm_spark_tpu_torch.utils import durable

    def full(path, obj, **kw):
        raise OSError(errno.ENOSPC, "No space left on device")
    monkeypatch.setattr(durable, "atomic_write_json", full)
    with pytest.raises(CheckpointIOError) as err:
        ck.demote(1)
    assert err.value.errno == errno.ENOSPC
    ck.close()


def test_tombstones_veto_the_same_steps_in_both_packages(tmp_path):
    """The port's stones parse to the same vetoed steps under JAX's
    reader; stones JAX's Checkpointer writes, copied into a port chain,
    veto the same steps in the port's ChainFollower."""
    from fm_spark_tpu import checkpoint as jckpt
    from fm_spark_tpu_torch.checkpoint import ChainFollower

    ck, params = _demo_chain(tmp_path / "port", steps=(1, 2, 3, 4, 5))
    ck.demote(5, reason="single")
    ck.demote_newer_than(2, reason="range")
    stones = jckpt._read_tombstones(str(tmp_path / "port" / "tombstones"))
    assert {s for s in range(8) if s in stones} == {3, 4, 5}
    assert ck.tombstoned_steps() == {3, 4, 5}
    ck.close()

    jparams = {"w0": jnp.float32(0.0), "vw": [jnp.zeros((BUCKET, 5))] * F}
    jck = jckpt.Checkpointer(str(tmp_path / "jax"), save_every=1,
                             async_save=False)
    for s in (1, 2, 3, 4, 5):
        jck.save(s, jparams, {}, None, force=True)
    jck.wait()
    jck.demote(5, reason="single")
    jck.demote_newer_than(2, reason="range")
    want = jck.tombstoned_steps()
    jck.close()
    assert want == {3, 4, 5}
    ck, _ = _demo_chain(tmp_path / "copy", steps=(1, 2, 3, 4, 5))
    ck.close()
    shutil.copytree(tmp_path / "jax" / "tombstones", tmp_path / "copy" /
                    "tombstones")
    fol = ChainFollower(str(tmp_path / "copy"))
    assert fol.tombstoned_steps() == want
    assert [s for s in range(8) if fol.is_tombstoned(s)] == [3, 4, 5]
    assert fol.restore(params)["step"] == 2
