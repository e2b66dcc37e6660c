"""The port's hot reload from the checkpoint chain (``serve/reload.py``,
``checkpoint.ChainFollower``) on the CPU, mirroring the reload drills of
``tests/test_serve.py``:

- a hot swap serves the new generation;
- a failed reload (the ``serve_reload`` fault point patched to raise)
  degrades to the old generation and converges on a later poll;
- a demoted tip is refused and the follower converges forward past it;
- a demotion landing between restore and swap is refused;
- a torn ``last_good`` is retried, not raised;
- the follower walks back past a corrupt tip, then reports the chain
  stale;
- the follower never changes the chain (bytes and mtimes);
- a chain of another layout fails the reload;
- a failed swap (a capture that fails on the card) keeps the old
  generation, and the poll thread outlives a failing poll;
- the SIGKILL-mid-reload drill: ``fmtorch serve`` killed by a planned
  ``serve_reload@1=exit:9`` inside its reload attempt leaves the chain
  untouched, and the next follower converges on the newest generation.

Every served answer is held against the JAX package's ``predict`` on the
same numpy parameters at ``rtol=1e-5, atol=1e-6`` (float32 sums in
another order), and against the port's own ``predict`` to within the
CPU sigmoid's ulp (``tests/test_torch_serve.py``).
"""

import hashlib
import json
import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import models as jmodels
from fm_spark_tpu_torch import models, obs
from fm_spark_tpu_torch.checkpoint import ChainFollower, Checkpointer
from fm_spark_tpu_torch.resilience import faults
from fm_spark_tpu_torch.serve import PredictEngine, ReloadFollower
from fm_spark_tpu_torch.utils.logging import EventLog

F, BUCKET, K = 4, 32, 4
KW = dict(num_features=F * BUCKET, rank=K, num_fields=F, bucket=BUCKET)
ULP2 = dict(rtol=2.5e-7, atol=0)


@pytest.fixture(autouse=True)
def _fresh_registry():
    obs.registry().reset()
    yield
    obs.registry().reset()


def _arrays(scale):
    """One generation's parameters as numpy arrays (seeded by ``scale``)."""
    rng = np.random.default_rng(int(scale * 10))
    return {"w0": np.float32(0.1 * scale),
            "vw": [(rng.normal(size=(BUCKET, K + 1)) * 0.2 * scale)
                   .astype(np.float32) for _ in range(F)]}


def _port(arrays):
    return {"w0": torch.tensor(arrays["w0"]),
            "vw": [torch.from_numpy(t.copy()) for t in arrays["vw"]]}


SPEC = models.FieldFMSpec(**KW)
JSPEC = jmodels.FieldFMSpec(**KW)


def _batch(n=4, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, BUCKET, (n, F)).astype(np.int32),
            rng.random((n, F)).astype(np.float32))


def _assert_serves(eng, arrays):
    """The engine's answers are the generation ``arrays``' predictions,
    held against the port's predict and JAX's."""
    ids, vals = _batch()
    got = eng.score(ids, vals)
    port = SPEC.predict(_port(arrays), torch.from_numpy(ids),
                        torch.from_numpy(vals)).numpy()
    jax_ = np.asarray(JSPEC.predict(
        {"w0": jnp.float32(arrays["w0"]),
         "vw": [jnp.asarray(t) for t in arrays["vw"]]},
        jnp.asarray(ids), jnp.asarray(vals)))
    np.testing.assert_allclose(got, port, **ULP2)
    np.testing.assert_allclose(got, jax_, rtol=1e-5, atol=1e-6)


def _chain(path, steps, journal=None):
    ck = Checkpointer(str(path), max_to_keep=10, journal=journal)
    for s in steps:
        ck.save(s, _port(_arrays(s)), force=True)
    ck.wait()
    return ck


def _engine(arrays=None, step=0):
    eng = PredictEngine(SPEC, _port(arrays or _arrays(1)), step=step,
                        buckets=(4,), latency_budget_ms=0.0, device="cpu")
    eng.warmup()
    return eng


def _events(journal, name):
    return [e for e in journal.records if e["event"] == name]


def test_follower_hot_swap_serves_new_generation(tmp_path):
    _chain(tmp_path, [7]).close()
    eng = _engine()
    fol = ReloadFollower(eng, str(tmp_path), poll_s=0.05)
    try:
        assert fol.poll_once() == "swapped"
        assert eng.generation().step == 7 and fol.reloads == 1
        _assert_serves(eng, _arrays(7))
        assert fol.last_swap["step"] == 7
        assert fol.poll_once() == "fresh"
        assert obs.gauge("serve/staleness_steps").value == 0
        assert obs.counter("serve.reloads_total").value == 1
    finally:
        fol.stop()
        eng.close()


def test_reload_fault_degrades_then_converges(tmp_path, monkeypatch):
    _chain(tmp_path, [5]).close()
    eng = _engine()
    journal = EventLog()
    fol = ReloadFollower(eng, str(tmp_path), journal=journal)
    fired = []

    def inject(point):
        if point == "serve_reload" and not fired:
            fired.append(point)
            raise RuntimeError("injected serve_reload fault")
    monkeypatch.setattr(faults, "inject", inject)
    try:
        assert fol.poll_once() == "failed"
        assert eng.generation().step == 0 and fol.degraded
        _assert_serves(eng, _arrays(1))
        assert "injected" in _events(journal, "reload_failed")[0]["error"]
        assert obs.gauge("serve/staleness_steps").value == 5
        assert fol.poll_once() == "swapped"
        assert eng.generation().step == 5 and not fol.degraded
        _assert_serves(eng, _arrays(5))
        assert (fol.reloads, fol.failures) == (1, 1)
    finally:
        fol.stop()
        eng.close()


def test_follower_refuses_demoted_tip_and_converges_forward(tmp_path):
    ck = _chain(tmp_path, [5, 9])
    assert ck.demote(9, reason="drift verdict") is True
    assert ck.last_good_step() == 5
    eng = _engine()
    journal = EventLog()
    fol = ReloadFollower(eng, str(tmp_path), journal=journal)
    try:
        assert fol.poll_once() == "swapped"
        assert eng.generation().step == 5
        _assert_serves(eng, _arrays(5))
        assert [e["step"] for e in
                _events(journal, "checkpoint_demoted_skipped")] == [9]
        # A stale pointer that still vouches for the demoted tip (the
        # crash window) never installs it.
        (tmp_path / "last_good.json").write_text('{"step": 9}')
        assert fol.poll_once() == "stale_chain"
        assert eng.generation().step == 5 and fol.degraded
        ck.save(12, _port(_arrays(12)))
        ck.wait()
        assert fol.poll_once() == "swapped"
        assert eng.generation().step == 12 and not fol.degraded
        _assert_serves(eng, _arrays(12))
    finally:
        fol.stop()
        eng.close()
        ck.close()


def test_demotion_racing_reload_is_refused(tmp_path):
    ck = _chain(tmp_path, [5, 9])
    eng = _engine(_arrays(5), step=5)
    journal = EventLog()
    fol = ReloadFollower(eng, str(tmp_path), journal=journal)
    restore = fol.chain.restore

    def restore_then_demote(*a, **kw):
        out = restore(*a, **kw)
        ck.demote(9, reason="drift verdict racing the reload")
        return out
    fol.chain.restore = restore_then_demote
    try:
        assert fol.poll_once() == "demoted"
        assert eng.generation().step == 5 and fol.degraded
        _assert_serves(eng, _arrays(5))
        assert "demoted mid-reload" in _events(
            journal, "reload_failed")[0]["error"]
        assert obs.counter("serve.demoted_refused_total").value == 1
        assert obs.counter("serve.swaps_total").value == 0
    finally:
        fol.stop()
        eng.close()
        ck.close()


def test_follower_torn_last_good_is_retried_not_raised(tmp_path):
    _chain(tmp_path, [3]).close()
    eng = _engine()
    fol = ReloadFollower(eng, str(tmp_path))
    lg = tmp_path / "last_good.json"
    try:
        for torn in (b"", b'{"st'):
            lg.write_bytes(torn)
            assert fol.chain.last_good_step() is None
            assert fol.poll_once() == "no_checkpoint"
        lg.write_bytes(json.dumps({"step": 3}).encode())
        assert fol.poll_once() == "swapped"
        assert eng.generation().step == 3
    finally:
        fol.stop()
        eng.close()


def _flip(path, step):
    """Rot the bytes of every array file of ``step``."""
    for root, _, files in os.walk(path / str(step)):
        for f in files:
            if f.endswith(".npy"):
                with open(os.path.join(root, f), "r+b") as fh:
                    fh.seek(-4, os.SEEK_END)
                    fh.write(b"\xde\xad\xbe\xef")


def test_follower_walks_back_past_corrupt_tip(tmp_path):
    _chain(tmp_path, [2, 4]).close()
    _flip(tmp_path, 4)                      # last_good still names 4
    eng = _engine()
    journal = EventLog()
    fol = ReloadFollower(eng, str(tmp_path), journal=journal)
    try:
        assert fol.poll_once() == "swapped"
        assert eng.generation().step == 2
        _assert_serves(eng, _arrays(2))
        assert [e["step"] for e in _events(journal, "checkpoint_corrupt")] \
            == [4]
        assert _events(journal, "checkpoint_walked_back")[0] == {
            **_events(journal, "checkpoint_walked_back")[0],
            "from_step": 4, "to_step": 2}
        assert fol.poll_once() == "stale_chain" and fol.degraded
    finally:
        fol.stop()
        eng.close()


def _snapshot(path):
    """Every file and directory under ``path``: bytes' digest and mtime."""
    out = {}
    for root, dirs, files in os.walk(path):
        for name in dirs + files:
            p = os.path.join(root, name)
            st = os.stat(p)
            digest = None
            if os.path.isfile(p):
                with open(p, "rb") as fh:
                    digest = hashlib.sha256(fh.read()).hexdigest()
            out[os.path.relpath(p, path)] = (digest, st.st_mtime_ns)
    return out


def test_chain_follower_never_mutates_the_chain(tmp_path):
    ck = _chain(tmp_path, [1, 3, 5, 7])
    ck.demote(7, reason="drift")
    ck.close()
    _flip(tmp_path, 5)                      # a walk-back on every restore
    os.unlink(tmp_path / "manifests" / "3.json")       # a torn save
    (tmp_path / "last_good.json").write_text('{"step": 7}')   # stale
    before = _snapshot(tmp_path)
    fol = ChainFollower(str(tmp_path))
    assert fol.last_good_step() == 7 and fol.tombstoned_steps() == {7}
    assert fol.restore(_port(_arrays(1)))["step"] == 1
    fol.close()
    eng = _engine()
    rf = ReloadFollower(eng, str(tmp_path))
    assert [rf.poll_once() for _ in range(2)] == ["swapped", "stale_chain"]
    rf.stop()
    eng.close()
    assert _snapshot(tmp_path) == before


def _relabel(tmp_path, step, layout):
    state_path = tmp_path / str(step) / "state.json"
    state = json.loads(state_path.read_text())
    state["layout"] = layout
    state_path.write_text(json.dumps(state))   # the manifest covers arrays


def test_non_canonical_layout_fails_the_reload(tmp_path):
    """A layout the reader does not know fails the reload. (A ``sharded``
    step, written by the field-sharded training's ``--ckpt-sharded``,
    reads back as canonical tables: see the next test.)"""
    ck = _chain(tmp_path, [4])
    ck.close()
    _relabel(tmp_path, 4, "interleaved")
    eng = _engine()
    journal = EventLog()
    fol = ReloadFollower(eng, str(tmp_path), journal=journal)
    try:
        assert fol.poll_once() == "failed"
        assert eng.generation().step == 0 and fol.degraded
        assert _events(journal, "reload_failed")[0]["error"] == (
            "chain holds interleaved-layout checkpoints; serving follows "
            "canonical layouts only")
        assert not _events(journal, "checkpoint_unreadable")
    finally:
        fol.stop()
        eng.close()


def test_sharded_layout_reloads_as_canonical(tmp_path):
    ck = _chain(tmp_path, [4])
    ck.close()
    _relabel(tmp_path, 4, "sharded")
    eng = _engine()
    fol = ReloadFollower(eng, str(tmp_path))
    try:
        assert fol.poll_once() == "swapped"
        assert eng.generation().step == 4 and not fol.degraded
    finally:
        fol.stop()
        eng.close()


def test_a_failed_swap_keeps_the_old_generation(tmp_path, monkeypatch):
    _chain(tmp_path, [6]).close()
    eng = _engine()
    journal = EventLog()
    fol = ReloadFollower(eng, str(tmp_path), journal=journal)

    def broken(params, step):
        raise RuntimeError("capture of bucket 4 failed")
    monkeypatch.setattr(eng, "swap_generation", broken)
    assert fol.poll_once() == "failed"
    assert eng.generation().step == 0 and fol.degraded
    assert "bucket 4" in _events(journal, "reload_failed")[0]["error"]
    monkeypatch.undo()
    assert fol.poll_once() == "swapped" and eng.generation().step == 6
    fol.stop()
    eng.close()


def test_the_poll_thread_outlives_a_failing_poll(tmp_path, monkeypatch):
    eng = _engine()
    journal = EventLog()
    fol = ReloadFollower(eng, str(tmp_path), poll_s=0.01, journal=journal)
    calls = []

    def failing():
        calls.append(1)
        raise OSError("poll exploded")
    monkeypatch.setattr(fol, "poll_once", failing)
    fol.start()
    try:
        deadline = time.monotonic() + 10
        while len(calls) < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert len(calls) >= 3 and fol._thread.is_alive()
        assert all("poll loop: OSError" in e["error"]
                   for e in _events(journal, "reload_failed"))
        assert obs.histogram("serve/reload_poll_ms").count >= 2
    finally:
        fol.stop()
        eng.close()
    assert fol._thread is None


def test_swaps_under_load_answer_each_request_from_one_generation(tmp_path):
    """A follower swapping while 4 threads submit: every request is
    answered once, by exactly one of the chain's generations."""
    ck = Checkpointer(str(tmp_path))
    eng = PredictEngine(SPEC, _port(_arrays(1)), buckets=(1, 4, 16),
                        latency_budget_ms=1.0, device="cpu")
    eng.warmup()
    fol = ReloadFollower(eng, str(tmp_path), poll_s=0.005).start()
    results, errors = [], []

    def client(t):
        # Until the last generation serves: the stream spans the swaps.
        deadline = time.monotonic() + 30
        j = 0
        try:
            while ((j < 40 or eng.generation().step < 4)
                   and time.monotonic() < deadline):
                ids, vals = _batch(1 + (t + j) % 16, seed=100 * t + j)
                results.append((ids, vals, eng.submit(ids, vals)))
                time.sleep(0.001)
                j += 1
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    for s in (2, 3, 4):
        ck.save(s, _port(_arrays(s)))
        ck.wait()
        time.sleep(0.05)
    for th in threads:
        th.join(60)
    assert not any(th.is_alive() for th in threads) and not errors
    fol.stop()
    gens = {s: _port(_arrays(s)) for s in (1, 2, 3, 4)}
    used = set()
    for ids, vals, fut in results:
        got = fut.result(30)
        match = [s for s, p in gens.items() if np.allclose(
            got, SPEC.predict(p, torch.from_numpy(ids),
                              torch.from_numpy(vals)).numpy(), **ULP2)]
        assert len(match) == 1
        used.add(match[0])
    eng.close()
    ck.close()
    assert eng.generation().step == 4 and len(used) >= 2


def test_sigkill_during_reload_drill_subprocess(tmp_path):
    """A serving process dies inside a reload attempt (the injected
    ``serve_reload`` exit, before any swap) with the planned rc; the chain
    is untouched, and the next follower's first poll converges on the
    newest generation."""
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    model = str(tmp_path / "model")
    models.save_model(model, SPEC, _port(_arrays(1)))
    chain = tmp_path / "chain"
    ck = _chain(chain, (1,))
    env = {**os.environ, "FM_SPARK_OBS_DIR": "none", "OMP_NUM_THREADS": "1",
           "FM_SPARK_FAULTS": "serve_reload@1=exit:9"}
    argv = [sys.executable, "-m", "fm_spark_tpu_torch", "serve", "--model",
            model, "--checkpoint-dir", str(chain), "--synthetic", "64",
            "--batch-size", "4", "--buckets", "1,4", "--reload-poll-s",
            "0.1", "--repeat", "100000", "--latency-budget-ms", "0",
            "--device", "cpu"]
    proc = subprocess.Popen(argv, stdout=subprocess.PIPE, text=True,
                            cwd=repo, env=env, stderr=subprocess.DEVNULL)
    try:
        line = proc.stdout.readline()
        assert '"serving": true' in line, line
        ck.save(2, _port(_arrays(2)), force=True)
        ck.wait()
        before = _snapshot(chain)
        rc = proc.wait(timeout=240)
    finally:
        proc.kill()
        ck.close()
    assert rc == 9, f"expected the planned exit rc, got {rc}"
    assert _snapshot(chain) == before
    eng = _engine()
    fol = ReloadFollower(eng, str(chain), poll_s=0.05)
    try:
        assert fol.poll_once() == "swapped"
        assert eng.generation().step == 2
        assert int(obs.gauge("serve/staleness_steps").value or 0) == 0
        _assert_serves(eng, _arrays(2))
    finally:
        fol.stop()
        eng.close()
