"""The port's serving engine and ``predict`` CLI, on the CPU, against the
JAX package's engine and CLI on the same model dir.

Cross-package tolerance ``rtol=1e-5`` (plus ``atol=1e-6`` on
probabilities): float32 accumulation in different orders, as in
``test_torch_fused_fwd.py``. Within the port, padded and unpadded scoring
are held bitwise equal at the raw-score level.
"""

import sys
import threading

import jax
import numpy as np
import pytest
import torch

from fm_spark_tpu import cli as jcli
from fm_spark_tpu import models as jmodels
from fm_spark_tpu.serve import PredictEngine as JaxPredictEngine
from fm_spark_tpu_torch import cli, models, obs
from fm_spark_tpu_torch.serve import PredictEngine

F, BUCKET = 4, 64


def _spec_kw():
    return dict(num_features=F * BUCKET, rank=8, num_fields=F, bucket=BUCKET,
                init_std=0.3)


@pytest.fixture
def model_dir(tmp_path):
    """A JAX-initialised model dir with a nonzero linear column and bias."""
    spec = jmodels.FieldFMSpec(**_spec_kw())
    p = spec.init(jax.random.key(0))
    rng = np.random.default_rng(5)
    p = {"w0": jax.numpy.float32(0.1),
         "vw": [t.at[:, spec.rank].set(rng.normal(size=BUCKET) * 0.3)
                for t in p["vw"]]}
    jmodels.save_model(str(tmp_path / "m"), spec, p)
    return str(tmp_path / "m")


@pytest.fixture
def port_model():
    spec = models.FieldFMSpec(**_spec_kw())
    return spec, spec.init(torch.Generator().manual_seed(0), device="cpu")


@pytest.fixture(autouse=True)
def _fresh_registry():
    obs.registry().reset()
    yield
    obs.registry().reset()


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, BUCKET, (n, F)).astype(np.int32),
            rng.random((n, F)).astype(np.float32))


def _direct(spec, params, ids, vals):
    return spec.predict(params, torch.from_numpy(ids),
                        torch.from_numpy(vals)).numpy()


def _engine(spec, params, buckets=(1, 4, 16), budget_ms=20.0):
    eng = PredictEngine(spec, params, buckets=buckets,
                        latency_budget_ms=budget_ms, device="cpu")
    eng.warmup()
    return eng


def _counter(name):
    return obs.registry().counter(name).value


def test_score_matches_jax_engine(model_dir):
    jspec, jparams = jmodels.load_model(model_dir)
    spec, params = models.load_model(model_dir, device="cpu")
    jeng = JaxPredictEngine(jspec, jparams, buckets=(1, 8, 64))
    jeng.warmup()
    eng = _engine(spec, params, buckets=(1, 8, 64))
    for n in (1, 5, 64, 150):
        ids, vals = _batch(n, seed=n)
        np.testing.assert_allclose(eng.score(ids, vals),
                                   jeng.score(ids, vals), rtol=1e-5, atol=1e-6)


def test_padded_and_unpadded_scores_are_bitwise_equal(port_model):
    """Padding rows (id 0, value 0) never change another row's raw score:
    the port's scores are row-independent, bit for bit."""
    spec, params = port_model
    for n, bucket in ((1, 16), (7, 16), (16, 16), (100, 512)):
        ids, vals = _batch(n, seed=n)
        pad = bucket - n
        pids = np.concatenate([ids, np.zeros((pad, F), np.int32)])
        pvals = np.concatenate([vals, np.zeros((pad, F), np.float32)])
        unpadded = spec.scores(params, torch.from_numpy(ids),
                               torch.from_numpy(vals))
        padded = spec.scores(params, torch.from_numpy(pids),
                             torch.from_numpy(pvals))
        assert torch.equal(padded[:n], unpadded)


# The engine's predictions go through torch.sigmoid, whose CPU kernel
# takes a vector path or a scalar path by an element's position in the
# tensor; the two differ by at most an ulp or two (~1.2e-7 relative).
ULP2 = dict(rtol=2.5e-7, atol=0)


def test_engine_pads_to_buckets_and_slices_padding_off(port_model):
    spec, params = port_model
    eng = _engine(spec, params, buckets=(16,))
    for n in (1, 7, 16):
        ids, vals = _batch(n, seed=n)
        got = eng.score(ids, vals)
        assert got.shape == (n,)
        np.testing.assert_allclose(got, _direct(spec, params, ids, vals), **ULP2)
    assert _counter("serve.padded_rows_total") == 15 + 9


def test_score_chunks_past_the_largest_bucket(port_model):
    spec, params = port_model
    eng = _engine(spec, params, buckets=(1, 4, 16))
    ids, vals = _batch(50, seed=3)
    np.testing.assert_allclose(eng.score(ids, vals),
                               _direct(spec, params, ids, vals), **ULP2)
    assert _counter("serve.batches_total") == 4       # 16 + 16 + 16 + 2
    np.testing.assert_allclose(eng.predict(ids, vals),
                               _direct(spec, params, ids, vals), **ULP2)
    eng.close()


def test_threaded_submit_answers_every_request_exactly_once(port_model):
    spec, params = port_model
    eng = _engine(spec, params, buckets=(1, 4, 16), budget_ms=5.0)
    results, errors = {}, []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)

    def client(t):
        try:
            for j in range(25):
                n = 1 + (t * 7 + j) % 16
                ids, vals = _batch(n, seed=100 * t + j)
                results[(t, j)] = (ids, vals, eng.submit(ids, vals))
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    try:
        threads = [threading.Thread(target=client, args=(t,)) for t in range(16)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads) and not errors
        rows = 0
        for ids, vals, fut in results.values():
            np.testing.assert_allclose(fut.result(30),
                                       _direct(spec, params, ids, vals), **ULP2)
            rows += ids.shape[0]
    finally:
        sys.setswitchinterval(switch)
        eng.close()
    assert len(results) == 16 * 25
    assert _counter("serve.requests_total") == 16 * 25
    assert _counter("serve.rows_total") == rows
    assert _counter("serve.batches_total") < 16 * 25     # requests coalesced
    assert obs.registry().histogram("serve/request_ms").count == 16 * 25


@pytest.mark.parametrize("shape", [(3, F + 1), (3, F - 1)])
def test_width_mismatch_rejected(port_model, shape):
    spec, params = port_model
    eng = _engine(spec, params)
    bad = np.zeros(shape, np.int32)
    with pytest.raises(ValueError, match="width"):
        eng.score(bad, bad.astype(np.float32))
    with pytest.raises(ValueError, match="width"):
        eng.submit(bad, bad.astype(np.float32))
    with pytest.raises(ValueError, match="bucket-max"):
        eng.submit(*_batch(17))
    eng.close()


def test_requests_before_warmup_and_after_deadline(port_model):
    spec, params = port_model
    cold = PredictEngine(spec, params, buckets=(4,), device="cpu")
    with pytest.raises(RuntimeError, match="warmup"):
        cold.score(*_batch(2))
    eng = _engine(spec, params)
    fut = eng.submit(*_batch(2), deadline=0.0)          # long expired
    with pytest.raises(TimeoutError):
        fut.result(10)
    assert _counter("serve.deadline_expired_total") == 1
    eng.close()


def test_swap_generation_replaces_the_reference(port_model):
    spec, params = port_model
    eng = _engine(spec, params)
    ids, vals = _batch(3)
    before = eng.predict(ids, vals)
    newer = {"w0": params["w0"] + 1.0, "vw": params["vw"]}
    gen = eng.swap_generation(newer, step=7)
    assert eng.generation() is gen and gen.gen_id == 1 and gen.step == 7
    after = eng.predict(ids, vals)
    np.testing.assert_allclose(after, _direct(spec, newer, ids, vals), **ULP2)
    assert not np.array_equal(before, after)
    assert _counter("serve.swaps_total") == 1
    assert obs.registry().gauge("serve/generation_step").value == 7
    eng.close()


def test_failed_batch_answers_every_caller(port_model):
    spec, params = port_model
    eng = _engine(spec, params)
    eng.swap_generation({"w0": params["w0"], "vw": params["vw"][:2]}, step=1)
    fut = eng.submit(*_batch(2))
    with pytest.raises((IndexError, ValueError)):
        fut.result(10)
    assert _counter("serve.batch_failures_total") == 1
    eng.close()


def test_predict_cli_matches_jax_cli(model_dir, tmp_path):
    jout, pout = tmp_path / "jax.txt", tmp_path / "port.txt"
    assert jcli.main(["predict", "--model", model_dir, "--synthetic", "100",
                      "--batch-size", "32", "--out", str(jout)]) == 0
    assert cli.main(["predict", "--model", model_dir, "--synthetic", "100",
                     "--batch-size", "32", "--device", "cpu",
                     "--out", str(pout)]) == 0
    want, got = np.loadtxt(jout), np.loadtxt(pout)
    assert got.shape == want.shape == (100,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_predict_cli_needs_synthetic(model_dir):
    with pytest.raises(SystemExit):
        cli.main(["predict", "--model", model_dir, "--device", "cpu"])
