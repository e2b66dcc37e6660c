"""The port's serving engine and ``predict`` CLI, on the CPU, against the
JAX package's engine and CLI on the same model dir.

Cross-package tolerance ``rtol=1e-5`` (plus ``atol=1e-6`` on
probabilities): float32 accumulation in different orders, as in
``test_torch_fused_fwd.py``. Within the port, padded and unpadded scoring
are held bitwise equal at the raw-score level.
"""

import json
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


# ------------------------------------------------------------ cli serve


def _serve_lines(text):
    """``(predictions, json lines)`` of a serve run's standard output."""
    preds, objs = [], []
    for line in text.splitlines():
        if line.startswith("{"):
            objs.append(json.loads(line))
        elif line.strip():
            preds.append(float(line))
    return np.array(preds), objs


SUMMARY_KEYS = {"served_requests", "served_rows", "elapsed_s", "qps",
                "request_ms", "generation_step", "swaps", "reload_failures",
                "staleness_steps", "degraded"}


def test_serve_cli_matches_jax_cli(model_dir, capsys):
    """The port's ``serve --out -`` against JAX's on the same JAX-saved
    model dir, at the predict CLI test's tolerance (float32 sums in
    another order; %.6g output)."""
    args = ["serve", "--model", model_dir, "--synthetic", "64",
            "--batch-size", "8", "--buckets", "1,8", "--out", "-",
            "--reload-poll-s", "0", "--latency-budget-ms", "0"]
    assert jcli.main(args + ["--obs-dir", "none"]) == 0
    want, jlines = _serve_lines(capsys.readouterr().out)
    assert cli.main(args + ["--device", "cpu"]) == 0
    got, plines = _serve_lines(capsys.readouterr().out)
    assert got.shape == want.shape == (64,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    jsum = next(o["serve_summary"] for o in jlines if "serve_summary" in o)
    psum = next(o["serve_summary"] for o in plines if "serve_summary" in o)
    assert set(jsum) == set(psum) == SUMMARY_KEYS
    assert set(jsum["request_ms"]) == set(psum["request_ms"])
    assert psum["served_requests"] == jsum["served_requests"] == 8
    assert psum["served_rows"] == 64 and psum["generation_step"] == 0
    assert not psum["degraded"] and psum["swaps"] == 0
    jserving = next(o for o in jlines if "serving" in o)
    pserving = next(o for o in plines if "serving" in o)
    assert set(jserving) <= set(pserving)


def test_serve_follows_a_chain_without_a_model(tmp_path, capsys):
    """``--config`` with ``--checkpoint-dir`` and no ``--model`` serves the
    chain's newest verified step, its tables in the chain's dtype (bf16
    here, the config's float32), with its last_good torn to show the
    follower walks the manifests, not the pointer."""
    import dataclasses

    from fm_spark_tpu_torch import configs
    from fm_spark_tpu_torch.checkpoint import Checkpointer

    spec = dataclasses.replace(
        configs.get_config("criteo1tb_fm_r64", bucket=16).spec(),
        param_dtype="bfloat16")
    ck = Checkpointer(str(tmp_path / "ck"))
    gens = {}
    for step in (2, 4):
        gens[step] = spec.init(torch.Generator().manual_seed(step),
                               device="cpu")
        ck.save(step, gens[step])
    ck.close()
    (tmp_path / "ck" / "last_good.json").write_text("")
    assert cli.main(["serve", "--config", "criteo1tb_fm_r64", "--bucket",
                     "16", "--checkpoint-dir", str(tmp_path / "ck"),
                     "--synthetic", "40", "--batch-size", "16", "--buckets",
                     "4,16", "--out", "-", "--reload-poll-s", "0",
                     "--device", "cpu"]) == 0
    got, lines = _serve_lines(capsys.readouterr().out)
    summary = next(o["serve_summary"] for o in lines if "serve_summary" in o)
    assert summary["generation_step"] == 4 and summary["served_rows"] == 40
    assert next(o for o in lines if "serving" in o)["step"] == 4
    ids, vals, _ = cli._synthetic_for_model(spec, 40)
    want = spec.predict(gens[4], torch.from_numpy(ids),
                        torch.from_numpy(vals)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)  # %.6g
    with pytest.raises(SystemExit, match="no verified checkpoint"):
        cli.main(["serve", "--config", "criteo1tb_fm_r64", "--bucket", "16",
                  "--checkpoint-dir", str(tmp_path / "empty"),
                  "--synthetic", "8", "--device", "cpu"])
    with pytest.raises(SystemExit, match="needs --model"):
        cli.main(["serve", "--checkpoint-dir", str(tmp_path / "ck"),
                  "--synthetic", "8", "--device", "cpu"])


@pytest.mark.parametrize("flag,value,item", [
    ("--fleet", "2", "6b"), ("--autoscale-max", "3", "6b"),
    ("--frontdoor-port", "0", "6b"), ("--classes", "a:1:2", "6b"),
    ("--serve-seconds", "5", "6b"), ("--trace-sample", "0.1", "6b"),
    ("--compile-cache", None, "12")])
def test_serve_unported_flags_exit_naming_their_item(model_dir, flag, value,
                                                     item, capsys):
    """The reference's serve flags that waited for items 6b and 12 are
    all taken now. The kernel build cache (item 12a) serves, its
    ``serving`` line's ``fresh_compiles`` a number (0: the CPU builds
    nothing). The front door's flags (item 6b) configure ``--fleet``:
    without it each exits naming ``--fleet`` (nothing is ignored), and
    ``--fleet`` exits on the single engine's request stream
    (``--synthetic``), which it does not read; the fleet itself is held
    in ``tests/test_torch_fleet.py``."""
    argv = ["serve", "--model", model_dir, "--synthetic", "8", "--device",
            "cpu", "--obs-dir", "none", flag] + (
                [value] if value is not None else [])
    if item == "12":
        assert cli.main(argv) == 0
        serving = next(json.loads(x) for x in
                       capsys.readouterr().out.splitlines()
                       if x.startswith('{"serving"'))
        assert serving["fresh_compiles"] == 0
    else:
        with pytest.raises(SystemExit, match="--fleet" if flag != "--fleet"
                           else "--synthetic"):
            cli.main(argv)
    assert not hasattr(cli, "_UNPORTED_SERVE_FLAGS")


@pytest.mark.parametrize("flag,value", [
    ("--slo-ms", "1000"), ("--metrics-port", "0"), ("--obs-dir", "none")])
def test_serve_obs_flags_are_taken(model_dir, flag, value, capsys):
    """``--slo-ms``, ``--metrics-port`` and ``--obs-dir`` serve (their
    planes are held in ``tests/test_torch_cli_obs.py``)."""
    assert cli.main(["serve", "--model", model_dir, "--synthetic", "8",
                     "--device", "cpu", "--obs-dir", "none",
                     flag, value]) == 0
    out = capsys.readouterr().out
    assert '"serve_summary"' in out
    assert ('"metrics_port"' in out) == (flag == "--metrics-port")


def test_serve_accepts_and_ignores_optimizer(model_dir, capsys):
    assert cli.main(["serve", "--model", model_dir, "--synthetic", "8",
                     "--optimizer", "ftrl", "--device", "cpu"]) == 0
    assert '"serve_summary"' in capsys.readouterr().out


def test_list_configs_lists_the_ports_configs(capsys):
    from fm_spark_tpu_torch import configs

    assert cli.main(["list-configs"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[0] for ln in lines] == sorted(configs.CONFIGS)
    assert cli.main(["list-configs", "--verbose"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [r["name"] for r in rows] == sorted(configs.CONFIGS)
    assert rows[2]["bucket"] == 1 << 18 and rows[2]["model"] == "field_fm"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepfm_padded_and_unpadded_scores_are_bitwise_equal(dtype):
    """A FieldDeepFM row scored in any bucket against the same row scored
    in a batch of 512. The port: raw scores of the padded bucket bit for
    bit (its products run over fixed row tiles; before them its fp32 rows
    differed by ~3e-8 between batch sizes), predictions within the CPU
    sigmoid's ulp. JAX's engine is not batch-invariant on the CPU (its
    fp32 raw scores and predictions differ by up to 1.4e-7 / 6e-8 here,
    XLA's products shaped by the batch), so it is held at one fp32 ulp
    of the prediction's scale and, in bf16, at one bf16 ulp."""
    kw = dict(num_features=F * BUCKET, rank=4, num_fields=F, bucket=BUCKET,
              mlp_dims=(16, 16, 16), init_std=0.3, param_dtype=dtype,
              compute_dtype=dtype)
    jspec = jmodels.FieldDeepFMSpec(**kw)
    jparams = jspec.init(jax.random.key(0))
    spec = models.FieldDeepFMSpec(**kw)
    params = spec.init(torch.Generator().manual_seed(0), device="cpu")
    buckets = (1, 8, 64, 512)
    jeng = JaxPredictEngine(jspec, jparams, buckets=buckets)
    jeng.warmup()
    eng = _engine(spec, params, buckets=buckets)
    ids, vals = _batch(512, seed=9)
    jfull, full = jeng.score(ids, vals), eng.score(ids, vals)
    jtol = 2.0 ** -23 if dtype == "float32" else 2.0 ** -8
    full_raw = spec.scores(params, torch.from_numpy(ids),
                           torch.from_numpy(vals))
    for n in (1, 5, 8, 50, 64, 300):
        np.testing.assert_allclose(jeng.score(ids[:n], vals[:n]), jfull[:n],
                                   rtol=0, atol=jtol)
        np.testing.assert_allclose(eng.score(ids[:n], vals[:n]), full[:n],
                                   **ULP2)
        bucket = next(b for b in buckets if b >= n)
        pad = np.zeros((bucket - n, F), np.int32)
        raw = spec.scores(
            params, torch.from_numpy(np.concatenate([ids[:n], pad])),
            torch.from_numpy(np.concatenate([vals[:n], pad.astype(np.float32)])))
        assert torch.equal(raw[:n], full_raw[:n])
    eng.close()
