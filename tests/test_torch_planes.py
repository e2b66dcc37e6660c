"""The planes the port copied from the JAX package (framework-neutral
Python): the divergence guard, the regression sentinel, the perf ledger
and the deadline watchdog, each held to give the reference's outputs
exactly on the same inputs; and the obs plane's spans and events.

The ledger's fingerprint names the port's runtime (``torch_version``,
``cuda_version``) where the reference's names JAX's (``jax_version``,
``libtpu_version``): its ``config_hash`` and every other field agree,
and its cohort ``key`` differs by design (the two ledgers never mix).
"""

import json
import math
import threading
import time

import numpy as np
import pytest

from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.obs import ledger as pledger
from fm_spark_tpu_torch.obs import sentinel as psentinel
from fm_spark_tpu_torch.resilience import divergence as pdiv
from fm_spark_tpu_torch.resilience import watchdog as pwd
from fm_spark_tpu_torch.utils.logging import EventLog, read_events


@pytest.fixture(autouse=True)
def _clean():
    pwd.clear()
    yield
    pwd.clear()
    obs.shutdown()


# ----------------------------------------------------------- divergence


def _series(seed, n=40, spike_at=None):
    rng = np.random.default_rng(seed)
    vals = list(1.0 + 0.05 * rng.standard_normal(n))
    if spike_at is not None:
        vals[spike_at] = float("nan") if seed % 2 else 25.0
    return vals


class _Journal:
    """A journal that keeps what it is given (both guards emit to it)."""

    def __init__(self):
        self.records = []

    def emit(self, event, **fields):
        self.records.append({"event": event, **fields})


def _drive(mod, vals, mode, **kw):
    """Feed ``vals`` through a guard of ``mod``; roll back on each
    detection. Returns the journal's events and the outcome."""
    journal = _Journal()
    g = mod.DivergenceGuard(journal=journal, mode=mode, **kw)
    out = []
    for step, v in enumerate(vals, 1):
        try:
            g.check(step, v)
            out.append(("ok", g.baseline(), g.history()))
        except mod.DivergenceDetected as e:
            try:
                out.append(("rollback", e.step, e.reason,
                            g.note_rollback(e, step // 2)))
            except mod.DivergenceDetected:
                out.append(("exhausted", e.step))
                break
    return out, journal.records


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("mode", ["min", "max"])
def test_divergence_guard_equals_jax(seed, mode):
    from fm_spark_tpu.resilience import divergence as jdiv

    vals = _series(seed, spike_at=20 + seed)
    if mode == "max":
        vals[30] = 0.1           # a drop in the higher-is-better series
    kw = dict(spike_factor=1.15 if mode == "max" else 10.0, window=8,
              min_history=3, max_rollbacks=1)
    got, got_ev = _drive(pdiv, vals, mode, **kw)
    want, want_ev = _drive(jdiv, vals, mode, **kw)
    assert got == want and got_ev == want_ev
    assert any(o[0] != "ok" for o in got)


def test_divergence_guard_validates_like_jax():
    with pytest.raises(ValueError, match="spike_factor"):
        pdiv.DivergenceGuard(spike_factor=1.0)
    with pytest.raises(ValueError, match="mode"):
        pdiv.DivergenceGuard(mode="median")
    g = pdiv.DivergenceGuard(mode="max")
    g.seed_history([0.7, 0.71, 0.72])
    assert g.history() == [0.7, 0.71, 0.72] and g.baseline() == 0.71


# ------------------------------------------------------------- sentinel


def _histories(seed):
    rng = np.random.default_rng(seed)
    base = 100.0 + 10 * rng.random()
    hist = list(base + rng.standard_normal(int(rng.integers(0, 12))))
    if seed % 3 == 0 and hist:
        hist[0] = None
    values = [None, base, base * 1.5, base * 0.5, base * 1.01]
    return hist, values


@pytest.mark.parametrize("seed", range(12))
def test_classify_equals_jax(seed):
    from fm_spark_tpu.obs import sentinel as jsentinel

    hist, values = _histories(seed)
    for value in values:
        for health in ("healthy", "flaky", "down"):
            for policy in (None, dict(min_history=2, window=4,
                                      z_threshold=2.0, rel_floor=0.05)):
                pp = policy and psentinel.SentinelPolicy(**policy)
                jp = policy and jsentinel.SentinelPolicy(**policy)
                got = psentinel.classify(hist, value, health, pp)
                want = jsentinel.classify(hist, value, health, jp)
                assert got == want
                assert psentinel.keepbest_allowed(got) == \
                    jsentinel.keepbest_allowed(want)
    assert psentinel.ALL_VERDICTS == jsentinel.ALL_VERDICTS


# --------------------------------------------------------------- ledger


def _fp_kw(i):
    return dict(variant=f"quality/c{i % 2}/ftrl", model="fm", batch=128,
                rank=8, extra={"lr": 0.1 * (1 + i % 3)}, n_chips=1,
                device_kind="card", chaos=bool(i == 3))


def test_ledger_and_sentinel_equal_jax(tmp_path):
    from fm_spark_tpu.obs import ledger as jledger
    from fm_spark_tpu.obs import sentinel as jsentinel

    pl = pledger.PerfLedger(str(tmp_path / "p.jsonl"))
    jl = jledger.PerfLedger(str(tmp_path / "j.jsonl"))
    ps, js = psentinel.Sentinel(pl), jsentinel.Sentinel(jl)
    rng = np.random.default_rng(4)
    for i in range(14):
        pfp = pledger.measurement_fingerprint(**_fp_kw(i))
        jfp = jledger.measurement_fingerprint(**_fp_kw(i))
        assert pfp["config_hash"] == jfp["config_hash"]
        assert {k: v for k, v in pfp.items() if k not in (
            "key", "torch_version", "cuda_version")} == {
            k: v for k, v in jfp.items() if k not in (
                "key", "jax_version", "libtpu_version")}
        value = None if i == 5 else float(0.7 + 0.01 * rng.standard_normal())
        rec = {"kind": "quality_eval", "leg": f"quality/c{i % 2}/ftrl",
               "run_id": "r", "value": value, "day": i}
        got = ps.observe({**rec, "fingerprint": pfp})
        want = js.observe({**rec, "fingerprint": jfp})
        assert got == want
    drop = lambda r: {k: v for k, v in r.items()           # noqa: E731
                      if k not in ("ts", "fingerprint")}
    assert [drop(r) for r in pl.records()] == [drop(r) for r in jl.records()]
    assert len(pl.records(kind="quality_eval", leg="quality/c0/ftrl")) == 7
    for r in pl.records():
        assert r["fingerprint"]["key"] == pledger.fingerprint_key(
            r["fingerprint"])
    key = pl.records()[0]["fingerprint"]["key"]
    assert [r["day"] for r in pl.cohort("quality/c0/ftrl", key)] == \
        [r["day"] for r in jl.cohort(
            "quality/c0/ftrl", jl.records()[0]["fingerprint"]["key"])]


def test_ledger_refuses_unattributable_records_and_skips_torn_lines(
        tmp_path):
    path = tmp_path / "l.jsonl"
    pl = pledger.PerfLedger(str(path))
    with pytest.raises(ValueError, match="required field"):
        pl.append({"kind": "quality_eval", "leg": "x", "run_id": "r"})
    with pytest.raises(ValueError, match="cohort 'key'"):
        pl.append({"kind": "k", "leg": "x", "run_id": "r",
                   "fingerprint": {"variant": "x"}})
    fp = pledger.measurement_fingerprint(variant="x")
    pl.append({"kind": "k", "leg": "x", "run_id": "r", "fingerprint": fp})
    with open(path, "a") as f:
        f.write('{"kind": "k", "leg"\n')
    assert len(pl.records()) == 1
    assert pledger.default_ledger_path("/a").endswith(
        "obs/ledger_torch.jsonl")


def test_runtime_versions_name_the_port_runtime():
    import torch

    v = pledger.runtime_versions()
    assert v["torch_version"] == torch.__version__
    assert set(v) == {"torch_version", "cuda_version", "device_kind"}


# ------------------------------------------------------------- watchdog


def test_watchdog_raise_action_detects_a_finite_hang():
    journal = EventLog()
    pwd.configure({"online_eval": 0.05}, action="raise", journal=journal)
    assert pwd.active() and pwd.active("online_eval")
    assert not pwd.active("ckpt_commit")
    with pytest.raises(pwd.HangDetected, match="online_eval") as ei:
        with pwd.phase("online_eval"):
            time.sleep(0.08)
    assert ei.value.deadline_s == 0.05 and ei.value.elapsed_s >= 0.05
    assert [e["event"] for e in journal.records] == ["hang_detected"]
    # A phase with no budget is the shared no-op.
    with pwd.phase("ckpt_commit"):
        pass
    # A real exception unwinding through an overrun is never masked.
    with pytest.raises(KeyError):
        with pwd.phase("online_eval"):
            time.sleep(0.08)
            raise KeyError("primary")


def test_watchdog_exit_action_fires_while_the_phase_is_stuck():
    exits = []
    done = threading.Event()

    def fake_exit(rc):
        exits.append(rc)
        done.set()

    table = pwd.WatchdogTable({"step_window": 0.05}, action="exit",
                              poll_s=0.01, _exit=fake_exit)
    with table.phase("step_window"):
        assert done.wait(2.0)
    table.close()
    # The monitor's verdict, then the phase's own at its (late) exit: the
    # test double returns where os._exit would not.
    assert exits == [pwd.HANG_EXIT_RC] and table.hangs_detected == 2


def test_watchdog_near_miss_is_counted_and_rate_limited():
    journal = EventLog()
    table = pwd.WatchdogTable({"online_eval": 0.1}, action="raise",
                              journal=journal)
    for _ in range(2):
        with table.phase("online_eval"):
            time.sleep(0.09)
    assert table.near_misses == 2
    assert [e["event"] for e in journal.records] == ["watchdog_near_miss"]
    assert pwd.NEAR_MISS_FRACTION == 0.8


def test_watchdog_spec_grammar_equals_jax(monkeypatch):
    from fm_spark_tpu.resilience import watchdog as jwd

    spec = "ingest_chunk=2;ckpt_commit=10; step_window=30"
    assert pwd.parse_spec(spec) == jwd.parse_spec(spec)
    for bad in ("nope=1", "online_eval", "online_eval=0"):
        with pytest.raises(ValueError):
            pwd.parse_spec(bad)
    assert pwd.KNOWN_PHASES == jwd.KNOWN_PHASES
    assert (pwd.ENV_SPEC, pwd.ENV_ACTION, pwd.HANG_EXIT_RC) == (
        jwd.ENV_SPEC, jwd.ENV_ACTION, jwd.HANG_EXIT_RC)
    monkeypatch.setenv(pwd.ENV_SPEC, "online_eval=0.01")
    monkeypatch.setenv(pwd.ENV_ACTION, "raise")
    pwd.clear()
    with pytest.raises(pwd.HangDetected):
        with pwd.phase("online_eval"):
            time.sleep(0.03)
    # The unconfigured path starts no thread.
    monkeypatch.delenv(pwd.ENV_SPEC)
    pwd.clear()
    before = threading.active_count()
    with pwd.phase("online_eval"):
        pass
    assert threading.active_count() == before and not pwd.active()


# ------------------------------------------------------------------ obs


def test_spans_and_events_drop_until_a_sink_is_configured(tmp_path):
    assert obs.span("x") is obs.NOOP_SPAN and obs.run_id() is None
    obs.event("quality_eval", day=1)          # dropped, no error
    assert obs.run_dir() is None
    rid = obs.configure(str(tmp_path / "run"))
    assert obs.run_id() == rid and obs.enabled()
    assert obs.run_dir() == str(tmp_path / "run")
    with obs.span("online/eval_day", day=3) as sp:
        sp.set(auc=0.75)
    obs.event("quality_eval", day=3)
    recs = read_events(str(tmp_path / "run" / "trace.jsonl"))
    assert [r["event"] for r in recs] == ["span"]
    assert recs[0]["name"] == "online/eval_day" and recs[0]["day"] == 3
    assert recs[0]["auc"] == 0.75 and recs[0]["dur_ms"] >= 0
    json.dumps(recs)
    obs.shutdown()
    assert not obs.enabled() and obs.run_id() is None
    kinds = [e["kind"] for e in obs.read_spool(
        str(tmp_path / "run" / "flight.jsonl"))]
    assert kinds == ["run_start", "span", "quality_eval", "run_end"]
    assert math.isfinite(float(rid.split("-p")[-1]))


def test_metrics_registry_stays_importable_from_obs():
    from fm_spark_tpu_torch.obs import metrics

    assert obs.counter is metrics.counter and obs.registry() is \
        metrics.registry()
    obs.gauge("embed/hit_rate").set(0.5)
    assert obs.registry().snapshot()["gauges"]["embed/hit_rate"] == 0.5


# ----------------------------------- FMTrainer.fit(divergence_guard=...)


class _PoisonOnce:
    """A resumable source whose ``at``-th fetched batch (a process-local
    count: the replay after a rollback is clean) has its ``vals`` blown up
    (the reference test's source)."""

    def __init__(self, inner, at, scale=1e12):
        self.inner, self.at, self.scale, self.n = inner, at, scale, 0

    def state(self):
        return self.inner.state()

    def restore(self, s):
        self.inner.restore(s)

    def __iter__(self):
        return self

    def __next__(self):
        self.n += 1
        ids, vals, labels, w = next(self.inner)
        if self.n == self.at:
            vals = vals * self.scale
        return ids, vals, labels, w


def _div_problem():
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.data import synthetic_ctr
    from fm_spark_tpu_torch.train import TrainConfig

    ids, vals, labels = synthetic_ctr(num_examples=256, num_features=64,
                                      nnz=5, seed=3)
    spec = models.FMSpec(num_features=64, rank=4, init_std=0.05)
    config = TrainConfig(num_steps=10, batch_size=32, learning_rate=0.1,
                         lr_schedule="constant", log_every=1)
    return spec, config, (ids, vals, labels)


def _fm_trainer(spec, config):
    import io

    from fm_spark_tpu_torch.train import FMTrainer

    tr = FMTrainer(spec, config, device="cpu")
    tr.logger._stream = io.StringIO()
    return tr


@pytest.mark.parametrize("poison_at, scale, save_every, stop", [
    (7, 1e12, 2, 6),       # the reference test: back to step 6, none replayed
    (6, 1e12, 4, 5),       # back to step 4, step 5 replayed, stop before 6
    (1, np.inf, 2, 0),     # a NaN before any save: back to the seed's init
])
def test_divergence_guard_rolls_back_in_place(tmp_path, poison_at, scale,
                                              save_every, stop):
    """The guard restores the last good step INTO the trainer's tensors
    (a chain without one: the seed's init, the cursor rewound) and stops
    just before the poisoned step, bit for bit a clean run of that
    length."""
    import dataclasses

    import torch

    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.data import Batches

    spec, config, (ids, vals, labels) = _div_problem()
    golden = _fm_trainer(spec, dataclasses.replace(config, num_steps=stop))
    golden.fit(Batches(ids, vals, labels, config.batch_size, seed=7))
    journal = EventLog()
    guard = pdiv.DivergenceGuard(spike_factor=10.0, journal=journal)
    ck = Checkpointer(str(tmp_path / "ck"), save_every=save_every)
    trainer = _fm_trainer(spec, config)
    tensors = dict(trainer.params)
    trainer.fit(_PoisonOnce(Batches(ids, vals, labels, config.batch_size,
                                    seed=7), at=poison_at, scale=scale),
                checkpointer=ck, divergence_guard=guard)
    ck.close()
    assert trainer.step_count == stop and guard.rollbacks == 1
    assert all(trainer.params[k] is t for k, t in tensors.items())
    for k in ("w0", "w", "v"):
        assert torch.equal(trainer.params[k], golden.params[k]), k
    if stop:
        assert trainer.loss_history[-1] == golden.loss_history[-1]
    rb = [e for e in journal.records if e["event"] == "divergence_rollback"]
    assert rb and rb[0]["reduced_target"] == stop


def test_divergence_rollback_matches_jax(tmp_path):
    """The reference's rollback drill on both packages from one init: the
    same detection step, rollback and final step, params within
    ``rtol=1e-5, atol=1e-6`` (the dense step sums a duplicated id's lanes
    in another order)."""
    import jax

    from fm_spark_tpu import models as jmodels
    from fm_spark_tpu.checkpoint import Checkpointer as JCheckpointer
    from fm_spark_tpu.data.pipeline import Batches as JBatches
    from fm_spark_tpu.resilience.divergence import \
        DivergenceGuard as JDivergenceGuard
    from fm_spark_tpu.train import FMTrainer as JFMTrainer
    from fm_spark_tpu.train import TrainConfig as JTrainConfig

    import dataclasses

    import torch

    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.data import Batches

    spec, config, (ids, vals, labels) = _div_problem()
    jspec = jmodels.FMSpec(num_features=64, rank=4, init_std=0.05)
    jt = JFMTrainer(jspec, JTrainConfig(**dataclasses.asdict(config)))
    jt.logger._stream = None
    jguard = JDivergenceGuard(spike_factor=10.0)
    jck = JCheckpointer(str(tmp_path / "jck"), save_every=2,
                        async_save=False)
    jt.fit(_PoisonOnce(JBatches(ids, vals, labels, 32, seed=7), at=7),
           checkpointer=jck, divergence_guard=jguard)
    jck.close()
    tr = _fm_trainer(spec, config)
    init = jspec.init(jax.random.key(config.seed))
    with torch.no_grad():
        for k, t in tr.params.items():
            t.copy_(torch.from_numpy(np.array(init[k])))
    guard = pdiv.DivergenceGuard(spike_factor=10.0)
    ck = Checkpointer(str(tmp_path / "ck"), save_every=2)
    tr.fit(_PoisonOnce(Batches(ids, vals, labels, 32, seed=7), at=7),
           checkpointer=ck, divergence_guard=guard)
    ck.close()
    assert tr.step_count == jt.step_count == 6
    assert guard.rollbacks == jguard.rollbacks == 1
    np.testing.assert_allclose(tr.loss_history, jt.loss_history, rtol=1e-5)
    for k in ("w0", "w", "v"):
        np.testing.assert_allclose(tr.params[k].numpy(),
                                   np.asarray(jt.params[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
