"""The port's supervisor (``fm_spark_tpu_torch/resilience/supervisor.py``)
against the reference's (``fm_spark_tpu/resilience/supervisor.py``), and
``FMTrainer.fit(supervisor=, elastic=)`` with ``fmtorch train
--supervise``.

- The same seeded backoff delays, breaker transitions and journal
  events, driven through ``run`` and ``recover`` on both packages with
  the same scripted failures, probes and a no-op sleep.
- The probe: the CPU answers, an injected ``probe`` fault is unhealthy,
  and a probe whose launch raises (a lost CUDA context) opens the
  breaker at once: the port's deliberate divergence.
- Which errors are device losses: the reference's vocabulary, CUDA's own
  texts for a card that is gone, and never a program error.
- A supervised run with an injected device loss ends bit for bit where
  the uninterrupted run ends (losses, params, the chain), with the
  reference's guards; the elastic controller re-normalizes the logger's
  chips on a permanent fault.
"""

import io
import json
import os

import numpy as np
import pytest
import torch

from fm_spark_tpu.resilience import supervisor as jsup
from fm_spark_tpu_torch import cli
from fm_spark_tpu_torch.resilience import faults
from fm_spark_tpu_torch.resilience import supervisor as psup
from fm_spark_tpu_torch.utils.logging import read_events


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    from fm_spark_tpu.resilience import faults as jfaults

    for mod in (faults, jfaults):
        monkeypatch.delenv(mod.ENV_PLAN, raising=False)
        mod.clear()
    monkeypatch.delenv("FM_SPARK_TEST_SLEEP_SCALE", raising=False)
    yield
    faults.clear()
    jfaults.clear()


class _Journal:
    def __init__(self):
        self.records = []

    def emit(self, event, **fields):
        self.records.append({"event": event, **fields})


def _loss(n=0):
    return RuntimeError(f"INTERNAL: device lost / attachment detached "
                        f"(occurrence {n})")


# ------------------------------------------------------------- the classes


@pytest.mark.parametrize("policy", [
    dict(), dict(initial=0.5, multiplier=3.0, max_delay=4.0, jitter=0.25),
    dict(jitter=0.0, max_delay=2.0)])
@pytest.mark.parametrize("seed", [0, 7])
def test_backoff_delays_match_the_reference(policy, seed):
    import random

    a, b = random.Random(seed), random.Random(seed)
    pj, pp = jsup.BackoffPolicy(**policy), psup.BackoffPolicy(**policy)
    assert [pp.delay(k, b) for k in range(1, 9)] == [
        pj.delay(k, a) for k in range(1, 9)]
    assert pp.delay(3) == pj.delay(3)


def _drive_run(mod, script, breaker=3, probes=None, attempts=4):
    """``Supervisor.run`` over ``script`` (one outcome per call: an
    exception to raise or a value), probes answering ``probes`` in turn.
    Returns the journal, the outcome and the breaker's state."""
    journal, calls = _Journal(), iter(script)
    probe_iter = iter(probes or [True] * 100)
    sup = mod.Supervisor(policy=mod.BackoffPolicy(max_attempts=attempts),
                         journal=journal, probe=lambda: next(probe_iter),
                         sleep=lambda s: None, breaker_threshold=breaker,
                         seed=3)

    def op():
        x = next(calls)
        if isinstance(x, BaseException):
            raise x
        return x

    outcomes = []
    for _ in range(3):
        try:
            outcomes.append(("ok", sup.run(op, op="leg")))
        except (mod.RetriesExhausted, mod.CircuitOpen) as e:
            outcomes.append((type(e).__name__, str(e)))
        except ValueError as e:
            outcomes.append(("ValueError", str(e)))
        except StopIteration:
            break
    return (journal.records, outcomes, sup.state, sup.health_verdict(),
            sup.total_failures, sup.permanent())


@pytest.mark.parametrize("name,script,probes", [
    ("flap", [_loss(1), _loss(2), 5, 6], None),
    ("program error", [ValueError("shape mismatch"), 1, 2], None),
    ("permanent", [_loss(1), _loss(2), _loss(3), _loss(4)] * 3, None),
    ("mixed", [_loss(1), RuntimeError("device unavailable"), _loss(3),
               RuntimeError("transport closed")] * 3, None),
    ("half open", [_loss(1)] * 12 + [7], [True, True, False, True] * 10),
])
def test_run_journals_and_breaker_match_the_reference(name, script, probes):
    want = _drive_run(jsup, list(script), probes=probes)
    got = _drive_run(psup, list(script), probes=probes)
    assert got == want


@pytest.mark.parametrize("errors,breaker", [
    ([_loss(i) for i in range(1, 5)], 3),
    ([_loss(1), RuntimeError("tpu driver reset"), _loss(3)], 3),
    ([_loss(i) for i in range(1, 3)], 2),
])
def test_recover_matches_the_reference(errors, breaker):
    out = []
    for mod in (jsup, psup):
        journal = _Journal()
        sup = mod.Supervisor(policy=mod.BackoffPolicy(), journal=journal,
                             probe=lambda: True, sleep=lambda s: None,
                             breaker_threshold=breaker, seed=1)
        raised = None
        for e in errors:
            try:
                sup.recover("train", e)
            except mod.CircuitOpen as c:
                raised = str(c)
                break
        sup.reset("train")
        out.append((journal.records, raised, sup.state))
    assert out[1] == out[0]


def test_device_probe_on_the_cpu_and_its_fault_point():
    detail = {}
    assert psup.device_probe(5.0, "cpu", detail)
    assert detail == {"error": None, "context_lost": False,
                      "timed_out": False}
    faults.activate("probe@1=error")
    assert not psup.device_probe(5.0, "cpu", detail)
    assert detail["error"] is not None and not detail["context_lost"]
    if not torch.cuda.is_available():
        assert not psup.device_probe(5.0)       # no card to answer


def test_a_lost_context_opens_the_breaker_at_once(monkeypatch):
    """The port's divergence: a probe whose own launch raises (a sticky
    CUDA error) reports the context lost, and ``recover`` opens the
    breaker on the first loss instead of retrying into it."""
    def lost(timeout, device, detail):
        detail.update(error=RuntimeError("CUDA error: an illegal memory "
                                         "access was encountered"),
                      context_lost=True, timed_out=False)
        return False

    monkeypatch.setattr(psup, "device_probe", lost)
    journal = _Journal()
    sup = psup.Supervisor(journal=journal, sleep=lambda s: None)
    with pytest.raises(psup.CircuitOpen, match="context lost"):
        sup.recover("train", _loss())
    assert [r["event"] for r in journal.records] == [
        "failure", "probe", "circuit_open"]
    assert journal.records[1]["context_lost"] is True
    assert journal.records[2]["context_lost"] is True and sup.state == "open"


@pytest.mark.parametrize("text,loss", [
    ("INTERNAL: device lost / attachment detached", True),
    ("RuntimeError: tpu driver reset", True),
    ("CUDA error: uncorrectable ECC error encountered", True),
    ("CUDA error: CUDA-capable device(s) is/are busy or unavailable", True),
    ("CUDA error: no CUDA-capable device is detected", True),
    ("CUDA error: invalid argument", False),
    ("CUDA error: an illegal memory access was encountered", False),
    ("CUDA error: unspecified launch failure", False),
    ("CUDA out of memory. Tried to allocate 2.00 GiB", False),
    ("shape mismatch: [4, 8] vs [4, 9]", False),
])
def test_which_errors_are_device_losses(text, loss):
    """CUDA's texts for a card that is gone join the reference's
    vocabulary; a program error never does. Where the reference has the
    text, both packages agree."""
    from fm_spark_tpu.resilience.faults import is_device_loss as jloss

    assert faults.is_device_loss(RuntimeError(text)) == loss
    if "CUDA" not in text:
        assert jloss(RuntimeError(text)) == loss


# ----------------------------------------------------------- FMTrainer.fit


def _problem():
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.data import synthetic_ctr
    from fm_spark_tpu_torch.train import TrainConfig

    ids, vals, labels = synthetic_ctr(num_examples=512, num_features=64,
                                      nnz=5, seed=3)
    spec = models.FMSpec(num_features=64, rank=4, init_std=0.05)
    config = TrainConfig(num_steps=10, batch_size=32, learning_rate=0.1,
                         lr_schedule="constant", log_every=1)
    return spec, config, (ids, vals, labels)


def _trainer(spec, config, **kw):
    from fm_spark_tpu_torch.train import FMTrainer

    tr = FMTrainer(spec, config, device="cpu", **kw)
    tr.logger._stream = io.StringIO()
    return tr


def _sup(journal=None, breaker=3):
    return psup.Supervisor(policy=psup.BackoffPolicy(jitter=0.0),
                           journal=journal, probe=lambda: True,
                           sleep=lambda s: None, breaker_threshold=breaker)


@pytest.mark.parametrize("plan,save_every,prefetch", [
    ("train_step@6=device_loss", 2, 0),     # back to step 4
    ("train_step@6=device_loss", 4, 2),     # back to step 4, prefetched
    ("train_step@2=device_loss", 1000, 2),  # before any save: the seed
    ("train_step@3=device_loss;train_step@8=device_loss", 2, 2),
])
def test_supervised_fit_ends_bit_for_bit_where_the_run_does(
        tmp_path, plan, save_every, prefetch):
    """A device loss mid-run: the newest verified step (none: the seed's
    init and the rewound cursor) restored into the trainer's tensors,
    and the run ends on the uninterrupted run's losses and params."""
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.data import Batches

    spec, config, (ids, vals, labels) = _problem()
    golden = _trainer(spec, config)
    golden.fit(Batches(ids, vals, labels, 32, seed=7))
    journal = _Journal()
    trainer = _trainer(spec, config)
    tensors = dict(trainer.params)
    ck = Checkpointer(str(tmp_path / "ck"), save_every=save_every)
    faults.activate(plan)
    trainer.fit(Batches(ids, vals, labels, 32, seed=7), checkpointer=ck,
                supervisor=_sup(journal), prefetch=prefetch)
    ck.close()
    assert all(trainer.params[k] is t for k, t in tensors.items())
    assert trainer.step_count == 10
    assert trainer.loss_history == golden.loss_history
    for k in ("w0", "w", "v"):
        assert torch.equal(trainer.params[k], golden.params[k]), k
    events = [r["event"] for r in journal.records]
    assert events.count("failure") == plan.count("device_loss")
    assert events[-1] == "recovered"


def test_the_reference_guards():
    from fm_spark_tpu_torch.data import Batches
    from fm_spark_tpu_torch.resilience import ElasticController

    spec, config, (ids, vals, labels) = _problem()
    trainer = _trainer(spec, config)
    with pytest.raises(ValueError, match="needs a checkpointer"):
        trainer.fit(Batches(ids, vals, labels, 32, seed=1),
                    supervisor=_sup())
    with pytest.raises(ValueError, match="elastic degraded mode needs a "
                                         "supervisor"):
        trainer.fit(Batches(ids, vals, labels, 32, seed=1),
                    elastic=ElasticController(devices=[0]))


def test_elastic_trainer_continues_past_a_permanent_fault(tmp_path):
    """The reference's drill: three identical losses open the breaker as
    permanent; the controller sheds capacity (2 → 1), the logger's
    per-chip rate re-normalizes, the breaker re-arms, and the run ends
    bit for bit where the uninterrupted one does."""
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.data import Batches
    from fm_spark_tpu_torch.resilience import ElasticController
    from fm_spark_tpu_torch.utils.logging import EventLog

    spec, config, (ids, vals, labels) = _problem()
    golden = _trainer(spec, config)
    golden.fit(Batches(ids, vals, labels, 32, seed=7))
    path = str(tmp_path / "h.jsonl")
    jlog = EventLog(path)
    elastic = ElasticController(devices=[0, 1], max_shrinks=1, journal=jlog)
    trainer = _trainer(spec, config, n_chips=elastic.n_chips)
    ck = Checkpointer(str(tmp_path / "ck"), save_every=2)
    faults.activate("train_step@5=device_loss;train_step@6=device_loss;"
                    "train_step@7=device_loss")
    trainer.fit(Batches(ids, vals, labels, 32, seed=7), checkpointer=ck,
                supervisor=_sup(jlog), elastic=elastic)
    ck.close()
    jlog.close()
    assert trainer.loss_history == golden.loss_history
    assert torch.equal(trainer.params["v"], golden.params["v"])
    assert elastic.degraded and elastic.shrinks == 1
    assert trainer.logger._n_chips == elastic.n_chips == 1
    events = [e["event"] for e in read_events(path)]
    assert {"circuit_open", "mesh_shrink", "supervisor_reset"} <= set(events)


# ------------------------------------------------------- fmtorch --supervise

_C2 = ["train", "--config", "criteo_kaggle_fm_r32", "--bucket", "64",
       "--synthetic", "3000", "--steps", "10", "--batch-size", "256",
       "--device", "cpu", "--checkpoint-every", "3", "--test-fraction", "0",
       "--obs-dir", "none"]


def test_cli_supervise_equals_the_uninterrupted_run(tmp_path, capsys,
                                                    monkeypatch):
    """``fmtorch train --supervise`` of config 2 (its one-card ``dp`` is
    the single step) with an injected device loss: the same losses, the
    same params.npz and final chain step as the uninterrupted command,
    the supervisor's events in ``health.jsonl``."""
    monkeypatch.setenv("FM_SPARK_TEST_SLEEP_SCALE", "0")
    runs = []
    for i, plan in enumerate((None, "train_step@6=device_loss")):
        if plan:
            faults.activate(plan)
        ck, model = str(tmp_path / f"ck{i}"), str(tmp_path / f"m{i}")
        assert cli.main(_C2 + ["--checkpoint-dir", ck, "--model-out", model]
                        + (["--supervise"] if plan else [])) == 0
        cap = capsys.readouterr()
        losses = {}
        for x in cap.out.splitlines():
            d = json.loads(x)
            if "loss" in d:
                losses[d["step"]] = d["loss"]
        runs.append((ck, model, losses,
                     json.loads(cap.err.strip().splitlines()[-1])))
    (ck0, m0, l0, _), (ck1, m1, l1, summary) = runs
    assert l1 == l0 and sorted(l0) == list(range(1, 11))
    with np.load(os.path.join(m0, "params.npz")) as a, \
            np.load(os.path.join(m1, "params.npz")) as b:
        assert all(np.array_equal(a[k], b[k]) for k in a.files)
    with open(os.path.join(ck0, "10", "state.json")) as f0, \
            open(os.path.join(ck1, "10", "state.json")) as f1:
        assert json.load(f0)["pipeline"] == json.load(f1)["pipeline"]
    events = [e["event"] for e in read_events(os.path.join(ck1,
                                                           "health.jsonl"))]
    assert {"failure", "probe", "backoff", "recovered"} <= set(events)
    assert summary["supervisor"] == {"verdict": "healthy", "failures": 1}


@pytest.mark.parametrize("extra,match", [
    (["--config", "criteo1tb_fm_r64", "--checkpoint-dir", "CK"],
     "--supervise requires strategy 'single' and --checkpoint-dir"),
    ([], "--supervise requires strategy 'single' and --checkpoint-dir"),
])
def test_cli_supervise_guards(tmp_path, extra, match):
    argv = _C2 + [a.replace("CK", str(tmp_path / "ck")) for a in extra] + [
        "--supervise"]
    with pytest.raises(SystemExit, match=match):
        cli.main(argv)
