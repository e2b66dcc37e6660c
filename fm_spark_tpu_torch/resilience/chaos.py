"""Chaos campaign engine: seeded multi-fault schedules, a system-wide
invariant auditor, and automatic schedule minimization (the port of
``fm_spark_tpu/resilience/chaos.py``).

The resilience stack (supervisor, elastic/checkpoint chain, exactly-once
ingest) was only ever exercised by hand-authored SINGLE-fault scenarios,
but production faults arrive in combinations — a device loss during a
checkpoint commit while the quarantine breaker's window is nearly full.
This module is the missing harness layer on top of
:mod:`fm_spark_tpu_torch.resilience.faults`'s ``KNOWN_POINTS`` registry:

- :class:`ScheduleGenerator` — seeded sampling of multi-rule fault
  plans (the existing ``point@occurrence=action[:param]`` grammar),
  with scenario weights biased toward the nastiest interleavings:
  fault-during-recovery storms, faults inside the ``ckpt_commit``
  torn-save window, and corruption bursts pressed against the
  bad-record breaker window. Every schedule is a pure function of its
  seed — a verdict names the seed, and the seed replays the plan.

- :func:`run_schedule` — one short supervised training drill (the
  production ``FMTrainer.fit`` + ``StreamBatches`` + ``Checkpointer``
  + ``Supervisor`` stack) executed under a schedule, with stubbed
  sleeps so a campaign costs compute, not wall-clock.
  :func:`write_worker` / the subprocess runner cover the
  process-fatal actions (``exit``/``sigterm``/never-returning hangs)
  plus cross-process occurrence counters via ``FM_SPARK_FAULTS_STATE``.

- :func:`audit` — the invariant auditor, judging from artifacts alone:
  exactly-once record stream (the drilled tap bit-identical to the
  clean run's, or to a pure-Python oracle for quarantine schedules),
  checkpoint-chain integrity (a fresh ``last_good`` walk-back must
  restore, never a torn state), loss continuity and final-state
  identity after every recovery, health-journal/flight monotonicity,
  hang liveness (the :mod:`~fm_spark_tpu_torch.resilience.watchdog`
  verdicts), breaker-abort discipline, and quarantine accounting.

- :func:`minimize` — delta-debugs a failing schedule down to a minimal
  reproducible plan string (greedy ddmin over rules; every candidate
  re-runs the drill, so the minimal plan is *verified* failing).

- :func:`run_campaign` — N seeded schedules under a time budget,
  producing one machine-readable verdict dict (``python -m
  fm_spark_tpu_torch.tools.chaos_drill`` writes it to
  ``artifacts/obs/<run_id>/chaos_verdict.json``). The tier-1 bounded
  soak in tests/test_torch_chaos.py runs this deterministically.

The regression-canary hook (``DrillConfig.break_restore``) deliberately
breaks the resume path — restore stops rewinding the stream cursor — so
the suite can prove the auditor CATCHES a broken recovery and the
minimizer reduces the catch to a 1–2 rule plan.

The port's differences: every runner takes ``device`` (the card unless
``device="cpu"``; :func:`~fm_spark_tpu_torch.resolve_device` raises
:class:`~fm_spark_tpu_torch.DeviceUnavailable` rather than falling back),
the trainer's first step captures a CUDA graph bound to its tensors (a
hang drill warms it up before arming the deadlines and re-initialises in
place), a checkpoint's file write runs in the background (a fault in the
commit window surfaces at the next save's join, not at the step that
wrote it), and each drill frees its trainer's graphs before the next.
Plans, scenarios, invariants, violation texts and verdict keys are the
reference's.
"""

from __future__ import annotations

import dataclasses
import os
import random
import subprocess
import sys
import threading
import time
import zlib

from fm_spark_tpu_torch.resilience import faults, watchdog
from fm_spark_tpu_torch.utils.logging import EventLog, read_events

__all__ = [
    "DrillConfig",
    "DrillResult",
    "Schedule",
    "ScheduleGenerator",
    "audit",
    "audit_disk",
    "audit_fleet",
    "audit_serve_events",
    "build_shards",
    "disk_schedule",
    "fleet_schedule",
    "golden_run",
    "minimize",
    "oracle_tap",
    "partition_schedule",
    "run_campaign",
    "run_disk_campaign",
    "run_disk_schedule",
    "run_fleet_campaign",
    "run_fleet_schedule",
    "run_gc_kill_drill",
    "run_partition_campaign",
    "run_partition_schedule",
    "run_schedule",
    "serve_schedule",
    "write_worker",
]

_REPO = os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))

#: Fault→watchdog phase mapping for hang scenarios.
_HANG_PHASE = {"ingest_truncate": "ingest_chunk",
               "ckpt_commit": "ckpt_commit",
               "train_step": "step_window"}

#: Hang drills: injected sleep vs armed deadline. The margin (6x over
#: the deadline, and the deadline 10x over a normal CPU step) keeps the
#: verdict deterministic on a loaded CI host; the card's clean windows
#: at config 2's widths are measured against it by chip_smoke.py.
_HANG_SLEEP_S = 0.3
_HANG_DEADLINE_S = 0.05


@dataclasses.dataclass(frozen=True)
class DrillConfig:
    """One drill's workload shape — small enough that a campaign of ~25
    schedules fits a tier-1 budget, big enough to cross three epochs,
    several checkpoint commits, and every recovery path."""

    steps: int = 18
    batch_size: int = 16
    num_features: int = 128
    rank: int = 4
    max_nnz: int = 3
    n_shards: int = 3
    rows_per_shard: int = 32
    chunk_bytes: int = 64
    save_every: int = 6
    seed: int = 7
    learning_rate: float = 0.1
    guard_window: int = 32
    guard_min_records: int = 16
    #: Regression canary: when True, the drilled
    #: batch source's ``restore()`` no longer rewinds the stream cursor
    #: — the exact bug class the exactly-once invariant exists to
    #: catch. Never set outside canary tests/drills.
    break_restore: bool = False
    #: Subprocess drills only: the worker's flight-recorder ring size
    #: (small so the spool's 2N compaction threshold is reachable
    #: inside a short drill).
    flight_capacity: int = 256

    @property
    def total_rows(self) -> int:
        return self.n_shards * self.rows_per_shard


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One seeded multi-fault plan plus the audit contract it carries.

    ``stream_comparable``: no rule consumes records, so the drilled tap
    must be bit-identical to the clean run's. ``oracle_comparable``:
    quarantine-only rules with no recovery — the tap must match the
    pure-Python :func:`oracle_tap`. ``expects`` is the outcome verdict
    the auditor holds the run to (``completed`` / ``hang_detected`` /
    ``ingest_aborted``).
    """

    seed: int
    scenario: str
    rules: tuple[str, ...]
    expects: str = "completed"
    stream_comparable: bool = True
    oracle_comparable: bool = False
    max_bad_frac: float = 1.0

    @property
    def plan(self) -> str:
        return ";".join(self.rules)

    def validate(self) -> "Schedule":
        faults.FaultPlan.from_spec(self.plan)  # eager registry check
        return self


class ScheduleGenerator:
    """Deterministic seeded sampler over multi-fault scenarios.

    ``schedule(seed)`` is a pure function of the seed: the same seed
    always yields the same plan, which is what makes a chaos verdict
    replayable ("seed 17 failed" IS the repro). Weights are biased
    toward the interleavings the single-fault suites never compose:

    ======================  ==============================================
    ``commit_loss``          device loss inside the ``ckpt_commit``
                             torn-save window (± a mid-step loss)
    ``recovery_storm``       consecutive losses — the second fault lands
                             DURING recovery of the first (± a probe
                             fault while the breaker is arming)
    ``truncate_loss``        device loss on the shard chunk read (± a
                             mid-step loss): ingest-side recovery
    ``corrupt_burst``        scattered corruption through quarantine,
                             below the breaker threshold
    ``ingest_abort``         a corruption burst pressed into one breaker
                             window — the run must abort LOUDLY
    ``hang``                 a finite hang at one guarded phase — the
                             deadline watchdog must convert it into a
                             structured ``HangDetected``
    ``compound``             corruption + device loss + commit-window
                             loss in one plan
    ======================  ==============================================
    """

    _SCENARIOS = (
        ("commit_loss", 18),
        ("recovery_storm", 18),
        ("corrupt_burst", 16),
        ("truncate_loss", 14),
        ("hang", 12),
        ("ingest_abort", 12),
        ("compound", 10),
    )

    def __init__(self, cfg: DrillConfig | None = None):
        self.cfg = cfg or DrillConfig()

    def _pick_scenario(self, rng: random.Random) -> str:
        total = sum(w for _, w in self._SCENARIOS)
        roll = rng.random() * total
        for name, w in self._SCENARIOS:
            roll -= w
            if roll < 0:
                return name
        return self._SCENARIOS[-1][0]

    def schedule(self, seed: int) -> Schedule:
        rng = random.Random(int(seed))
        cfg = self.cfg
        scenario = self._pick_scenario(rng)
        mid = max(cfg.steps - 2, 2)
        if scenario == "commit_loss":
            rules = [f"ckpt_commit@{rng.randint(1, 2)}=device_loss"]
            if rng.random() < 0.7:
                rules.append(
                    f"train_step@{rng.randint(2, mid)}=device_loss")
            sched = Schedule(seed, scenario, tuple(rules))
        elif scenario == "recovery_storm":
            k = rng.randint(2, mid - 1)
            rules = [f"train_step@{k}=device_loss",
                     f"train_step@{k + 1}=device_loss"]
            if rng.random() < 0.4:
                rules.append("probe@1=device_loss")
            sched = Schedule(seed, scenario, tuple(rules))
        elif scenario == "truncate_loss":
            rules = [f"ingest_truncate@{rng.randint(2, 10)}=device_loss"]
            if rng.random() < 0.5:
                rules.append(
                    f"train_step@{rng.randint(2, mid)}=device_loss")
            sched = Schedule(seed, scenario, tuple(rules))
        elif scenario == "corrupt_burst":
            n = rng.randint(1, 3)
            occs = sorted(rng.sample(range(2, 140), n))
            rules = [f"ingest_corrupt@{o}=error" for o in occs]
            sched = Schedule(seed, scenario, tuple(rules),
                             stream_comparable=False,
                             oracle_comparable=True, max_bad_frac=0.5)
        elif scenario == "ingest_abort":
            # The breaker-pressure interleaving: a burst of consecutive
            # corrupt records inside ONE trailing window, past the
            # configured rate — silent continuation here would mean
            # training on a truncated/garbage shard.
            start = rng.randint(cfg.guard_min_records + 2, 80)
            n = rng.randint(5, 8)
            rules = [f"ingest_corrupt@{start + i}=error"
                     for i in range(n)]
            sched = Schedule(seed, scenario, tuple(rules),
                             expects="ingest_aborted",
                             stream_comparable=False, max_bad_frac=0.1)
        elif scenario == "hang":
            point = rng.choice(tuple(_HANG_PHASE))
            occ = {"ingest_truncate": rng.randint(1, 5),
                   "ckpt_commit": 1,
                   "train_step": rng.randint(2, mid)}[point]
            rules = [f"{point}@{occ}=hang:{_HANG_SLEEP_S}"]
            sched = Schedule(seed, scenario, tuple(rules),
                             expects="hang_detected",
                             stream_comparable=False)
        else:  # compound
            rules = [f"ingest_corrupt@{rng.randint(2, 100)}=error",
                     f"train_step@{rng.randint(2, mid)}=device_loss"]
            if rng.random() < 0.5:
                rules.append(
                    f"ckpt_commit@{rng.randint(1, 2)}=device_loss")
            if rng.random() < 0.3:
                rules.append(
                    f"ingest_corrupt@{rng.randint(101, 200)}=error")
            sched = Schedule(seed, scenario, tuple(rules),
                             stream_comparable=False, max_bad_frac=0.5)
        return sched.validate()

    def sample(self, seeds) -> list[Schedule]:
        return [self.schedule(s) for s in seeds]


# ---------------------------------------------------------------- workload


def build_shards(shard_dir: str, cfg: DrillConfig) -> list[str]:
    """Deterministic libsvm text shards: row ``n`` (global, 0-based)
    carries first feature id ``n+1`` (1-based in the file), so the
    drilled tap — the first 0-based id of every admitted row — IS the
    global record index, and exactly-once is directly readable."""
    os.makedirs(shard_dir, exist_ok=True)
    paths = []
    for s in range(cfg.n_shards):
        path = os.path.join(shard_dir, f"shard{s}.svm")
        lines = []
        for r in range(cfg.rows_per_shard):
            n = s * cfg.rows_per_shard + r
            second = cfg.rows_per_shard * cfg.n_shards + 1 + (n % 31)
            lines.append(f"{n % 2} {n + 1}:1.0 {second}:0.5\n")
        with open(path, "w") as f:
            f.write("".join(lines))
        paths.append(path)
    return paths


class _TapSource:
    """Batch-source wrapper recording the COMMITTED record stream (the
    first feature id of every trained row, one line per batch) — the
    artifact the exactly-once invariant compares.

    The tap length rides the cursor (``tap_len``) and restore truncates
    the recording: batches emitted after the checkpoint a recovery
    rewound to were never committed into the final state, so keeping
    them would make an honest replay read as a duplicate. (Extra cursor
    keys are ignored by ``StreamBatches.restore`` by design.)

    ``break_restore`` is the regression canary: restore stops rewinding
    the wrapped source — exactly the resume bug the auditor must
    catch."""

    def __init__(self, source, break_restore: bool = False):
        self._source = source
        self._break = bool(break_restore)
        self.lines: list[str] = []

    @property
    def guard(self):
        return self._source.guard

    def next_batch(self):
        ids, vals, labels, w = self._source.next_batch()
        self.lines.append(
            ",".join(str(int(x)) for x in ids[w > 0][:, 0]))
        return ids, vals, labels, w

    def state(self):
        return dict(self._source.state(), tap_len=len(self.lines))

    def restore(self, s):
        if self._break:
            return  # canary: the cursor silently stays wherever it was
        self._source.restore(s)
        del self.lines[int(s.get("tap_len", 0)):]

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


@dataclasses.dataclass
class DrillResult:
    """Everything the auditor needs, collected from one drilled run."""

    outcome: str
    error: str | None
    steps_done: int
    loss_history: list
    params_sums: dict | None
    tap: list
    cursor: dict | None
    counters: dict
    duration_s: float
    workdir: str
    health_path: str
    deadletter_path: str
    ckpt_dir: str
    rcs: tuple = ()
    resumed_at: tuple = ()


def _leaves(tree, prefix=""):
    """``(keystr, leaf)`` pairs of a nested dict, keys sorted as JAX's
    tree flattening orders them and named as ``jax.tree_util.keystr``
    names them (``['v']``, ``['opt']['m']``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def _params_sums(params) -> dict:
    """Per-leaf crc32 identity of a params tree (the byte-level
    final-state fingerprint the identity invariant compares). Leaves
    are tensors (on any device) or numpy arrays; a bf16 tensor is
    fingerprinted by its 16-bit patterns."""
    import numpy as np
    import torch

    out = {}
    for path, leaf in _leaves(params):
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().cpu()
            if t.dtype == torch.bfloat16:
                t = t.view(torch.int16)
            leaf = t.numpy()
        arr = np.ascontiguousarray(np.asarray(leaf))
        out[path] = (
            f"{arr.dtype.str}:{arr.shape}:{zlib.crc32(arr.tobytes()):08x}"
        )
    return out


def _classify_outcome(exc: BaseException) -> str:
    from fm_spark_tpu_torch.data.stream import IngestAborted
    from fm_spark_tpu_torch.resilience.supervisor import (
        CircuitOpen,
        RetriesExhausted,
    )

    if isinstance(exc, watchdog.HangDetected):
        return "hang_detected"
    if isinstance(exc, IngestAborted):
        return "ingest_aborted"
    if isinstance(exc, CircuitOpen):
        return "circuit_open"
    if isinstance(exc, RetriesExhausted):
        return "retries_exhausted"
    return f"error:{type(exc).__name__}"


def _free(trainer) -> None:
    """Drop a finished drill's trainer state from the device: its
    captured graphs (and with them their memory pool) and its params and
    optimizer state, so a campaign's card memory stays flat over its
    drills. The trainer must not train again."""
    import gc

    import torch

    trainer._train_step.captured.reset()
    trainer.params = trainer.opt_state = None
    gc.collect()
    if trainer.device.type == "cuda":
        torch.cuda.empty_cache()


def run_schedule(schedule: "Schedule | str", cfg: DrillConfig,
                 workdir: str, shard_paths=None,
                 device=None) -> DrillResult:
    """Run one drill in-process under ``schedule``'s fault plan on
    ``device`` (the card unless ``device="cpu"``).

    The drilled stack is the production one: ``ShardReader`` +
    ``RecordGuard(quarantine)`` + ``StreamBatches`` feeding
    ``FMTrainer.fit`` with a crash-consistent ``Checkpointer`` and a
    ``Supervisor`` (stubbed sleep, real probe machinery). Hang
    schedules additionally arm the deadline watchdog in ``raise`` mode
    (deterministic, thread-free). Fault state is module-local and
    cleared on exit, so drills compose with any caller. The trainer's
    graphs and tensors are freed before this returns.
    """
    import torch

    from fm_spark_tpu_torch import models, resolve_device
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.data.stream import (
        RecordGuard,
        ShardReader,
        StreamBatches,
        line_parser,
    )
    from fm_spark_tpu_torch.resilience.supervisor import (
        BackoffPolicy,
        Supervisor,
    )
    from fm_spark_tpu_torch.train import FMTrainer, TrainConfig
    from fm_spark_tpu_torch.utils.logging import MetricsLogger

    dev = resolve_device(device)
    if isinstance(schedule, str):
        schedule = Schedule(seed=-1, scenario="adhoc",
                            rules=tuple(r for r in schedule.split(";")
                                        if r.strip()))
    os.makedirs(workdir, exist_ok=True)
    if shard_paths is None:
        shard_paths = build_shards(os.path.join(workdir, "shards"), cfg)
    ck_dir = os.path.join(workdir, "ck")
    q_dir = os.path.join(workdir, "q")
    health_path = os.path.join(workdir, "health.jsonl")
    journal = EventLog(health_path)

    spec = models.FMSpec(num_features=cfg.num_features, rank=cfg.rank,
                         init_std=0.05)
    config = TrainConfig(num_steps=cfg.steps, batch_size=cfg.batch_size,
                         learning_rate=cfg.learning_rate,
                         lr_schedule="constant", log_every=1,
                         seed=cfg.seed)
    guard = RecordGuard("quarantine", quarantine_dir=q_dir,
                        max_bad_frac=schedule.max_bad_frac,
                        window=cfg.guard_window,
                        min_records=cfg.guard_min_records,
                        journal=journal)
    source = _TapSource(
        StreamBatches(ShardReader(shard_paths,
                                  chunk_bytes=cfg.chunk_bytes),
                      line_parser("libsvm"), cfg.batch_size,
                      cfg.max_nnz, guard=guard,
                      num_features=cfg.num_features),
        break_restore=cfg.break_restore)
    ck = Checkpointer(ck_dir, save_every=cfg.save_every, journal=journal)
    sup = Supervisor(
        policy=BackoffPolicy(initial=0.01, jitter=0.0, max_delay=0.05),
        journal=journal, probe_timeout=10.0, breaker_threshold=8,
        sleep=lambda s: None, device=dev)

    trainer = FMTrainer(spec, config, device=dev)
    # Drills are quiet: metrics go to a per-drill file, not stdout
    # (25 schedules x 18 steps of JSON would drown a campaign log).
    trainer.logger.close()
    trainer.logger = MetricsLogger(
        path=os.path.join(workdir, "metrics.jsonl"))
    trainer.logger._stream = None

    hang_rules = [r for r in schedule.rules if "=hang" in r]
    if hang_rules:
        # Warm the step BEFORE arming deadlines: the first call builds
        # the kernels and, on the card, captures the step's graph (seconds
        # there, hundreds of ms of eager dispatch on the CPU), which must
        # never read as a hang. The graph is bound to the trainer's
        # tensors, so they are re-initialised in place, deterministically.
        b, s = cfg.batch_size, cfg.max_nnz
        trainer._train_step(
            trainer.params, trainer.opt_state,
            torch.zeros((b, s), dtype=torch.int32, device=dev),
            torch.zeros((b, s), dtype=torch.float32, device=dev),
            torch.zeros((b,), dtype=torch.float32, device=dev),
            torch.zeros((b,), dtype=torch.float32, device=dev))
        trainer._reinit()
        deadlines = {_HANG_PHASE[r.split("@", 1)[0]]: _HANG_DEADLINE_S
                     for r in hang_rules}
        watchdog.configure(deadlines, action="raise", journal=journal)

    t0 = time.perf_counter()
    outcome, error = "completed", None
    try:
        faults.clear()
        if schedule.plan:
            faults.activate(schedule.plan)
        trainer.fit(source, checkpointer=ck, supervisor=sup)
    except Exception as e:  # noqa: BLE001 — the outcome IS the verdict
        outcome = _classify_outcome(e)
        error = f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:200]}"
    finally:
        faults.clear()
        if hang_rules:
            watchdog.clear()
        try:
            ck.close()
        except Exception:
            pass
        guard.close()
        journal.close()
        trainer.logger.close()

    result = DrillResult(
        outcome=outcome, error=error, steps_done=trainer.step_count,
        loss_history=list(trainer.loss_history),
        params_sums=(_params_sums(trainer.params)
                     if outcome == "completed" else None),
        tap=list(source.lines),
        cursor=(dict(source.state()) if outcome == "completed" else None),
        counters=guard.counters(),
        duration_s=time.perf_counter() - t0,
        workdir=workdir, health_path=health_path,
        deadletter_path=os.path.join(
            q_dir, "deadletter.jsonl"),
        ckpt_dir=ck_dir,
    )
    _free(trainer)
    return result


def golden_run(cfg: DrillConfig, workdir: str,
               shard_paths=None, device=None) -> DrillResult:
    """The clean (no-fault) reference run every comparable invariant is
    judged against."""
    clean = dataclasses.replace(cfg, break_restore=False)
    return run_schedule(Schedule(seed=-1, scenario="golden", rules=()),
                        clean, workdir, shard_paths=shard_paths,
                        device=device)


# ----------------------------------------------------------------- oracle


def oracle_tap(schedule: Schedule, cfg: DrillConfig) -> list[str]:
    """Pure-Python prediction of the admitted record stream for a
    quarantine-only schedule (no recovery/kill rules): the ``k``-th
    parse attempt is quarantined iff the plan names occurrence ``k``.
    Replays ``StreamBatches``'s batch/epoch mechanics exactly —
    fixed-size batches, the epoch's final partial batch emitted padded
    — without torch, so the oracle cannot inherit a bug from the code
    under audit."""
    bad = set()
    for rule in schedule.rules:
        point, _, rest = rule.partition("@")
        if point == "ingest_corrupt":
            bad.add(int(rest.split("=", 1)[0]))
    taps: list[str] = []
    batch: list[int] = []
    k = 0
    while len(taps) < cfg.steps:
        for n in range(cfg.total_rows):  # one epoch, in stream order
            k += 1
            if k in bad:
                continue
            batch.append(n)
            if len(batch) == cfg.batch_size:
                taps.append(",".join(map(str, batch)))
                batch = []
                if len(taps) == cfg.steps:
                    return taps
        if batch:  # the epoch's final partial batch, padded at runtime
            taps.append(",".join(map(str, batch)))
            batch = []
    return taps


# ---------------------------------------------------------------- auditor


def _violation(invariant: str, detail: str) -> dict:
    return {"invariant": invariant, "detail": detail}


def _audit_chain(result: DrillResult, cfg: DrillConfig) -> list[dict]:
    """The checkpoint chain must restore through ``last_good`` without
    ever yielding a torn state — checked with a FRESH Checkpointer, the
    way a real recovery would. (The port's chain is keyed by name, so
    the restore needs no params or optimizer-state example: the arrays
    come back on the host, whatever device trained them.)"""
    from fm_spark_tpu_torch.checkpoint import Checkpointer

    out: list[dict] = []
    if not os.path.isdir(result.ckpt_dir):
        return out
    ck = Checkpointer(result.ckpt_dir, save_every=cfg.save_every)
    try:
        if ck.latest_step() is None:
            return out  # the run died before any commit — nothing owed
        try:
            restored = ck.restore()
        except Exception as e:  # noqa: BLE001 — a broken chain IS the finding
            out.append(_violation(
                "chain_integrity",
                f"last_good walk-back failed: {type(e).__name__}: "
                f"{(str(e).splitlines() or [''])[0][:160]}"))
            return out
        last_good = ck.last_good_step()
        if restored is None:
            out.append(_violation("chain_integrity",
                                  "steps exist but restore returned None"))
        elif last_good is not None and restored["step"] < last_good:
            out.append(_violation(
                "chain_integrity",
                f"restored step {restored['step']} behind last_good "
                f"{last_good} — the pointer vouches for a state the "
                "chain cannot produce"))
    finally:
        try:
            ck.close()
        except Exception:
            pass
    return out


def _audit_journal(result: DrillResult) -> list[dict]:
    """Every journal line must parse and timestamps must be
    monotonically non-decreasing (a torn tail is only legal after an
    uncatchable kill, which the in-process drill never performs)."""
    out: list[dict] = []
    try:
        with open(result.health_path) as f:
            raw = [ln for ln in f.read().splitlines() if ln.strip()]
    except OSError:
        return out
    events = read_events(result.health_path)
    if len(events) != len(raw):
        out.append(_violation(
            "journal_monotonic",
            f"{len(raw) - len(events)} unparseable journal line(s) in "
            "an uninterrupted run"))
    ts = [e.get("ts") for e in events if isinstance(e.get("ts"),
                                                    (int, float))]
    if any(b < a for a, b in zip(ts, ts[1:])):
        out.append(_violation("journal_monotonic",
                              "journal timestamps went backwards"))
    return out


def audit(schedule: Schedule, result: DrillResult,
          golden: DrillResult, cfg: DrillConfig) -> list[dict]:
    """Every violated invariant, as ``{"invariant", "detail"}`` dicts
    (empty = the schedule is green). Which invariants apply follows
    from the schedule's contract — see :class:`Schedule`."""
    v: list[dict] = []
    events = read_events(result.health_path)
    kinds = [e.get("event") for e in events]

    if result.outcome != schedule.expects:
        v.append(_violation(
            "completion",
            f"expected outcome {schedule.expects!r}, got "
            f"{result.outcome!r} ({result.error})"))
    elif schedule.expects == "completed":
        if result.steps_done != cfg.steps:
            v.append(_violation(
                "completion",
                f"run ended at step {result.steps_done} of {cfg.steps}"))
        if any(not (x == x and abs(x) < float("inf"))
               for x in result.loss_history):
            v.append(_violation("completion",
                                "non-finite loss in a completed run"))

    if schedule.stream_comparable and schedule.expects == "completed":
        if result.tap != golden.tap:
            first = next((i for i, (a, b) in
                          enumerate(zip(result.tap, golden.tap))
                          if a != b), min(len(result.tap),
                                          len(golden.tap)))
            v.append(_violation(
                "exactly_once_stream",
                f"record stream diverges from the clean run at batch "
                f"{first} ({len(result.tap)} vs {len(golden.tap)} "
                "batches) — records replayed or skipped"))
        if result.loss_history != golden.loss_history:
            v.append(_violation(
                "loss_continuity",
                "loss curve differs from the clean run after recovery"))
        if (result.params_sums is not None
                and result.params_sums != golden.params_sums):
            v.append(_violation(
                "state_identity",
                "final params differ byte-wise from the clean run"))
        if result.cursor is not None and golden.cursor is not None:
            if result.cursor != golden.cursor:
                v.append(_violation(
                    "state_identity",
                    f"final cursor {result.cursor} != clean "
                    f"{golden.cursor}"))

    if schedule.oracle_comparable and schedule.expects == "completed":
        expected = oracle_tap(schedule, cfg)
        if result.tap != expected:
            first = next((i for i, (a, b) in
                          enumerate(zip(result.tap, expected))
                          if a != b), min(len(result.tap),
                                          len(expected)))
            v.append(_violation(
                "exactly_once_oracle",
                f"admitted stream diverges from the quarantine oracle "
                f"at batch {first}"))

    # Quarantine accounting: the guard's counters, the dead-letter
    # journal, and the checkpointed cursor must tell one story. The
    # dead-letter journal is APPEND-ONLY across recovery rollbacks
    # (a record quarantined before a rollback keeps its dead letter
    # even though the counter honestly rewinds with the cursor), so
    # the journal bounds the counter from above; without any rollback
    # they must be equal.
    dead = read_events(result.deadletter_path)
    n_dead = sum(1 for e in dead if e.get("event") == "bad_record")
    rolled_back = any(k in ("failure", "supervisor_reset")
                      for k in kinds)
    n_bad = result.counters.get("bad", 0)
    if (n_bad > n_dead) or (not rolled_back and n_bad != n_dead):
        v.append(_violation(
            "quarantine_accounting",
            f"guard counted {n_bad} bad vs {n_dead} dead-letter "
            f"record(s) (rolled_back={rolled_back})"))
    if result.cursor is not None:
        for key in ("ok", "bad"):
            if result.cursor.get(key) != result.counters.get(key):
                v.append(_violation(
                    "quarantine_accounting",
                    f"cursor {key}={result.cursor.get(key)} vs guard "
                    f"{key}={result.counters.get(key)}"))

    if schedule.expects == "hang_detected":
        if "hang_detected" not in kinds:
            v.append(_violation(
                "hang_detection",
                "no hang_detected journal event — the watchdog verdict "
                "left no machine-readable trace"))
    if schedule.expects == "ingest_aborted":
        aborted = ("ingest_aborted" in kinds
                   or any(e.get("event") == "ingest_aborted"
                          for e in dead))
        if not aborted:
            v.append(_violation(
                "abort_detection",
                "breaker tripped without an ingest_aborted journal "
                "event"))

    v.extend(_audit_chain(result, cfg))
    v.extend(_audit_journal(result))
    return v


# -------------------------------------------------------------- minimizer


def minimize(rules, fails) -> tuple[str, ...]:
    """Greedy ddmin over a failing schedule's rules: repeatedly drop
    any single rule whose removal keeps ``fails(plan)`` true, until no
    rule can be dropped. Every candidate is re-run, so the returned
    minimal plan is VERIFIED still-failing — the reproducible repro the
    verdict publishes with its seed."""
    cur = list(rules)
    changed = True
    while changed and len(cur) > 1:
        changed = False
        for i in range(len(cur)):
            cand = cur[:i] + cur[i + 1:]
            if fails(";".join(cand)):
                cur = cand
                changed = True
                break
    return tuple(cur)


# --------------------------------------------------------------- campaign


class _MinimizeBudgetExhausted(RuntimeError):
    """The campaign budget ran out mid-ddmin; minimization is aborted
    (recorded on the failure entry), never silently overrun."""


def run_campaign(seeds, cfg: DrillConfig | None = None,
                 base_dir: str | None = None,
                 time_budget_s: float | None = None,
                 per_schedule_timeout_s: float | None = None,
                 minimize_failures: bool = True,
                 journal: EventLog | None = None,
                 device=None) -> dict:
    """Run one seeded campaign on ``device`` (the card unless
    ``device="cpu"``): golden run, then every seed's schedule, audited;
    failing schedules are delta-debugged to a minimal plan.

    Bounded: ``time_budget_s`` caps the whole campaign (schedules past
    the budget are recorded as skipped, never silently dropped), and
    ``per_schedule_timeout_s`` flags any drill that overran its slice
    (in-process drills cannot be preempted, so the flag is the audit
    signal). Returns the machine-readable verdict dict that
    :mod:`fm_spark_tpu_torch.tools.chaos_drill` persists as
    ``chaos_verdict.json``.
    """
    import tempfile

    from fm_spark_tpu_torch import resolve_device

    device = resolve_device(device)
    cfg = cfg or DrillConfig()
    base_dir = base_dir or tempfile.mkdtemp(prefix="chaos_")
    os.makedirs(base_dir, exist_ok=True)
    gen = ScheduleGenerator(cfg)
    t0 = time.perf_counter()

    def emit(event, **fields):
        if journal is not None:
            journal.emit(event, **fields)

    shard_paths = build_shards(os.path.join(base_dir, "shards"), cfg)
    emit("campaign_start", seeds=list(map(int, seeds)),
         steps=cfg.steps, canary=cfg.break_restore)
    golden = golden_run(cfg, os.path.join(base_dir, "golden"),
                        shard_paths=shard_paths, device=device)
    if golden.outcome != "completed":
        raise RuntimeError(
            f"golden (no-fault) drill failed: {golden.error} — the "
            "workload itself is broken; no schedule verdict is "
            "meaningful")

    entries: list[dict] = []
    failures: list[dict] = []
    budget_exhausted = False
    for seed in seeds:
        elapsed = time.perf_counter() - t0
        if time_budget_s is not None and elapsed > time_budget_s:
            budget_exhausted = True
            entries.append({"seed": int(seed), "plan": None,
                            "scenario": None,
                            "verdict": "skipped_budget",
                            "violations": []})
            continue
        sched = gen.schedule(seed)
        workdir = os.path.join(base_dir, f"s{int(seed)}")
        result = run_schedule(sched, cfg, workdir,
                              shard_paths=shard_paths, device=device)
        violations = audit(sched, result, golden, cfg)
        overran = (per_schedule_timeout_s is not None
                   and result.duration_s > per_schedule_timeout_s)
        if overran:
            violations.append(_violation(
                "schedule_timeout",
                f"drill took {result.duration_s:.2f}s > "
                f"{per_schedule_timeout_s:.2f}s slice"))
        entry = {
            "seed": int(seed),
            "scenario": sched.scenario,
            "plan": sched.plan,
            "expects": sched.expects,
            "outcome": result.outcome,
            "verdict": "green" if not violations else "failed",
            "violations": violations,
            "duration_s": round(result.duration_s, 3),
            "quarantined": result.counters.get("bad", 0),
        }
        emit("schedule_verdict", **{k: entry[k] for k in
                                    ("seed", "scenario", "plan",
                                     "verdict", "outcome")})
        if violations:
            failure = dict(entry)
            if minimize_failures:
                rerun_idx = [0]

                def _fails(plan: str, _seed=seed, _sched=sched) -> bool:
                    # ddmin re-runs are bounded by the SAME campaign
                    # budget as the schedules themselves — a minimize
                    # pass must not silently double the advertised
                    # wall-clock.
                    if (time_budget_s is not None
                            and time.perf_counter() - t0
                            > time_budget_s):
                        raise _MinimizeBudgetExhausted()
                    rerun_idx[0] += 1
                    cand = dataclasses.replace(
                        _sched, rules=tuple(
                            r for r in plan.split(";") if r))
                    r = run_schedule(
                        cand, cfg,
                        os.path.join(base_dir,
                                     f"s{int(_seed)}_min{rerun_idx[0]}"),
                        shard_paths=shard_paths, device=device)
                    return bool(audit(cand, r, golden, cfg))

                try:
                    minimal = minimize(sched.rules, _fails)
                    failure["minimized_plan"] = ";".join(minimal)
                    failure["minimized_rules"] = len(minimal)
                    entry["minimized_plan"] = failure["minimized_plan"]
                except _MinimizeBudgetExhausted:
                    budget_exhausted = True
                    failure["minimize_aborted_budget"] = True
            failures.append(failure)
        entries.append(entry)

    verdict = {
        "engine": "chaos-campaign/1",
        "seeds": [int(s) for s in seeds],
        "config": {
            "steps": cfg.steps, "batch_size": cfg.batch_size,
            "shards": cfg.n_shards,
            "rows_per_shard": cfg.rows_per_shard,
            "save_every": cfg.save_every, "canary": cfg.break_restore,
        },
        "n_schedules": len(entries),
        "n_green": sum(e["verdict"] == "green" for e in entries),
        "n_failed": len(failures),
        "n_skipped": sum(e["verdict"] == "skipped_budget"
                         for e in entries),
        "all_green": (not failures and not budget_exhausted
                      and bool(entries)),
        "budget_s": time_budget_s,
        "budget_exhausted": budget_exhausted,
        "total_s": round(time.perf_counter() - t0, 3),
        "schedules": entries,
        "failures": failures,
    }
    emit("campaign_end", all_green=verdict["all_green"],
         n_failed=verdict["n_failed"], total_s=verdict["total_s"])
    return verdict


# ------------------------------------------------------- subprocess drills

#: Worker script for process-fatal actions (exit / sigterm / real
#: never-returning hangs / SIGKILL from the parent): the same workload
#: as :func:`run_schedule` driven as a child process, with the fault
#: plan arriving via FM_SPARK_FAULTS and cross-process occurrence
#: counters via FM_SPARK_FAULTS_STATE. Emits one JSON line per step
#: (the parent's kill trigger) plus ``resumed_at`` / ``done`` markers.
#: The reference's fixed shape (128 features, rank 4, B from argv); the
#: port's one addition is the device (the last argument, ``cuda:N`` or
#: ``cpu``), resolved in the init window, so a worker asked for a card
#: it does not have raises DeviceUnavailable.
_WORKER_TEMPLATE = '''\
import json, os, sys

(workdir, steps, batch_size, save_every, flight_capacity,
 max_bad_frac, seed, attempt, device) = sys.argv[1:10]
steps, batch_size, seed = int(steps), int(batch_size), int(seed)

from fm_spark_tpu_torch import models, obs, resolve_device
from fm_spark_tpu_torch.checkpoint import Checkpointer
from fm_spark_tpu_torch.data.stream import (RecordGuard, ShardReader,
                                            StreamBatches, line_parser)
from fm_spark_tpu_torch.resilience import faults
from fm_spark_tpu_torch.resilience.chaos import _params_sums
from fm_spark_tpu_torch.resilience.supervisor import (BackoffPolicy,
                                                      Supervisor)
from fm_spark_tpu_torch.train import FMTrainer, TrainConfig
from fm_spark_tpu_torch.utils.logging import EventLog

obs.configure(os.path.join(workdir, "obs"), run_id="chaos-drill",
              flight_capacity=int(flight_capacity),
              install_signals=True)
faults.inject("backend_init")   # the init-window fault point
dev = resolve_device(device)

shard_dir = os.path.join(workdir, "shards")
paths = sorted(os.path.join(shard_dir, f)
               for f in os.listdir(shard_dir))
journal = EventLog(os.path.join(workdir, "health.jsonl"),
                   mirror_to_flight=True)
guard = RecordGuard("quarantine",
                    quarantine_dir=os.path.join(workdir, "q"),
                    max_bad_frac=float(max_bad_frac), window=32,
                    min_records=16, journal=journal)


class Tap:
    # Batch-index-prefixed, append-per-batch (SIGKILL-durable) record
    # tap; the index rides the cursor so a resumed attempt continues
    # numbering where the checkpoint left off.
    def __init__(self, source, path):
        self._source = source
        self._path = path
        self._idx = 0

    def next_batch(self):
        ids, vals, labels, w = self._source.next_batch()
        with open(self._path, "a") as f:
            f.write(str(self._idx) + ":" + ",".join(
                str(int(x)) for x in ids[w > 0][:, 0]))
            f.write("\\n")
        self._idx += 1
        return ids, vals, labels, w

    def state(self):
        return dict(self._source.state(), tap_len=self._idx)

    def restore(self, s):
        self._source.restore(s)
        self._idx = int(s.get("tap_len", 0))

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


ck = Checkpointer(os.path.join(workdir, "ck"),
                  save_every=int(save_every), journal=journal)
sup = Supervisor(policy=BackoffPolicy(initial=0.01, jitter=0.0,
                                      max_delay=0.05),
                 journal=journal, probe=lambda: True,
                 breaker_threshold=8, sleep=lambda s: None, device=dev)
print(json.dumps({"resumed_at": int(ck.last_good_step() or 0)}),
      flush=True)
batches = Tap(
    StreamBatches(ShardReader(paths, chunk_bytes=64),
                  line_parser("libsvm"), batch_size, 3, guard=guard,
                  num_features=128),
    os.path.join(workdir, f"tap_{attempt}.txt"))
spec = models.FMSpec(num_features=128, rank=4, init_std=0.05)
config = TrainConfig(num_steps=steps, batch_size=batch_size,
                     learning_rate=0.1, lr_schedule="constant",
                     log_every=1, seed=seed)
trainer = FMTrainer(spec, config, device=dev)
trainer.fit(batches, checkpointer=ck, supervisor=sup)
ck.close()
print(json.dumps({"done": trainer.step_count,
                  "counters": guard.counters(),
                  "cursor": batches.state(),
                  "params_sums": _params_sums(trainer.params),
                  "loss_history": trainer.loss_history}), flush=True)
obs.shutdown()
'''


def write_worker(workdir: str) -> str:
    path = os.path.join(workdir, "chaos_worker.py")
    with open(path, "w") as f:
        f.write(_WORKER_TEMPLATE)
    return path


def run_schedule_subproc(plan: str, cfg: DrillConfig, workdir: str, *,
                         attempts: int = 4, timeout_s: float = 120.0,
                         kill_at_step: int | None = None,
                         kill_signal: int | None = None,
                         watchdog_spec: str | None = None,
                         expected_rcs=(0,), device=None) -> DrillResult:
    """Drive the worker as a supervised child-process chain on
    ``device`` (the card unless ``device="cpu"``; resolved here first,
    so no worker starts without it): spawn,
    optionally SIGKILL it at a step (first attempt only), respawn while
    it dies with an EXPECTED rc, and collect the artifacts for
    :func:`audit`-style checks. Cross-process fault occurrences ride
    ``FM_SPARK_FAULTS_STATE`` so "hang the FIRST attempt's read, not
    every attempt's" stays expressible across respawns.

    rc discipline is itself an invariant: an attempt ending with an rc
    outside ``expected_rcs`` ∪ {the kill signal, watchdog
    :data:`~fm_spark_tpu_torch.resilience.watchdog.HANG_EXIT_RC`} fails the
    drill with outcome ``rc_violation``.
    """
    import json as _json  # read-only (json.loads); writes stay EventLog

    import signal as _signal

    from fm_spark_tpu_torch import resolve_device

    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    build_shards(os.path.join(workdir, "shards"), cfg)
    worker = write_worker(workdir)
    env = dict(os.environ, FM_SPARK_OBS_DIR="none",
               PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               FM_SPARK_FAULTS=plan,
               FM_SPARK_FAULTS_STATE=os.path.join(workdir,
                                                  "faults_state.json"))
    env.pop("FM_SPARK_WATCHDOG", None)
    env.pop("FM_SPARK_WATCHDOG_ACTION", None)
    if watchdog_spec:
        env["FM_SPARK_WATCHDOG"] = watchdog_spec
        env["FM_SPARK_WATCHDOG_ACTION"] = "exit"
    kill_sig = (int(kill_signal) if kill_signal is not None
                else int(_signal.SIGKILL))
    allowed = set(expected_rcs) | {watchdog.HANG_EXIT_RC,
                                   -int(_signal.SIGTERM)}
    if kill_at_step is not None:
        allowed.add(-kill_sig)

    import threading

    t0 = time.perf_counter()
    rcs: list[int] = []
    resumed: list[int] = []
    done: dict | None = None
    outcome, error = "incomplete", None
    for attempt in range(attempts):
        argv = [sys.executable, worker, workdir, str(cfg.steps),
                str(cfg.batch_size), str(cfg.save_every),
                str(cfg.flight_capacity), "1.0", str(cfg.seed),
                str(attempt), str(dev)]
        proc = subprocess.Popen(argv, stdout=subprocess.PIPE,
                                text=True, cwd=_REPO, env=env)
        killed = False
        # The per-attempt timeout must bound a SILENT child too (a
        # hang at an unbudgeted point emits nothing, and a blocking
        # readline would wait on it forever): a timer thread kills the
        # child at the deadline, which unblocks the stdout iteration.
        timed_out = threading.Event()

        def _deadline_kill(p=proc, flag=timed_out):
            flag.set()
            try:
                p.kill()
            except OSError:
                pass

        timer = threading.Timer(timeout_s, _deadline_kill)
        timer.daemon = True
        timer.start()
        try:
            for line in proc.stdout:
                try:
                    rec = _json.loads(line)
                except ValueError:
                    continue
                if "resumed_at" in rec:
                    resumed.append(int(rec["resumed_at"]))
                if "done" in rec:
                    done = rec
                if (kill_at_step is not None and not killed
                        and attempt == 0
                        and rec.get("step", -1) >= kill_at_step):
                    os.kill(proc.pid, kill_sig)
                    killed = True
            proc.wait(timeout=30)
        finally:
            timer.cancel()
            proc.stdout.close()
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=30)
        rcs.append(proc.returncode)
        if timed_out.is_set():
            outcome = "attempt_timeout"
            error = f"attempt {attempt} exceeded {timeout_s}s"
            break
        # rc discipline applies to EVERY attempt, the completing one
        # included: a worker that printed its done marker and then
        # died in teardown still violated the exit contract.
        if proc.returncode not in allowed:
            outcome = "rc_violation"
            error = (f"attempt {attempt} exited rc={proc.returncode}, "
                     f"allowed {sorted(allowed)}")
            break
        if done is not None:
            outcome = "completed"
            break
    if outcome == "incomplete":
        error = f"no completion in {attempts} attempt(s); rcs={rcs}"

    tap: list[str] = []
    for attempt in range(attempts):
        path = os.path.join(workdir, f"tap_{attempt}.txt")
        if os.path.isfile(path):
            with open(path) as f:
                tap.append(f.read())
    return DrillResult(
        outcome=outcome, error=error,
        steps_done=int((done or {}).get("done", 0)),
        loss_history=list((done or {}).get("loss_history", [])),
        params_sums=(done or {}).get("params_sums"),
        tap=tap,  # raw per-attempt tap texts; stitch with stitch_taps()
        cursor=(done or {}).get("cursor"),
        counters=dict((done or {}).get("counters", {})),
        duration_s=time.perf_counter() - t0,
        workdir=workdir,
        health_path=os.path.join(workdir, "health.jsonl"),
        deadletter_path=os.path.join(workdir, "q", "deadletter.jsonl"),
        ckpt_dir=os.path.join(workdir, "ck"),
        rcs=tuple(rcs), resumed_at=tuple(resumed),
    )


def stitch_taps(result: DrillResult) -> list[str]:
    """Reconstruct the EFFECTIVE record stream of a killed-and-resumed
    drill chain from the batch-index-prefixed per-attempt taps: for
    each batch index the LAST write wins (a later attempt re-emitting
    an index means the earlier emission was rolled back with the
    checkpoint — never committed). The result must be contiguous from
    batch 0 and bit-identical to the clean run's tap: that is the
    exactly-once verdict across process deaths. A torn final line (a
    SIGKILL mid-append) is tolerated exactly once per attempt file."""
    effective: dict[int, str] = {}
    for text in result.tap:
        lines = text.splitlines()
        for j, line in enumerate(lines):
            idx, sep, payload = line.partition(":")
            if not sep or not idx.isdigit():
                if j == len(lines) - 1:
                    continue  # torn tail from a kill mid-append
                raise ValueError(f"malformed tap line {line!r}")
            effective[int(idx)] = payload
    if not effective:
        return []
    if sorted(effective) != list(range(max(effective) + 1)):
        raise ValueError(
            f"tap indices not contiguous: {sorted(effective)[:8]}...")
    return [effective[i] for i in range(max(effective) + 1)]


# ------------------------------------------------------------- serving

#: The serving-path watchdog phase a hang drill arms (deadline = SLO).
_SERVE_PHASE = "serve_request"


def serve_schedule(seed: int) -> Schedule:
    """Seeded serving-path fault schedule: compositions of
    trainer-side ``ckpt_commit`` faults (a torn publish window under an
    active reload follower) and ``serve_reload`` faults (reload
    failure → degraded serving; ``exit`` = the SIGKILL-mid-reload
    drill). Same purity contract as :meth:`ScheduleGenerator.schedule`:
    the plan is a pure function of the seed, so a failing seed IS its
    repro. The serve drill harness (the serving tests) runs these
    against the production engine/follower/checkpointer stack and holds
    the run to :func:`audit_serve_events`."""
    rng = random.Random(int(seed))
    scenario = rng.choice(
        ("reload_fail", "commit_fault", "reload_storm", "compound"))
    if scenario == "reload_fail":
        rules = [f"serve_reload@{rng.randint(1, 2)}=error"]
    elif scenario == "commit_fault":
        rules = [f"ckpt_commit@{rng.randint(1, 2)}=error"]
        if rng.random() < 0.5:
            rules.append(f"serve_reload@{rng.randint(1, 2)}=error")
    elif scenario == "reload_storm":
        rules = ["serve_reload@1=error", "serve_reload@2=error"]
    else:  # compound: publish fault pressed against a reload failure
        rules = [f"ckpt_commit@{rng.randint(1, 2)}=error",
                 f"serve_reload@{rng.randint(1, 3)}=error"]
    return Schedule(int(seed), f"serve_{scenario}", tuple(rules),
                    stream_comparable=False).validate()


# ------------------------------------------------- continuous learning

#: The drift/rollback failure class joins the chaos surface: seeded
#: schedules over the ``online_eval`` / ``ckpt_demote`` / ``ckpt_commit``
#: / ``ingest_corrupt`` points, drilled against the PRODUCTION online
#: loop (online.run_online + FMTrainer + StreamBatches + Checkpointer)
#: with a planted label-flip drift, and audited from artifacts alone.

#: Tier-1 drift drill seeds (the drill runner runs the same five).
DRIFT_TIER1_SEEDS = (0, 1, 2, 3, 4)

_DRIFT_SCENARIOS = ("clean_drift", "eval_fault", "commit_fault",
                    "demote_fault", "rollback_corruption")


@dataclasses.dataclass(frozen=True)
class DriftDrillConfig:
    """Online-loop drill shape: enough days for the sentry's
    ``min_history`` floor to clear before the planted drift day, small
    enough that five schedules fit the tier-1 budget."""

    days: int = 6
    rows_per_day: int = 192
    batch_size: int = 16
    num_features: int = 128
    nnz: int = 3
    rank: int = 4
    drift_day: int = 4           # labels flip from this day on
    seed: int = 11
    learning_rate: float = 0.2
    drop_factor: float = 1.15
    min_history: int = 3
    max_rollbacks: int = 2
    attempts: int = 4


def build_drift_days(cfg: DriftDrillConfig, shard_dir: str):
    """Deterministic time-ordered day set with a planted concept
    drift: synthetic planted-FM CTR days whose labels FLIP from
    ``drift_day`` on. Returns ``(days, shard_paths)`` — in-memory
    arrays (the eval side) and one libsvm text shard per day (the
    streaming train side; ids written 1-based per libsvm convention,
    so the parsed stream round-trips the array ids exactly)."""
    from fm_spark_tpu_torch import online
    from fm_spark_tpu_torch.data import synthetic_ctr

    ids, vals, labels = synthetic_ctr(
        cfg.days * cfg.rows_per_day, cfg.num_features, cfg.nnz,
        rank=cfg.rank, seed=cfg.seed)
    days = online.flip_labels(
        online.split_days(ids, vals, labels, cfg.days), cfg.drift_day)
    os.makedirs(shard_dir, exist_ok=True)
    paths = []
    for k, (di, dv, dl) in enumerate(days):
        path = os.path.join(shard_dir, f"day{k}.svm")
        with open(path, "w") as f:
            for r in range(len(dl)):
                feats = " ".join(f"{int(di[r, j]) + 1}:{dv[r, j]:g}"
                                 for j in range(cfg.nnz))
                f.write(f"{int(dl[r])} {feats}\n")
        paths.append(path)
    return days, paths


def drift_schedule(seed: int) -> Schedule:
    """Seeded drift/rollback fault schedule — scenario chosen by
    ``seed % 5`` so the five tier-1 seeds cover the whole class, rule
    parameters drawn from the seeded rng; a pure function of the seed
    like every other schedule here.

    ``clean_drift``          no faults: the rollback protocol itself
    ``eval_fault``           ``online_eval`` error — the eval pass
                             dies; the resumed run must REPLAY the
                             missed eval (durable sentry state), so a
                             crash can never skip a drift check
    ``commit_fault``         ``ckpt_commit`` error — a drift-adjacent
                             save dies in its verify window
    ``demote_fault``         ``ckpt_demote`` error — the demotion
                             crashes AFTER the tombstone, BEFORE the
                             pointer republish (the nastiest window)
    ``rollback_corruption``  quarantine-policy ingest corruption under
                             the drifted days — rollback must compose
                             with dirty ingest accounting
    """
    rng = random.Random(int(seed))
    scenario = _DRIFT_SCENARIOS[int(seed) % len(_DRIFT_SCENARIOS)]
    if scenario == "clean_drift":
        rules: tuple = ()
    elif scenario == "eval_fault":
        rules = (f"online_eval@{rng.randint(1, 5)}=error",)
    elif scenario == "commit_fault":
        rules = (f"ckpt_commit@{rng.randint(2, 6)}=error",)
    elif scenario == "demote_fault":
        rules = ("ckpt_demote@1=error",)
    else:  # rollback_corruption
        n = rng.randint(2, 4)
        occs = sorted(rng.sample(range(5, 400), n))
        rules = tuple(f"ingest_corrupt@{o}=error" for o in occs)
    return Schedule(int(seed), f"drift_{scenario}", rules,
                    stream_comparable=(scenario != "rollback_corruption"),
                    max_bad_frac=0.5).validate()


class _DayTap:
    """Per-day durable batch tap for the online drill: one
    ``day:index:ids`` line appended per consumed batch (last write
    wins on re-runs, like the subprocess tap)."""

    def __init__(self, source, day: int, path: str):
        self._source, self._day, self._path = source, day, path
        self._idx = 0

    @property
    def guard(self):
        return getattr(self._source, "guard", None)

    def next_batch(self):
        ids, vals, labels, w = self._source.next_batch()
        with open(self._path, "a") as f:
            f.write(f"{self._day}:{self._idx}:" + ",".join(
                str(int(x)) for x in ids[w > 0][:, 0]) + "\n")
        self._idx += 1
        return ids, vals, labels, w

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


@dataclasses.dataclass
class DriftResult:
    """One drilled online run's artifacts for :func:`audit_drift`."""

    outcome: str
    error: str | None
    attempts: int
    summary: dict | None
    taps: dict
    params_sums: dict | None
    tombstones: list
    last_good: int | None
    counters: dict
    workdir: str
    health_path: str
    deadletter_path: str
    ckpt_dir: str


def _read_day_taps(path: str) -> dict:
    """Last-write-wins per-(day, batch) tap reconstruction — a day
    retrained after a crash replays the same deterministic stream, so
    the effective map must match the clean run's exactly."""
    taps: dict = {}
    try:
        with open(path) as f:
            lines = f.read().splitlines()
    except OSError:
        return taps
    for line in lines:
        day, _, rest = line.partition(":")
        idx, _, payload = rest.partition(":")
        if not (day.isdigit() and idx.isdigit()):
            continue
        taps.setdefault(int(day), {})[int(idx)] = payload
    return {d: [m[i] for i in sorted(m)] for d, m in taps.items()}


def run_drift_schedule(schedule: "Schedule | str",
                       cfg: DriftDrillConfig, workdir: str,
                       shard_state=None, device=None) -> DriftResult:
    """Drill the PRODUCTION continuous-learning loop on ``device`` (the
    card unless ``device="cpu"``) under a fault plan: time-ordered libsvm day shards stream through
    ``StreamBatches`` + quarantine ``RecordGuard`` into
    ``online.run_online`` (FMTrainer, crash-consistent Checkpointer,
    maximize-mode drift sentry), with a planted label-flip drift so
    EVERY schedule exercises the demotion/rollback path. A fault that
    kills the run is followed by a fresh-process-style resume (new
    trainer/checkpointer over the same chain + durable sentry state),
    up to ``cfg.attempts`` — the in-process analog of the respawn
    chain, with fault occurrence counters carried across attempts. Each
    attempt's trainer is freed from the device before the next."""
    from fm_spark_tpu_torch import models, online, resolve_device
    from fm_spark_tpu_torch.checkpoint import ChainFollower, Checkpointer
    from fm_spark_tpu_torch.data.stream import (
        RecordGuard,
        ShardReader,
        StreamBatches,
        line_parser,
    )
    from fm_spark_tpu_torch.train import FMTrainer, TrainConfig
    from fm_spark_tpu_torch.utils.logging import MetricsLogger

    dev = resolve_device(device)
    if isinstance(schedule, str):
        schedule = Schedule(seed=-1, scenario="adhoc",
                            rules=tuple(r for r in schedule.split(";")
                                        if r.strip()))
    os.makedirs(workdir, exist_ok=True)
    if shard_state is None:
        shard_state = build_drift_days(
            cfg, os.path.join(workdir, "shards"))
    days, shard_paths = shard_state
    ck_dir = os.path.join(workdir, "ck")
    q_dir = os.path.join(workdir, "q")
    tap_path = os.path.join(workdir, "tap.txt")
    health_path = os.path.join(workdir, "health.jsonl")
    journal = EventLog(health_path)

    guards: list = []

    def day_source(k, _default):
        """Replace the online loop's in-memory day source with the
        PRODUCTION streaming stack over day ``k``'s text shard —
        quarantine guard (the ``ingest_corrupt`` surface) + durable
        per-batch tap."""
        guard = RecordGuard("quarantine", quarantine_dir=q_dir,
                            max_bad_frac=schedule.max_bad_frac,
                            window=64, min_records=32,
                            journal=journal)
        guards.append(guard)
        src = StreamBatches(
            ShardReader([shard_paths[k]], chunk_bytes=512),
            line_parser("libsvm"), cfg.batch_size, cfg.nnz,
            guard=guard, num_features=cfg.num_features)
        return _DayTap(src, k, tap_path)
    spec = models.FMSpec(num_features=cfg.num_features, rank=cfg.rank,
                         init_std=0.05)
    tconfig = TrainConfig(num_steps=0, batch_size=cfg.batch_size,
                          learning_rate=cfg.learning_rate,
                          lr_schedule="constant", optimizer="ftrl",
                          log_every=10_000, seed=cfg.seed)

    faults.clear()
    if schedule.plan:
        faults.activate(schedule.plan)
    outcome, error, summary = "incomplete", None, None
    params_sums = None
    attempts = 0
    try:
        for attempt in range(cfg.attempts):
            attempts = attempt + 1
            trainer = FMTrainer(spec, tconfig, device=dev)
            trainer.logger.close()
            trainer.logger = MetricsLogger(
                path=os.path.join(workdir, "metrics.jsonl"))
            trainer.logger._stream = None
            ck = Checkpointer(ck_dir, save_every=10**9, journal=journal)
            sentry = online.drift_guard(
                drop_factor=cfg.drop_factor,
                min_history=cfg.min_history,
                max_rollbacks=cfg.max_rollbacks, journal=journal)
            try:
                summary = online.run_online(
                    trainer, days, ck, sentry=sentry,
                    journal=journal, batch_tap=day_source)
                outcome = "completed"
            except Exception as e:  # noqa: BLE001 — the outcome IS
                # the verdict; the next attempt is the recovery
                outcome = _classify_outcome(e)
                error = (f"{type(e).__name__}: "
                         f"{(str(e).splitlines() or [''])[0][:200]}")
            finally:
                try:
                    ck.close()
                except Exception:
                    pass
                trainer.logger.close()
                if outcome == "completed":
                    params_sums = _params_sums(trainer.params)
                _free(trainer)
            if outcome == "completed":
                break
    finally:
        faults.clear()
        for g in guards:
            g.close()
        journal.close()

    total = {"ok": 0, "bad": 0}
    for g in guards:
        c = g.counters()
        total["ok"] += c.get("ok", 0)
        total["bad"] += c.get("bad", 0)
    follower = ChainFollower(ck_dir)
    tombstones = sorted(follower.tombstoned_steps())
    last_good = follower.last_good_step()
    follower.close()
    return DriftResult(
        outcome=outcome, error=error, attempts=attempts,
        summary=summary, taps=_read_day_taps(tap_path),
        params_sums=params_sums,
        tombstones=tombstones, last_good=last_good,
        counters=total, workdir=workdir, health_path=health_path,
        deadletter_path=os.path.join(q_dir, "deadletter.jsonl"),
        ckpt_dir=ck_dir,
    )


def audit_drift(schedule: Schedule, result: DriftResult,
                golden: DriftResult, cfg: DriftDrillConfig) -> list[dict]:
    """The continuous-learning invariants, judged from artifacts alone
    (empty list = green):

    - **completion** — the run completes within the attempt budget and
      every eval day 1..D-1 was judged;
    - **rollback** — the planted drift fired the sentry and the
      offending generation was demoted (for stream-comparable
      schedules, at exactly the first drifted eval day);
    - **exactly_once_stream** — the effective per-day record stream
      (last-write-wins across crash re-runs) is bit-identical to the
      clean drilled run's: records are neither replayed into nor
      skipped from the committed state, rollbacks included;
    - **state_identity** — final params byte-identical to the clean
      run (faults may change WHEN things happened, never the model);
    - **chain_consistency** — a fresh read-only follower restores a
      verified, NON-tombstoned step equal to the published
      ``last_good``; every demoted step is tombstoned; the pointer
      never vouches for a vetoed generation;
    - **quarantine_accounting** — corruption schedules: every
      quarantined record has a dead letter.
    """
    v: list[dict] = []
    if result.outcome != "completed":
        v.append(_violation(
            "completion",
            f"{result.outcome} after {result.attempts} attempt(s): "
            f"{result.error}"))
        return v
    summary = result.summary or {}
    # Eval coverage spans ATTEMPTS (a killed run's early evals live in
    # its journal, not the final attempt's summary) — the journal is
    # the durable record the invariant reads.
    eval_days = {e.get("eval_day")
                 for e in read_events(result.health_path)
                 if e.get("event") == "quality_eval"}
    eval_days |= {e.get("eval_day") for e in summary.get("days", [])}
    want = set(range(1, cfg.days))
    if not want <= eval_days:
        v.append(_violation(
            "completion",
            f"eval days {sorted(want - eval_days)} never judged"))
    # Rollback evidence spans attempts too: a fault that kills the run
    # AFTER the rollback leaves the final attempt's summary with
    # rollbacks=0 while the journal durably records the demotion — the
    # journal, not the last summary, is what the invariant reads.
    rollback_events = [e for e in read_events(result.health_path)
                       if e.get("event") == "online_rollback"]
    if not (summary.get("rollbacks") or rollback_events):
        v.append(_violation(
            "rollback",
            "planted label-flip drift never fired the sentry"))
    if schedule.stream_comparable and rollback_events:
        first_eval = int(rollback_events[0].get("day", -2)) + 1
        if first_eval != cfg.drift_day:
            v.append(_violation(
                "rollback",
                f"first rollback at eval day {first_eval}, expected "
                f"the first drifted day {cfg.drift_day}"))
        if result.taps != golden.taps:
            bad_days = sorted(d for d in set(result.taps)
                              | set(golden.taps)
                              if result.taps.get(d)
                              != golden.taps.get(d))
            v.append(_violation(
                "exactly_once_stream",
                f"effective record stream diverges from the clean "
                f"run on day(s) {bad_days[:4]} — records replayed "
                "or skipped across recovery/rollback"))
        if (result.params_sums is not None
                and result.params_sums != golden.params_sums):
            v.append(_violation(
                "state_identity",
                "final params differ byte-wise from the clean run"))
    if result.last_good is None:
        v.append(_violation("chain_consistency",
                            "no last_good published after completion"))
    elif result.last_good in set(result.tombstones):
        v.append(_violation(
            "chain_consistency",
            f"last_good {result.last_good} is tombstoned — the "
            "pointer vouches for a vetoed generation"))
    demoted = set(summary.get("demoted_steps") or [])
    if not demoted <= set(result.tombstones):
        v.append(_violation(
            "chain_consistency",
            f"demoted steps {sorted(demoted - set(result.tombstones))} "
            "carry no tombstone"))
    # A fresh follower must restore exactly the published generation
    # (the port's chain is keyed by name: no params example needed).
    from fm_spark_tpu_torch.checkpoint import ChainFollower

    follower = ChainFollower(result.ckpt_dir)
    try:
        restored = follower.restore()
        if restored is None:
            v.append(_violation("chain_consistency",
                                "fresh follower restored nothing"))
        elif restored["step"] != result.last_good:
            v.append(_violation(
                "chain_consistency",
                f"follower restored step {restored['step']} != "
                f"last_good {result.last_good}"))
    finally:
        follower.close()
    if not schedule.stream_comparable:
        dead = read_events(result.deadletter_path)
        n_dead = sum(1 for e in dead if e.get("event") == "bad_record")
        if result.counters.get("bad", 0) > n_dead:
            v.append(_violation(
                "quarantine_accounting",
                f"guards counted {result.counters.get('bad')} bad "
                f"record(s) vs {n_dead} dead letter(s)"))
        if result.counters.get("bad", 0) == 0 and schedule.rules:
            v.append(_violation(
                "quarantine_accounting",
                "corruption rules active but nothing was quarantined"))
    v.extend(_audit_journal(result))
    return v


#: Worker for the hard-kill demotion drill: builds nothing, just runs
#: one demotion over an existing chain — the ``ckpt_demote`` fault
#: (via FM_SPARK_FAULTS) lands between the tombstone write and the
#: pointer republish, so an ``exit`` there IS the SIGKILL-mid-demotion
#: window.
_DEMOTE_WORKER = '''\
import os, sys
from fm_spark_tpu_torch.checkpoint import Checkpointer
ck = Checkpointer(sys.argv[1], save_every=1)
demoted = ck.demote_newer_than(int(sys.argv[2]),
                               reason="drill drift verdict")
ck.close()
import json
print(json.dumps({"demoted": demoted}))
'''


def run_demote_kill_drill(workdir: str, *, exit_rc: int = 23) -> dict:
    """The SIGKILL-at-any-point-during-demotion drill: a subprocess
    demotes the chain's newest saves and is
    hard-killed INSIDE the demotion window — after the (atomic, range)
    tombstone write, before the ``last_good`` republish. The audit
    then proves, from artifacts alone, that the chain recovered
    consistent: every reader lands on the PRE-DRIFT save even while
    the pointer is stale, and the recovery re-run repairs the pointer
    idempotently. Returns ``{"violations": [...], "rcs": [...]}``.
    The chain is host tensors: nothing here touches a device."""
    import torch

    from fm_spark_tpu_torch.checkpoint import ChainFollower, Checkpointer

    os.makedirs(workdir, exist_ok=True)
    ck_dir = os.path.join(workdir, "ck")
    ck = Checkpointer(ck_dir, save_every=1)
    for s in (1, 2, 3):
        ck.save(s, {"w": torch.arange(4, dtype=torch.float32) * s}, {},
                force=True)
    ck.close()
    worker = os.path.join(workdir, "demote_worker.py")
    with open(worker, "w") as f:
        f.write(_DEMOTE_WORKER)
    env = dict(os.environ, FM_SPARK_OBS_DIR="none",
               PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""),
               FM_SPARK_FAULTS=f"ckpt_demote@1=exit:{exit_rc}")
    v: list[dict] = []
    rcs = []
    proc = subprocess.run([sys.executable, worker, ck_dir, "1"],
                          cwd=_REPO, env=env, capture_output=True,
                          timeout=120)
    rcs.append(proc.returncode)
    if proc.returncode != exit_rc:
        v.append(_violation(
            "rc_discipline",
            f"demotion worker exited rc={proc.returncode}, expected "
            f"the injected {exit_rc}"))
    follower = ChainFollower(ck_dir)
    try:
        ex = {"w": torch.zeros(4, dtype=torch.float32)}
        if follower.tombstoned_steps() != {2, 3}:
            v.append(_violation(
                "chain_consistency",
                f"tombstones {sorted(follower.tombstoned_steps())} "
                "after the kill; the range stone must veto {2, 3} "
                "atomically"))
        restored = follower.restore(ex)
        if restored is None or restored["step"] != 1:
            v.append(_violation(
                "chain_consistency",
                f"reader restored "
                f"{restored and restored['step']} mid-demotion; must "
                "land on the pre-drift save 1 even with the pointer "
                "stale"))
    finally:
        follower.close()
    # Recovery: the re-run must be idempotent AND repair the pointer.
    env.pop("FM_SPARK_FAULTS")
    proc2 = subprocess.run([sys.executable, worker, ck_dir, "1"],
                           cwd=_REPO, env=env, capture_output=True,
                           timeout=120)
    rcs.append(proc2.returncode)
    if proc2.returncode != 0:
        v.append(_violation(
            "rc_discipline",
            f"recovery demotion re-run exited rc={proc2.returncode}: "
            f"{proc2.stderr.decode()[-200:]}"))
    ck2 = Checkpointer(ck_dir, save_every=1)
    try:
        if ck2.last_good_step() != 1:
            v.append(_violation(
                "chain_consistency",
                f"last_good {ck2.last_good_step()} after recovery; "
                "the pointer must republish at the pre-drift save 1"))
    finally:
        ck2.close()
    return {"violations": v, "rcs": rcs}


def run_drift_campaign(seeds=DRIFT_TIER1_SEEDS,
                       cfg: DriftDrillConfig | None = None,
                       base_dir: str | None = None,
                       device=None) -> list[dict]:
    """The drift/rollback half of the chaos campaign on ``device`` (the
    card unless ``device="cpu"``): golden drilled run first (the planted
    drift WITH no faults), then every seed's schedule audited against
    it. Returns chaos_verdict-style entries (the drill runner merges
    them into its verdict)."""
    import tempfile

    from fm_spark_tpu_torch import resolve_device

    device = resolve_device(device)
    cfg = cfg or DriftDrillConfig()
    base_dir = base_dir or tempfile.mkdtemp(prefix="drift_")
    os.makedirs(base_dir, exist_ok=True)
    shard_state = build_drift_days(cfg, os.path.join(base_dir,
                                                     "shards"))
    golden = run_drift_schedule(
        Schedule(seed=-1, scenario="drift_golden", rules=()),
        cfg, os.path.join(base_dir, "golden"), shard_state=shard_state,
        device=device)
    if golden.outcome != "completed" or not (
            golden.summary or {}).get("rollbacks"):
        raise RuntimeError(
            f"golden drift drill failed ({golden.outcome}: "
            f"{golden.error}; rollbacks="
            f"{(golden.summary or {}).get('rollbacks')}) — the online "
            "workload itself is broken; no schedule verdict is "
            "meaningful")
    entries = []
    for seed in seeds:
        sched = drift_schedule(seed)
        t0 = time.perf_counter()
        result = run_drift_schedule(
            sched, cfg, os.path.join(base_dir, f"d{int(seed)}"),
            shard_state=shard_state, device=device)
        violations = audit_drift(sched, result, golden, cfg)
        # Rollback/demotion accounting spans ATTEMPTS (the journal),
        # not just the final attempt's summary — same policy as the
        # auditor's rollback invariant.
        journal_rollbacks = sum(
            1 for e in read_events(result.health_path)
            if e.get("event") == "online_rollback")
        entries.append({
            "seed": int(seed), "scenario": sched.scenario,
            "plan": sched.plan, "expects": "completed",
            "outcome": result.outcome,
            "verdict": "green" if not violations else "failed",
            "violations": violations,
            "duration_s": round(time.perf_counter() - t0, 3),
            "rollbacks": max((result.summary or {}).get("rollbacks")
                             or 0, journal_rollbacks),
            "demoted": sorted(set(
                (result.summary or {}).get("demoted_steps") or [])
                | set(result.tombstones)),
        })
    return entries


# ------------------------------------------------------- serving fleet

#: Fleet/traffic drills: seeded compositions of millions-of-users
#: traffic SHAPES (serve/loadgen.py) with replica kills, dispatch
#: faults, and publish/demote races, run against a REAL multi-process
#: fleet (serve/fleet.py behind serve/frontdoor.py) and graded from
#: artifacts alone by :func:`chaos_audit.audit_fleet`.

#: Tier-1 fleet drill seeds (the drill runner folds the same three
#: into its default bounded campaign; soak runs five).
FLEET_TIER1_SEEDS = (0, 1, 2)
FLEET_SOAK_SEEDS = (0, 1, 2, 3, 4)

_FLEET_SCENARIOS = ("kill_flash_crowd", "retry_storm_demote",
                    "slow_client_shed", "dispatch_fault", "compound")


@dataclasses.dataclass(frozen=True)
class FleetSchedule:
    """One seeded fleet/traffic drill: a loadgen shape composed with
    parent-side fault rules, an optional mid-burst replica SIGKILL
    (fired after ``kill_after_ok`` answered requests), and an optional
    publish+demote race pressed against the replicas' reload pollers.
    Pure function of the seed, like every schedule here."""

    seed: int
    scenario: str
    shape: str
    rules: tuple = ()
    kill_after_ok: "int | None" = None
    demote_race: bool = False
    expects: str = "completed"

    @property
    def plan(self) -> str:
        return ";".join(self.rules)

    def validate(self) -> "FleetSchedule":
        faults.FaultPlan.from_spec(self.plan)
        from fm_spark_tpu_torch.serve import loadgen

        if self.shape not in loadgen.SHAPES:
            raise ValueError(f"unknown traffic shape {self.shape!r}")
        return self


def fleet_schedule(seed: int) -> FleetSchedule:
    """Seeded fleet/traffic schedule — scenario chosen by ``seed % 5``
    so the tier-1 seeds cover the class, parameters drawn from the
    seeded rng.

    ``kill_flash_crowd``    SIGKILL a replica mid-flash-crowd: every
                            accepted request still answered exactly
                            once (retry-once against a live replica)
    ``retry_storm_demote``  a retry storm while the trainer publishes
                            AND demotes a generation under the
                            replicas' reload pollers: the demoted
                            generation never scores
    ``slow_client_shed``    slow clients hold handler threads while
                            interactive traffic keeps its deadline —
                            the deadline shed fires before the
                            coalescer
    ``dispatch_fault``      injected ``fleet_dispatch`` errors: the
                            retry-once path answers the request
                            elsewhere
    ``compound``            flash crowd + dispatch fault + replica
                            kill + demote race at once
    """
    rng = random.Random(int(seed))
    scenario = _FLEET_SCENARIOS[int(seed) % len(_FLEET_SCENARIOS)]
    shape, rules, kill, demote = "diurnal", [], None, False
    if scenario == "kill_flash_crowd":
        shape = "flash_crowd"
        kill = rng.randint(4, 12)
    elif scenario == "retry_storm_demote":
        shape = "retry_storm"
        demote = True
    elif scenario == "slow_client_shed":
        shape = "slow_clients"
        if rng.random() < 0.5:
            rules.append(
                f"frontdoor_accept@{rng.randint(2, 8)}=error")
    elif scenario == "dispatch_fault":
        shape = "diurnal"
        rules.append(f"fleet_dispatch@{rng.randint(1, 6)}=error")
    else:  # compound
        shape = "flash_crowd"
        rules.append(f"fleet_dispatch@{rng.randint(2, 8)}=error")
        kill = rng.randint(6, 14)
        demote = rng.random() < 0.7
    return FleetSchedule(int(seed), f"fleet_{scenario}", shape,
                         tuple(rules), kill_after_ok=kill,
                         demote_race=demote).validate()


@dataclasses.dataclass(frozen=True)
class FleetDrillConfig:
    """Fleet drill shape: small enough that a campaign over one shared
    two-replica fleet fits tier-1, hot enough that shed/kill/retry
    paths actually fire."""

    n_replicas: int = 2
    num_features: int = 256
    num_fields: int = 4
    bucket: int = 64
    rank: int = 4
    init_std: float = 0.1
    buckets: str = "1,4"
    latency_budget_ms: float = 2.0
    reload_poll_s: float = 0.15
    duration_s: float = 1.2
    base_rps: float = 50.0
    rows: int = 2
    deadline_ms: float = 2500.0
    classes: str = ("interactive:32:2500,batch:16:4000,"
                    "background:8:8000")
    threads: int = 8
    spawn_timeout_s: float = 300.0
    converge_timeout_s: float = 30.0
    #: > 0 arms the bidirectional autoscaler (serve/autoscale.py)
    #: with this replica ceiling — the partition campaign runs with
    #: it on so scale-up can race a partition; the plain fleet
    #: campaign keeps it off (a fixed-size fleet).
    autoscale_max: int = 0
    #: The served tables' storage dtype (the port's addition: the card
    #: drill serves config 3's full width in ``bfloat16``).
    param_dtype: str = "float32"


def build_fleet_stack(cfg: FleetDrillConfig, base_dir: str,
                      device=None) -> dict:
    """Build the shared drill stack: model dir, checkpoint chain (one
    verified step), a running N-replica fleet behind a front door, every
    replica a process serving on ``device`` (the card unless
    ``device="cpu"``; replicas share one card). Returns the context dict
    the schedule runner mutates (chain step counter, tombstones). Caller
    owns ``ctx['door'].stop()``."""
    import torch

    from fm_spark_tpu_torch import models, resolve_device
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.serve.fleet import Fleet
    from fm_spark_tpu_torch.serve.frontdoor import (AdmissionController,
                                                    FrontDoor)

    dev = resolve_device(device)
    os.makedirs(base_dir, exist_ok=True)
    spec = models.FieldFMSpec(
        num_features=cfg.num_features, num_fields=cfg.num_fields,
        bucket=cfg.bucket, rank=cfg.rank, init_std=cfg.init_std,
        param_dtype=cfg.param_dtype)
    params = spec.init(torch.Generator(device=dev).manual_seed(0),
                       device=dev)
    model_dir = os.path.join(base_dir, "model")
    models.save_model(model_dir, spec, params)
    chain_dir = os.path.join(base_dir, "chain")
    ck = Checkpointer(chain_dir, save_every=1)
    ck.save(1, params, {}, None, force=True)
    ck.wait()
    journal = EventLog(os.path.join(base_dir, "fleet_health.jsonl"))
    autoscaler = None
    if cfg.autoscale_max:
        from fm_spark_tpu_torch.serve.autoscale import Autoscaler

        # Drill-tempo policy: the health poll is 0.25s, so 2 sustain
        # ticks = 0.5s of sustained shed before a grow, and a 24-tick
        # cooldown (~6s) guarantees the bounded-decision audit even
        # over a converge window.
        autoscaler = Autoscaler(
            min_replicas=cfg.n_replicas,
            max_replicas=max(cfg.autoscale_max, cfg.n_replicas),
            sustain_ticks=2, cooldown_ticks=24, journal=journal)
    fleet = Fleet(
        model_dir, n_replicas=cfg.n_replicas, chain_dir=chain_dir,
        work_dir=os.path.join(base_dir, "work"), journal=journal,
        buckets=cfg.buckets, latency_budget_ms=cfg.latency_budget_ms,
        reload_poll_s=cfg.reload_poll_s,
        compile_cache_dir=os.path.join(base_dir, "compile_cache"),
        spawn_timeout_s=cfg.spawn_timeout_s,
        autoscaler=autoscaler, device=str(dev))
    fleet.start()
    door = FrontDoor(
        fleet, admission=AdmissionController(cfg.classes),
        journal=journal).start()
    return {"spec": spec, "params": params, "ck": ck,
            "chain_dir": chain_dir, "model_dir": model_dir,
            "fleet": fleet, "door": door, "journal": journal,
            "base_dir": base_dir, "step": 1, "tombstones": set()}


def _fleet_stats_delta(before: dict, after: dict) -> dict:
    return {k: int(after.get(k) or 0) - int(before.get(k) or 0)
            for k in ("accepted", "answered", "shed", "shed_queue",
                      "shed_deadline", "rejected", "timeout",
                      "failed", "retries")}


def _sigstop_publish_demote(ctx) -> int:
    """The demote race, made deterministic: SIGSTOP every replica (the
    reload pollers cannot observe the intermediate state), publish a
    new generation, demote it immediately, SIGCONT. Every poller then
    sees the tombstone before it could possibly swap — the veto path
    is exercised on every schedule instead of winning a wall-clock
    race."""
    import signal as _signal

    ck = ctx["ck"]
    fleet = ctx["fleet"]
    step = ctx["step"] + 1
    stopped = []
    for rep in fleet.replicas:
        if rep.proc is not None and rep.proc.poll() is None:
            try:
                os.kill(rep.proc.pid, _signal.SIGSTOP)
                stopped.append(rep.proc.pid)
            except OSError:
                pass
    try:
        ck.save(step, ctx["params"], {}, None, force=True)
        ck.wait()
        ck.demote(step, reason="fleet drill demote race")
    finally:
        for pid in stopped:
            try:
                os.kill(pid, _signal.SIGCONT)
            except OSError:
                pass
    ctx["step"] = step
    ctx["tombstones"].add(step)
    return step


def run_fleet_schedule(sched: FleetSchedule, cfg: FleetDrillConfig,
                       ctx: dict, out_dir: str) -> dict:
    """Run one fleet schedule against the shared stack and audit it
    from artifacts alone. Returns a chaos_verdict-style entry."""
    from fm_spark_tpu_torch import obs as _obs
    from fm_spark_tpu_torch.serve import loadgen

    os.makedirs(out_dir, exist_ok=True)
    door = ctx["door"]
    fleet = ctx["fleet"]
    schedule = loadgen.make_schedule(
        sched.shape, sched.seed, duration_s=cfg.duration_s,
        base_rps=cfg.base_rps, rows=cfg.rows,
        deadline_ms=cfg.deadline_ms)
    tap_path = os.path.join(out_dir, "tap.jsonl")
    before = door.stats()
    killed = None
    stop_watch = threading.Event()

    def kill_watcher():
        """SIGKILL a ready replica once ``kill_after_ok`` answers have
        landed — mid-burst by construction."""
        reg = _obs.registry()
        base = int(reg.peek("frontdoor.answered_total") or 0)
        while not stop_watch.wait(0.01):
            done = int(reg.peek("frontdoor.answered_total") or 0)
            if done - base >= sched.kill_after_ok:
                with fleet._lock:
                    ready = [r for r in fleet.replicas
                             if r.state == "ready"
                             and r.proc is not None]
                if ready:
                    rep = ready[sched.seed % len(ready)]
                    try:
                        os.kill(rep.proc.pid, 9)
                        nonlocal killed
                        killed = rep.idx
                    except OSError:
                        pass
                return

    watcher = None
    if sched.kill_after_ok is not None:
        watcher = threading.Thread(target=kill_watcher,
                                   name="fleet-kill-watcher",
                                   daemon=True)
        watcher.start()
    demoted_step = None
    t0 = time.perf_counter()
    if sched.plan:
        faults.activate(sched.plan)
    try:
        if sched.demote_race:
            # Fire the race ~mid-replay from a timer so traffic is in
            # flight when the publish+demote lands.
            race_timer = threading.Timer(
                0.4 * cfg.duration_s,
                lambda: ctx.update(
                    _race_step=_sigstop_publish_demote(ctx)))
            race_timer.start()
        loadgen.run_loadgen(
            "127.0.0.1", door.port, schedule, tap_path,
            nnz=cfg.num_fields, num_features=cfg.num_features,
            threads=cfg.threads)
        if sched.demote_race:
            race_timer.join()
            demoted_step = ctx.pop("_race_step", None)
    finally:
        faults.clear()
        stop_watch.set()
        if watcher is not None:
            watcher.join(timeout=5.0)
    # Close the books: every admitted request must reach a terminal
    # outcome before the counter snapshot is meaningful.
    deadline = time.monotonic() + cfg.converge_timeout_s
    while time.monotonic() < deadline:
        snap = door.admission.snapshot()
        if not any(snap["inflight"].values()):
            break
        time.sleep(0.05)
    violations = []
    # Recovery + convergence: after a kill, the fleet must re-admit a
    # respawned replica through the readiness gate, and every live
    # replica must converge to the same non-tombstoned tip.
    tip = ctx["step"] if not ctx["tombstones"] else max(
        s for s in range(1, ctx["step"] + 1)
        if s not in ctx["tombstones"])
    recovered_s = None
    t_rec = time.monotonic()
    while time.monotonic() - t_rec < cfg.converge_timeout_s:
        h = fleet.healthz()
        live = [r for r in h["replicas"] if r["state"] != "retired"]
        if (live and all(r["state"] == "ready" for r in live)
                and all(r["generation_step"] == tip for r in live)):
            recovered_s = time.monotonic() - t_rec
            break
        time.sleep(0.05)
    if recovered_s is None:
        h = fleet.healthz()
        states = [(r.get("replica"), r.get("state"),
                   r.get("generation_step")) for r in h["replicas"]]
        violations.append({
            "invariant": "staleness_bounded",
            "detail": f"fleet did not converge to tip {tip} within "
                      f"{cfg.converge_timeout_s:.0f}s: {states}"})
    counters = _fleet_stats_delta(before, door.stats())
    tap_events = read_events(tap_path)
    replica_events = {}
    for rep in fleet.replicas:
        jpath = os.path.join(fleet.work_dir,
                             f"replica_{rep.idx}.jsonl")
        if os.path.exists(jpath):
            replica_events[rep.idx] = read_events(jpath)
    violations.extend(audit_fleet(
        tap_events, counters,
        expected_requests=schedule.n_requests,
        tombstoned_steps=ctx["tombstones"],
        replica_events=replica_events))
    summary = loadgen.summarize_tap(tap_path)
    return {
        "seed": sched.seed, "scenario": sched.scenario,
        "plan": sched.plan, "expects": sched.expects,
        "outcome": "completed",
        "verdict": "green" if not violations else "failed",
        "violations": violations,
        "duration_s": round(time.perf_counter() - t0, 3),
        "traffic": {"shape": sched.shape,
                    "requests": schedule.n_requests,
                    **{k: summary["by_outcome"].get(k, 0)
                       for k in ("ok", "shed", "error", "timeout")}},
        "killed_replica": killed,
        "demoted_step": demoted_step,
        "recovery_s": (round(recovered_s, 3)
                       if recovered_s is not None else None),
        "counters": counters,
    }


def run_fleet_campaign(seeds=FLEET_TIER1_SEEDS,
                       cfg: "FleetDrillConfig | None" = None,
                       base_dir: "str | None" = None,
                       device=None) -> list[dict]:
    """The fleet/traffic half of the chaos campaign: one shared
    two-replica fleet on ``device`` (the card unless ``device="cpu"``),
    every seed's schedule replayed against it (faults cleared between
    schedules; counter deltas audited per schedule). Returns
    chaos_verdict-style entries."""
    import tempfile

    cfg = cfg or FleetDrillConfig()
    base_dir = base_dir or tempfile.mkdtemp(prefix="fleet_drill_")
    ctx = build_fleet_stack(cfg, base_dir, device=device)
    entries = []
    try:
        for seed in seeds:
            sched = fleet_schedule(seed)
            entries.append(run_fleet_schedule(
                sched, cfg, ctx,
                os.path.join(base_dir, f"f{int(seed)}")))
    finally:
        ctx["door"].stop()
        ctx["ck"].close()
    return entries


# ----------------------------------------------------- partition chaos

#: Partition drills: the network-fault plane
#: (resilience/netfaults.py) composed with traffic shapes — the
#: scenario the process-kill model cannot express: the parent loses
#: the LINK to a replica whose process stays perfectly healthy.
#: Graded by the partition extensions of :func:`audit_fleet`
#: (partition_not_a_crash, autoscale_converged) on top of the usual
#: exactly-once/closed-books contracts.

PARTITION_TIER1_SEEDS = (0, 1, 2)

_PARTITION_SCENARIOS = ("partition_flash_crowd", "slow_link_reload",
                        "truncate_retry_storm",
                        "scaleup_race_partition")


@dataclasses.dataclass(frozen=True)
class PartitionSchedule:
    """One seeded partition drill: net-fault rules (peer-scoped
    occurrence windows over ``net_connect``/``net_send``/``net_recv``)
    composed with a loadgen shape, optionally with a mid-replay chain
    publish pressed through the slow link. ``victim`` names the
    replica the parent is partitioned from (None: the fault is
    fleet-wide, not a partition). Pure function of the seed."""

    seed: int
    scenario: str
    shape: str
    rules: tuple = ()
    victim: "int | None" = None
    publish_mid_replay: bool = False
    expects: str = "completed"

    @property
    def plan(self) -> str:
        return ";".join(self.rules)

    def validate(self) -> "PartitionSchedule":
        faults.FaultPlan.from_spec(self.plan)
        from fm_spark_tpu_torch.serve import loadgen

        if self.shape not in loadgen.SHAPES:
            raise ValueError(f"unknown traffic shape {self.shape!r}")
        return self


def partition_schedule(seed: int,
                       n_replicas: int = 2) -> PartitionSchedule:
    """Seeded partition drill — scenario by ``seed % 4``, parameters
    from the seeded rng (same purity contract as every schedule: the
    failing entry IS its repro).

    ``partition_flash_crowd``   the parent loses one replica's link
                                (dials refused, writes reset) right as
                                a flash crowd lands: accepted traffic
                                retries onto the surviving replica,
                                the victim is drained then readmitted
                                after heal — never respawned
    ``slow_link_reload``        one replica's response reads gain tens
                                of ms of injected latency while the
                                trainer publishes a new generation:
                                the fleet converges to the tip anyway
    ``truncate_retry_storm``    fleet-wide response truncations under
                                a retry storm: a truncated response is
                                recv-phase — NEVER replayed on another
                                replica (the 503 goes back to the
                                client, whose own retry keeps the
                                books exactly-once)
    ``scaleup_race_partition``  a partition_storm sheds hard enough to
                                wake the autoscaler while one replica
                                is partitioned away: grow races drain,
                                and the decision log must stay bounded
    """
    rng = random.Random(0x5EED ^ (int(seed) << 4))
    scenario = _PARTITION_SCENARIOS[int(seed)
                                    % len(_PARTITION_SCENARIOS)]
    victim: "int | None" = rng.randrange(max(1, int(n_replicas)))
    publish = False
    if scenario == "partition_flash_crowd":
        shape = "flash_crowd"
        # Window sized in OCCURRENCES (each health poll consumes one
        # dial, each dispatch write one send): wide enough that the
        # victim is reliably drained mid-crowd; the runner's
        # faults.clear() after replay is the heal.
        k = rng.randint(20, 32)
        rules = (f"net_connect.replica-{victim}@1-{k}=refuse",
                 f"net_send.replica-{victim}@1-{k}=reset")
    elif scenario == "slow_link_reload":
        shape = "diurnal"
        ms = rng.choice((20, 40, 60))
        k = rng.randint(12, 24)
        rules = (f"net_recv.replica-{victim}@1-{k}=slow_ms:{ms}",)
        victim = None   # slow, not severed: no drain is required
        publish = True
    elif scenario == "truncate_retry_storm":
        shape = "retry_storm"
        cut = rng.choice((5, 16, 48))
        occs = sorted(rng.sample(range(3, 40), 3))
        rules = tuple(f"net_recv@{n}=truncate_after:{cut}"
                      for n in occs)
        victim = None   # fleet-wide recv faults, not a partition
    else:  # scaleup_race_partition
        shape = "partition_storm"
        k = rng.randint(20, 32)
        rules = (f"net_connect.replica-{victim}@1-{k}=refuse",
                 f"net_send.replica-{victim}@1-{k}=reset")
    return PartitionSchedule(int(seed), scenario, shape,
                             tuple(rules), victim=victim,
                             publish_mid_replay=publish).validate()


def _publish_step(ctx) -> int:
    """Publish one new (non-demoted) generation mid-replay: the
    reload traffic a slow link must carry without wedging the
    follower."""
    ck = ctx["ck"]
    step = ctx["step"] + 1
    ck.save(step, ctx["params"], {}, None, force=True)
    ck.wait()
    ctx["step"] = step
    return step


def run_partition_schedule(sched: PartitionSchedule,
                           cfg: FleetDrillConfig, ctx: dict,
                           out_dir: str) -> dict:
    """Run one partition schedule against the shared stack; grade it
    from artifacts alone (tap + counters + the run's own slice of
    ``fleet_health.jsonl``)."""
    from fm_spark_tpu_torch.serve import loadgen

    os.makedirs(out_dir, exist_ok=True)
    door = ctx["door"]
    fleet = ctx["fleet"]
    journal_path = os.path.join(ctx["base_dir"],
                                "fleet_health.jsonl")
    n_journal0 = len(read_events(journal_path))
    schedule = loadgen.make_schedule(
        sched.shape, sched.seed, duration_s=cfg.duration_s,
        base_rps=cfg.base_rps, rows=cfg.rows,
        deadline_ms=cfg.deadline_ms)
    tap_path = os.path.join(out_dir, "tap.jsonl")
    before = door.stats()
    published_step = None
    t0 = time.perf_counter()
    faults.activate(sched.plan)
    try:
        pub_timer = None
        if sched.publish_mid_replay:
            pub_timer = threading.Timer(
                0.4 * cfg.duration_s,
                lambda: ctx.update(_pub_step=_publish_step(ctx)))
            pub_timer.start()
        loadgen.run_loadgen(
            "127.0.0.1", door.port, schedule, tap_path,
            nnz=cfg.num_fields, num_features=cfg.num_features,
            threads=cfg.threads)
        if pub_timer is not None:
            pub_timer.join()
            published_step = ctx.pop("_pub_step", None)
    finally:
        # The heal: whatever occurrence window is left, the plan
        # clears here — readmission is graded below.
        faults.clear()
    deadline = time.monotonic() + cfg.converge_timeout_s
    while time.monotonic() < deadline:
        snap = door.admission.snapshot()
        if not any(snap["inflight"].values()):
            break
        time.sleep(0.05)
    violations = []
    tip = ctx["step"] if not ctx["tombstones"] else max(
        s for s in range(1, ctx["step"] + 1)
        if s not in ctx["tombstones"])
    healed_s = None
    t_rec = time.monotonic()
    while time.monotonic() - t_rec < cfg.converge_timeout_s:
        h = fleet.healthz()
        live = [r for r in h["replicas"]
                if r["state"] not in ("retired", "parked")]
        if (live and all(r["state"] == "ready" for r in live)
                and all(r["generation_step"] == tip for r in live)):
            healed_s = time.monotonic() - t_rec
            break
        time.sleep(0.05)
    if healed_s is None:
        h = fleet.healthz()
        states = [(r.get("replica"), r.get("state"),
                   r.get("generation_step")) for r in h["replicas"]]
        violations.append({
            "invariant": "partition_not_a_crash",
            "detail": f"fleet did not heal to tip {tip} within "
                      f"{cfg.converge_timeout_s:.0f}s of the plan "
                      f"clearing: {states}"})
    counters = _fleet_stats_delta(before, door.stats())
    replica_events = {}
    for rep in fleet.replicas:
        jpath = os.path.join(fleet.work_dir,
                             f"replica_{rep.idx}.jsonl")
        if os.path.exists(jpath):
            replica_events[rep.idx] = read_events(jpath)
    fleet_events = read_events(journal_path)[n_journal0:]
    violations.extend(audit_fleet(
        read_events(tap_path), counters,
        expected_requests=schedule.n_requests,
        tombstoned_steps=ctx["tombstones"],
        replica_events=replica_events,
        fleet_events=fleet_events,
        partition_victim=sched.victim,
        max_autoscale_decisions=(3 if fleet.autoscaler is not None
                                 else None)))
    summary = loadgen.summarize_tap(tap_path)
    n_decisions = sum(
        1 for e in fleet_events
        if (e.get("event") or e.get("kind")) == "autoscale_decision")
    return {
        "seed": sched.seed, "scenario": sched.scenario,
        "plan": sched.plan, "expects": sched.expects,
        "outcome": "completed",
        "verdict": "green" if not violations else "failed",
        "violations": violations,
        "duration_s": round(time.perf_counter() - t0, 3),
        "traffic": {"shape": sched.shape,
                    "requests": schedule.n_requests,
                    **{k: summary["by_outcome"].get(k, 0)
                       for k in ("ok", "shed", "error", "timeout")}},
        "victim": sched.victim,
        "published_step": published_step,
        "autoscale_decisions": n_decisions,
        "healed_s": (round(healed_s, 3)
                     if healed_s is not None else None),
        "counters": counters,
    }


def run_partition_campaign(seeds=PARTITION_TIER1_SEEDS,
                           cfg: "FleetDrillConfig | None" = None,
                           base_dir: "str | None" = None,
                           device=None) -> list[dict]:
    """The partition half of the fleet chaos campaign: one shared
    fleet on ``device`` (the card unless ``device="cpu"``) WITH the
    autoscaler armed (scale-up must be able to race a partition), every
    seed's schedule replayed against it, faults cleared between
    schedules."""
    import tempfile

    cfg = cfg or FleetDrillConfig(autoscale_max=3)
    base_dir = base_dir or tempfile.mkdtemp(prefix="partition_drill_")
    ctx = build_fleet_stack(cfg, base_dir, device=device)
    entries = []
    try:
        for seed in seeds:
            sched = partition_schedule(seed,
                                       n_replicas=cfg.n_replicas)
            entries.append(run_partition_schedule(
                sched, cfg, ctx,
                os.path.join(base_dir, f"p{int(seed)}")))
    finally:
        ctx["door"].stop()
        ctx["ck"].close()
    return entries


# --------------------------------------------------------------------
# Storage-fault drills: the disk plane over the durable seam.

DISK_TIER1_SEEDS = (0, 1, 2, 3, 4)

_DISK_SCENARIOS = ("enospc_ckpt_commit", "torn_rename_demote",
                   "slow_disk_day_save", "eio_flight_compact",
                   "readonly_obs_flip")


@dataclasses.dataclass(frozen=True)
class DiskSchedule:
    """One seeded disk drill: ``io_*`` rules (path-class-scoped
    occurrence windows over the durable seam) composed with a
    checkpoint-chain shape — setup saves, an optional demotion
    (optionally UNDER the plan, racing a chain follower), then final
    saves with the plan armed. Pure function of the seed."""

    seed: int
    scenario: str
    rules: tuple = ()
    setup_saves: int = 3
    final_saves: int = 1
    demote_cut: "int | None" = None
    demote_armed: bool = False
    arm_at_start: bool = False
    expects: str = "completed"

    @property
    def plan(self) -> str:
        return ";".join(self.rules)

    def validate(self) -> "DiskSchedule":
        if self.rules:
            faults.FaultPlan.from_spec(self.plan)
        return self


def disk_schedule(seed: int) -> DiskSchedule:
    """Seeded disk drill — scenario by ``seed % 5``, parameters from
    the seeded rng (same purity contract as every schedule: the
    failing entry IS its repro).

    ``enospc_ckpt_commit``  the disk fills exactly at the next
                            checkpoint commit, with demoted
                            generations sitting on it: the emergency
                            GC journals its intent, frees the
                            tombstoned steps, and the SAME commit
                            retries through — loud failure only if
                            the disk is full of live data
    ``torn_rename_demote``  the atomic rename publishing a demotion's
                            range tombstone fails mid-demotion while
                            a serve-reload follower restores
                            concurrently: the follower sees the old
                            tip or the walk-back target, NEVER a torn
                            pointer or a condemned step
    ``slow_disk_day_save``  multi-tick fsync stalls land on the
                            day-boundary save: slower, never wronger
                            (latency scaled by FM_SPARK_TEST_SLEEP_
                            SCALE)
    ``eio_flight_compact``  an EIO burst lands mid flight-spool
                            compaction: the ring keeps recording, the
                            append handle is re-established, on-disk
                            seqs never regress, training bytes are
                            byte-identical to the golden run
    ``readonly_obs_flip``   the filesystem flips read-only under the
                            WHOLE obs plane: every telemetry write
                            fails best-effort, counted and flagged
                            (``obs/io_degraded``), and the final
                            params are byte-identical to golden
    """
    rng = random.Random(0xD15C ^ (int(seed) << 4))
    scenario = _DISK_SCENARIOS[int(seed) % len(_DISK_SCENARIOS)]
    if scenario == "enospc_ckpt_commit":
        # One ENOSPC: the emergency GC frees the demoted generations
        # and the retry lands. Two: the disk is "full of live data"
        # even after GC — the loud CheckpointIOError is the DESIGNED
        # outcome, classified by the supervisor, never a silent loss.
        k = rng.randint(1, 2)
        return DiskSchedule(
            int(seed), scenario,
            (f"io_write.ckpt@1-{k}=enospc",),
            demote_cut=1,
            expects=("completed" if k == 1
                     else "checkpoint_io_error")).validate()
    if scenario == "torn_rename_demote":
        rule = rng.choice(("io_rename.ckpt@1=eio",
                           f"io_rename.ckpt@1=torn_write:"
                           f"{rng.choice((3, 9, 17))}"))
        return DiskSchedule(
            int(seed), scenario, (rule,),
            final_saves=0, demote_cut=1,
            demote_armed=True).validate()
    if scenario == "slow_disk_day_save":
        ms = rng.choice((40, 80, 120))
        k = rng.randint(2, 4)
        return DiskSchedule(
            int(seed), scenario,
            (f"io_fsync.ckpt@1-{k}=slow_ms:{ms}",)).validate()
    if scenario == "eio_flight_compact":
        lo = rng.randint(6, 12)
        hi = lo + rng.randint(10, 30)
        return DiskSchedule(
            int(seed), scenario,
            (f"io_write.obs@{lo}-{hi}=eio",),
            setup_saves=4, final_saves=0,
            arm_at_start=True).validate()
    # readonly_obs_flip
    return DiskSchedule(
        int(seed), scenario,
        ("io_write.obs@1-512=readonly",),
        setup_saves=4, final_saves=0,
        arm_at_start=True).validate()


def _disk_step(params: dict, step: int) -> dict:
    """One deterministic numpy 'train step': pure function of
    (params, step), with NO dependence on the obs/disk plane — the
    byte-identity invariant's whole point."""
    import numpy as np

    w = params["w"]
    return {"w": (w * np.float32(0.75)
                  + np.sin(np.arange(w.size, dtype=np.float32)
                           * np.float32(step))).astype(np.float32)}


def run_disk_schedule(sched: DiskSchedule, workdir: str,
                      golden_sums: "dict | None" = None,
                      device=None) -> dict:
    """Run one disk schedule against a fresh lightweight stack
    (Checkpointer + FlightRecorder + EventLog journal over numpy
    params — the durable surface without a trainer) and grade it from
    artifacts alone via :func:`audit_disk`. Each save snapshots the
    params from ``device`` (the card unless ``device="cpu"``: the
    pinned copy a trainer's save makes) and commits before the next
    step, as the reference's synchronous saves do."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import obs, resolve_device
    from fm_spark_tpu_torch.checkpoint import (
        ChainFollower,
        Checkpointer,
        CheckpointIOError,
        _step_json_names,
    )
    from fm_spark_tpu_torch.obs.flight import FlightRecorder, read_spool
    from fm_spark_tpu_torch.utils import durable

    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)
    ck_dir = os.path.join(workdir, "ck")
    obs_dir = os.path.join(workdir, "obs")
    os.makedirs(obs_dir, exist_ok=True)
    spool_path = os.path.join(obs_dir, "flight_spool.jsonl")
    journal_path = os.path.join(obs_dir, "events.jsonl")
    # Small capacity: 4 ticks/step compacts the spool every other
    # step, so compaction itself sits inside every fault window.
    flight = FlightRecorder(capacity=8, spool_path=spool_path)
    journal = EventLog(journal_path)
    ck = Checkpointer(ck_dir, save_every=1, max_to_keep=16,
                      journal=journal)
    fails0 = dict(durable.io_failure_counts())
    params = {"w": np.zeros(16, np.float32)}
    example = {"w": torch.zeros(16, dtype=torch.float32)}
    step = 0
    outcome, err = "completed", None
    follower_samples: list = []
    t0 = time.perf_counter()

    def _tick(s: int) -> dict:
        p = _disk_step(params, s)
        for i in range(4):
            flight.record("disk_drill_tick", step=s, i=i)
        journal.emit("disk_drill_step", step=s)
        ck.save(s, {"w": torch.from_numpy(p["w"]).to(dev)}, {},
                force=True)
        ck.wait()
        return p

    try:
        if sched.arm_at_start and sched.rules:
            faults.activate(sched.plan)
        for _ in range(sched.setup_saves):
            step += 1
            params = _tick(step)
        if sched.demote_cut is not None:
            stop = threading.Event()
            sampler = None
            if sched.demote_armed:
                faults.activate(sched.plan)

                def _poll() -> None:
                    # The racing serve reload: a follower restoring
                    # WHILE the demotion's stone publish is failing.
                    fol = ChainFollower(ck_dir)
                    ex = {"w": torch.zeros(16, dtype=torch.float32)}
                    try:
                        while not stop.is_set():
                            r = fol.restore(ex)
                            follower_samples.append(
                                None if r is None else int(r["step"]))
                            time.sleep(0.002)
                    finally:
                        fol.close()

                sampler = threading.Thread(target=_poll, daemon=True)
                sampler.start()
            try:
                ck.demote_newer_than(sched.demote_cut,
                                     reason=f"disk drill "
                                            f"{sched.scenario}")
            finally:
                stop.set()
                if sampler is not None:
                    sampler.join(timeout=30)
        if sched.final_saves and not sched.arm_at_start and sched.rules:
            faults.activate(sched.plan)
        for _ in range(sched.final_saves):
            step += 1
            params = _tick(step)
    except CheckpointIOError as e:
        outcome, err = "checkpoint_io_error", str(e)
    except OSError as e:
        outcome, err = f"oserror:{e.errno}", str(e)
    finally:
        # The heal: whatever occurrence window is left, the plan
        # clears here — recovery is graded below.
        faults.clear()
        try:
            ck.close()
        except Exception:
            pass
    # Post-heal: the obs plane must still accept writes (the append
    # handle was re-established), and a FRESH reader grades the chain.
    flight.record("disk_drill_healed", step=step)
    journal.emit("disk_drill_healed", step=step)
    fails = {k: v - fails0.get(k, 0)
             for k, v in durable.io_failure_counts().items()}
    follower = ChainFollower(ck_dir)
    try:
        committed = sorted(_step_json_names(follower._manifest_dir))
        stones = follower.tombstoned_steps()
        last_good = follower.last_good_step()
        restored = follower.restore(example)
        restored_step = (None if restored is None
                         else int(restored["step"]))
    finally:
        follower.close()
    gauges = obs.registry().snapshot().get("gauges", {})
    if sched.demote_cut is not None:
        surviving = {sched.demote_cut}
        if sched.expects == "completed":
            # Post-demotion saves only commit when the run completes;
            # a designed-loud failure leaves just the walk-back target.
            surviving |= set(range(sched.setup_saves + 1,
                                   sched.setup_saves
                                   + sched.final_saves + 1))
    else:
        surviving = set(range(1, step + 1))
    sums = _params_sums(params)
    violations = audit_disk(
        committed_steps=committed, tombstoned_steps=stones,
        last_good_step=last_good, restored_step=restored_step,
        expected_surviving=surviving,
        io_failures=fails,
        degraded_gauge=gauges.get("obs/io_degraded"),
        params_match=(None if golden_sums is None
                      else sums == golden_sums),
        spool_seqs=[r["seq"] for r in read_spool(spool_path)
                    if "seq" in r])
    if sched.demote_armed:
        # The race's own invariant: every concurrent restore landed on
        # the old tip or the walk-back target — never a condemned step,
        # never nothing.
        allowed = {sched.setup_saves, sched.demote_cut}
        bad = sorted({s for s in follower_samples
                      if s not in allowed}, key=str)
        if bad or not follower_samples:
            violations.append(_violation(
                "chain_never_broken",
                f"racing follower observed restores {bad or '(none)'} "
                f"mid-demotion; only {sorted(allowed)} are "
                "consistent states"))
    if outcome != sched.expects:
        violations.append(_violation(
            "outcome_expected",
            f"outcome {outcome!r} (expected {sched.expects!r})"
            + (f": {err}" if err else "")))
    if (any("io_write.obs" in r for r in sched.rules)
            and not fails.get("obs")):
        violations.append(_violation(
            "degradation_signaled",
            "plan targets the obs path class but no obs write "
            "failure was recorded — the fault never reached the "
            "durable seam"))
    events = read_events(journal_path)
    kinds = [e.get("event") or e.get("kind") for e in events]
    return {
        "seed": sched.seed, "scenario": sched.scenario,
        "plan": sched.plan, "expects": sched.expects,
        "outcome": outcome, "error": err,
        "verdict": "green" if not violations else "failed",
        "violations": violations,
        "duration_s": round(time.perf_counter() - t0, 3),
        "last_good": last_good, "restored_step": restored_step,
        "committed_steps": committed,
        "tombstoned_steps": sorted(stones),
        "io_failures": fails,
        "io_retries": kinds.count("ckpt_io_retry"),
        "emergency_gcs": kinds.count("ckpt_emergency_gc"),
        "follower_samples": sorted(
            {s for s in follower_samples}, key=str),
        "steps_done": step,
        "params_sums": sums,
    }


_GC_WORKER = '''\
import os, sys
import torch
from fm_spark_tpu_torch.checkpoint import Checkpointer
from fm_spark_tpu_torch.resilience import faults
ck_dir, plan, target = sys.argv[1], sys.argv[2], int(sys.argv[3])
ck = Checkpointer(ck_dir, save_every=1, max_to_keep=16)
if ck.last_good_step() is None:
    for s in (1, 2, 3):
        ck.save(s, {"w": torch.arange(4, dtype=torch.float32) * s}, {},
                force=True)
    ck.wait()
    ck.demote_newer_than(1, reason="gc drill drift verdict")
if plan:
    faults.activate(plan)
ck.save(target, {"w": torch.arange(4, dtype=torch.float32) * target}, {},
        force=True)
ck.close()
print("gc drill save", target, "ok")
'''


def run_gc_kill_drill(workdir: str, *, exit_rc: int = 29) -> dict:
    """The SIGKILL-during-emergency-GC drill: a subprocess hits ENOSPC at a checkpoint commit with demoted
    generations on disk, and is hard-killed INSIDE the emergency GC —
    after the ``ckpt_emergency_gc`` intent event, before any deletion
    (the ``ckpt_gc`` fault point). The audit proves, from artifacts
    alone, that every reader still lands on a loadable ``last_good``,
    and that a recovery re-run completes a later commit cleanly.
    Returns ``{"violations": [...], "rcs": [...]}``. The worker's chain
    is host tensors: nothing here touches a device."""
    import torch

    from fm_spark_tpu_torch.checkpoint import ChainFollower, _step_json_names

    os.makedirs(workdir, exist_ok=True)
    ck_dir = os.path.join(workdir, "ck")
    worker = os.path.join(workdir, "gc_worker.py")
    with open(worker, "w") as f:
        f.write(_GC_WORKER)
    env = dict(os.environ, FM_SPARK_OBS_DIR="none",
               PYTHONPATH=_REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    plan = f"io_write.ckpt@1=enospc;ckpt_gc@1=exit:{exit_rc}"
    v: list[dict] = []
    rcs = []
    proc = subprocess.run([sys.executable, worker, ck_dir, plan, "4"],
                          cwd=_REPO, env=env, capture_output=True,
                          timeout=180)
    rcs.append(proc.returncode)
    if proc.returncode != exit_rc:
        v.append(_violation(
            "rc_discipline",
            f"gc worker exited rc={proc.returncode}, expected the "
            f"injected {exit_rc}: {proc.stderr.decode()[-300:]}"))
    ex = {"w": torch.zeros(4, dtype=torch.float32)}
    follower = ChainFollower(ck_dir)
    try:
        restored = follower.restore(ex)
        v.extend(audit_disk(
            committed_steps=_step_json_names(follower._manifest_dir),
            tombstoned_steps=follower.tombstoned_steps(),
            last_good_step=follower.last_good_step(),
            restored_step=(None if restored is None
                           else int(restored["step"]))))
        if restored is None or restored["step"] != 1:
            v.append(_violation(
                "chain_never_broken",
                f"reader restored "
                f"{restored and restored['step']} after the mid-GC "
                "kill; must land on the pre-drift save 1"))
    finally:
        follower.close()
    # Recovery: a clean re-run commits the NEXT step; the torn step-4
    # commit (its data, no manifest) stays invisible to readers.
    proc2 = subprocess.run([sys.executable, worker, ck_dir, "", "5"],
                           cwd=_REPO, env=env, capture_output=True,
                           timeout=180)
    rcs.append(proc2.returncode)
    if proc2.returncode != 0:
        v.append(_violation(
            "rc_discipline",
            f"recovery re-run exited rc={proc2.returncode}: "
            f"{proc2.stderr.decode()[-300:]}"))
    follower2 = ChainFollower(ck_dir)
    try:
        restored2 = follower2.restore(ex)
        v.extend(audit_disk(
            committed_steps=_step_json_names(follower2._manifest_dir),
            tombstoned_steps=follower2.tombstoned_steps(),
            last_good_step=follower2.last_good_step(),
            restored_step=(None if restored2 is None
                           else int(restored2["step"])),
            expected_surviving={1, 5}))
        if follower2.last_good_step() != 5:
            v.append(_violation(
                "last_good_loadable",
                f"last_good {follower2.last_good_step()} after "
                "recovery; the re-run's commit must republish at 5"))
    finally:
        follower2.close()
    return {"violations": v, "rcs": rcs}


def run_disk_campaign(seeds=DISK_TIER1_SEEDS,
                      base_dir: "str | None" = None,
                      include_kill_drill: bool = True,
                      device=None) -> list[dict]:
    """The storage half of the chaos campaign on ``device`` (the card
    unless ``device="cpu"``): golden run first (the identical stack, no
    faults — the byte-identity baseline), then every seed's schedule
    against a FRESH stack, then the SIGKILL-during-emergency-GC
    subprocess drill. Returns chaos_verdict-style entries."""
    import tempfile

    from fm_spark_tpu_torch import resolve_device

    device = resolve_device(device)
    base_dir = base_dir or tempfile.mkdtemp(prefix="disk_drill_")
    golden = run_disk_schedule(
        DiskSchedule(-1, "golden", (), setup_saves=4, final_saves=0),
        os.path.join(base_dir, "golden"), device=device)
    golden["scenario"] = "golden"
    entries = [golden]
    for seed in seeds:
        sched = disk_schedule(seed)
        # Byte-identity only compares runs that took the same number
        # of steps AND expect to complete them; designed-loud or
        # shorter schedules are graded on chain invariants alone.
        total = sched.setup_saves + sched.final_saves
        comparable = (sched.expects == "completed"
                      and total == golden["steps_done"])
        entries.append(run_disk_schedule(
            sched, os.path.join(base_dir, f"d{int(seed)}"),
            golden_sums=(golden["params_sums"]
                         if comparable else None), device=device))
    if include_kill_drill:
        kill = run_gc_kill_drill(os.path.join(base_dir, "gc_kill"))
        entries.append({
            "seed": None, "scenario": "gc_kill_recovery",
            "plan": "io_write.ckpt@1=enospc;ckpt_gc@1=exit:29",
            "expects": "killed_then_recovered",
            "outcome": "killed_then_recovered",
            "verdict": ("green" if not kill["violations"]
                        else "failed"),
            "violations": kill["violations"],
            "rcs": kill["rcs"],
        })
    return entries


#: Re-export: the auditor lives in the standalone, import-free
#: :mod:`fm_spark_tpu_torch.resilience.chaos_audit` so light tools can
#: load it BY PATH without importing the package; the chaos API keeps
#: its name here.
from fm_spark_tpu_torch.resilience.chaos_audit import (  # noqa: E402
    audit_disk,
    audit_fleet,
    audit_serve_events,
)
