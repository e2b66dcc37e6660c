"""The retry/timeout/backoff state machine around device work (the
port's copy of ``fm_spark_tpu/resilience/supervisor.py``).

- **Bounded exponential backoff with deterministic jitter**
  (:class:`BackoffPolicy`): the delay doubles per consecutive failure,
  is capped, and jitters by a seeded RNG (reproducible in tests).
- **A cheap health probe** (:func:`device_probe`): the card's
  enumeration and one tiny launch with a synchronise, in a thread under
  a join timeout, so a hung driver becomes ``False`` instead of a stuck
  process.
- **A circuit breaker**: after N consecutive failed operations the
  supervisor stops retrying and raises :class:`CircuitOpen`; a later
  healthy probe half-opens it for one trial.
- **A health-event journal**: every transition goes to a JSONL
  :class:`~fm_spark_tpu_torch.utils.logging.EventLog`.

Two entry points: :meth:`Supervisor.run` wraps a whole retryable
operation; :meth:`Supervisor.recover` is the incremental form for a
caller that owns its loop (``FMTrainer.fit`` catches the device loss,
asks the supervisor to account, probe and back off, then restores its
newest verified step in place).

**A deliberate divergence: a lost CUDA context ends the process.** On
the card a sticky error (an illegal address, an unspecified launch
failure, an uncorrectable ECC error) poisons the process's CUDA context:
every later call on it fails the same way. A probe in such a process
runs its tiny launch on that context, which raises, so it reports
``False`` with ``context_lost``; :meth:`Supervisor.recover` then opens
the breaker at once instead of backing off and retrying into the dead
context, and the run exits for a restart that resumes from the chain
(the elastic parent of ``fmtorch train --elastic``, or whatever runs the
command again). The reference's probe enumerates devices alone, because
a TPU attachment comes back within one process.
"""

from __future__ import annotations

import dataclasses
import random
import threading
import time

from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.resilience import faults
from fm_spark_tpu_torch.resilience.faults import is_device_loss

__all__ = [
    "BackoffPolicy",
    "CircuitOpen",
    "RetriesExhausted",
    "Supervisor",
    "device_probe",
]


@dataclasses.dataclass(frozen=True)
class BackoffPolicy:
    """Bounded exponential backoff: ``initial * multiplier**(k-1)``
    seconds after the k-th consecutive failure, capped at ``max_delay``,
    jittered by ±``jitter`` fraction (seeded RNG — deterministic in
    tests). ``max_attempts`` bounds one :meth:`Supervisor.run` call."""

    initial: float = 1.0
    multiplier: float = 2.0
    max_delay: float = 60.0
    jitter: float = 0.1
    max_attempts: int = 4

    def delay(self, failure_index: int, rng: random.Random | None = None
              ) -> float:
        from fm_spark_tpu_torch.utils.sleeps import sleep_scale

        d = min(
            self.initial * self.multiplier ** max(failure_index - 1, 0),
            self.max_delay,
        ) * sleep_scale()  # designed sleep: FM_SPARK_TEST_SLEEP_SCALE
        if self.jitter and rng is not None:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(d, 0.0)


class RetriesExhausted(RuntimeError):
    """One operation failed ``max_attempts`` times; the last underlying
    exception rides as ``__cause__``."""


class CircuitOpen(RuntimeError):
    """The breaker tripped: N consecutive operations failed and the
    probe still reports the attachment unhealthy — stop retrying and
    degrade (salvage what completed) instead of burning the deadline."""


def device_probe(timeout: float = 30.0, device=None,
                 detail: dict | None = None) -> bool:
    """Cheap health probe of ``device`` (default: the current card; a
    CPU device answers from a host op): the card's enumeration, one tiny
    launch and a synchronise, in a thread under a join timeout, so a
    hung driver becomes ``False`` instead of a stuck process. The
    ``probe`` fault point makes the outcome injectable. ``detail``, when
    given, receives ``error`` (the probe's own exception, if any) and
    ``context_lost``: the launch itself raised, so this process's CUDA
    context is unusable (a sticky error) and only a new process can use
    the card."""
    import torch

    out: dict = {}

    def _enumerate():
        try:
            faults.inject("probe")
        except Exception as e:  # noqa: BLE001 — an injected failure
            out["n"], out["error"] = 0, e
            return
        try:
            dev = torch.device(device) if device is not None else None
            if dev is not None and dev.type == "cpu":
                out["n"] = int(torch.ones(1).add_(1).sum() == 2)
                return
            n = torch.cuda.device_count()
            if n == 0:
                out["n"] = 0
                return
            dev = dev or torch.device("cuda", torch.cuda.current_device())
            x = torch.ones(1, device=dev)
            x.add_(1)
            torch.cuda.synchronize(dev)
            out["n"] = n
        except Exception as e:  # noqa: BLE001 — the context's own error
            out["n"], out["error"] = 0, e
            out["context_lost"] = True

    t = threading.Thread(target=_enumerate, daemon=True)
    t.start()
    t.join(timeout)
    if detail is not None:
        detail["error"] = out.get("error")
        detail["context_lost"] = bool(out.get("context_lost"))
        detail["timed_out"] = t.is_alive()
    return bool(out.get("n"))


class Supervisor:
    """Retry/backoff/circuit-breaker runtime around device-touching work.

    State machine: ``closed`` (normal) → ``open`` after
    ``breaker_threshold`` consecutive failed operations → ``half_open``
    when a probe reports the attachment healthy again → ``closed`` on
    the next success. Every transition and retry is journaled.

    ``probe``/``sleep`` are injectable so the whole machine unit-tests
    without a device or wall clock. ``device`` is the device the default
    probe (:func:`device_probe`) checks (the port's addition: one
    process drives one card, or the CPU in the tests).
    """

    def __init__(self, policy: BackoffPolicy | None = None, journal=None,
                 probe=None, probe_timeout: float = 30.0,
                 breaker_threshold: int = 3, seed: int = 0,
                 sleep=time.sleep, device=None):
        self.policy = policy or BackoffPolicy()
        self.journal = journal
        self.probe_timeout = probe_timeout
        self.breaker_threshold = breaker_threshold
        self.device = device
        self._set_state("closed")
        self.consecutive_failures = 0
        # Cumulative over the supervisor's whole life (survives
        # note_success/reset): a caller deltas it around one operation.
        self.total_failures = 0
        # Identity tracking for the transient-vs-permanent verdict
        # (resilience/elastic.py): a run of IDENTICAL failures (numerals
        # normalized) is the signature of a dead attachment, not a flap.
        self.last_failure: str | None = None
        self.identical_failures = 0
        #: Whether the last default probe found this process's CUDA
        #: context lost (a sticky error): see the module docstring.
        self.context_lost = False
        self._probe = probe
        self._sleep = sleep
        self._rng = random.Random(seed)

    # ------------------------------------------------------------ events

    _BREAKER_STATES = ("closed", "half_open", "open")

    def _emit(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.emit(event, **fields)
        # Telemetry side channel: failure/backoff totals as registry
        # instruments, and a flight dump at the terminal verdicts.
        # Best-effort by the journal contract.
        try:
            if event == "failure":
                self.total_failures += 1
                obs.counter("resilience.failures_total").add(1)
            elif event == "backoff":
                obs.counter("resilience.backoffs_total").add(1)
            elif event == "probe":
                obs.counter("resilience.probes_total").add(1)
                if not fields.get("healthy"):
                    obs.counter("resilience.probe_failures_total").add(1)
            if event in ("circuit_open", "permanent_fault"):
                obs.flight_dump(event, **{
                    k: v for k, v in fields.items() if k != "reason"})
        except Exception:
            pass

    def _set_state(self, state: str) -> None:
        """The ONLY writer of breaker state: keeps the registry gauge
        exactly in lockstep with every transition."""
        self.state = state
        try:
            obs.gauge("resilience.breaker_state").set(
                self._BREAKER_STATES.index(state))
        except Exception:
            pass

    @staticmethod
    def _describe(exc: BaseException) -> str:
        first = (str(exc).splitlines() or [""])[0]
        return f"{type(exc).__name__}: {first[:200]}"

    def _note_failure_identity(self, exc: BaseException) -> None:
        """Track runs of identical failures (the permanent-fault
        signature — elastic.classify_failures semantics)."""
        from fm_spark_tpu_torch.resilience.elastic import normalize_failure

        desc = self._describe(exc)
        if (self.last_failure is not None
                and normalize_failure(desc)
                == normalize_failure(self.last_failure)):
            self.identical_failures += 1
        else:
            self.identical_failures = 1
        self.last_failure = desc

    def permanent(self, threshold: int | None = None) -> bool:
        """Is the current failure run classified PERMANENT — the same
        failure, ``threshold`` (default: ``breaker_threshold``) times in
        a row? The elastic controller's shrink trigger; a mixed failure
        run keeps the transient verdict (keep retrying/backing off)."""
        t = self.breaker_threshold if threshold is None else threshold
        return self.identical_failures >= max(t, 1)

    def health_verdict(self) -> str:
        """``down`` when the breaker is open or the failure run
        classifies permanent, ``flaky`` while a failure streak is live,
        else ``healthy``."""
        if self.state == "open" or self.permanent():
            return "down"
        if self.consecutive_failures:
            return "flaky"
        return "healthy"

    def reset(self, op: str = "op") -> None:
        """Re-arm the breaker after the caller changed the world (an
        elastic shrink): the new, smaller gang deserves a fresh failure
        budget. Journaled."""
        self._emit("supervisor_reset", op=op,
                   after_failures=self.consecutive_failures)
        self.consecutive_failures = 0
        self.identical_failures = 0
        self.last_failure = None
        self._set_state("closed")

    # ------------------------------------------------------------- probe

    def probe(self) -> bool:
        """Run the health probe (injected or the default
        :func:`device_probe` of ``device``); an exception counts as
        unhealthy."""
        detail: dict = {}
        if self._probe is not None:
            fn = self._probe
        else:
            def fn():
                return device_probe(self.probe_timeout, self.device, detail)
        with obs.span("resilience/probe") as sp:
            try:
                healthy = bool(fn())
            except Exception:
                healthy = False
            sp.set(healthy=healthy)
        self.context_lost = bool(detail.get("context_lost"))
        fields = {"healthy": healthy}
        if self.context_lost:
            fields["context_lost"] = True
        self._emit("probe", **fields)
        return healthy

    # ----------------------------------------------------------- breaker

    def _check_circuit(self, op: str) -> None:
        if self.state != "open":
            return
        if self.probe():
            self._set_state("half_open")
            self._emit("circuit_half_open", op=op)
            return
        self._emit("circuit_rejected", op=op)
        raise CircuitOpen(
            f"{op}: circuit open after {self.consecutive_failures} "
            "consecutive failed operations and an unhealthy probe"
        )

    def _note_op_failure(self, op: str) -> None:
        self.consecutive_failures += 1
        if (self.state != "open"
                and self.consecutive_failures >= self.breaker_threshold):
            self._set_state("open")
            self._emit("circuit_open", op=op,
                       consecutive_failures=self.consecutive_failures,
                       permanent=self.permanent())

    def note_success(self, op: str = "op") -> None:
        """Close the circuit and zero the consecutive-failure count
        (called automatically by :meth:`run`; loop owners call it after
        real post-recovery progress)."""
        if self.consecutive_failures or self.state != "closed":
            self._emit("recovered", op=op,
                       after_failures=self.consecutive_failures)
        self.consecutive_failures = 0
        self.identical_failures = 0
        self.last_failure = None
        self._set_state("closed")

    # --------------------------------------------------------- run/recover

    def run(self, fn, op: str = "op", retryable=is_device_loss):
        """Run ``fn()`` with up to ``policy.max_attempts`` tries.

        Only exceptions passing ``retryable`` (default:
        :func:`is_device_loss`) are retried; everything else propagates
        at once, because retrying a program bug just re-crashes until
        the deadline. Exhaustion raises :class:`RetriesExhausted` and
        counts one operation failure toward the breaker.
        """
        self._check_circuit(op)
        last: BaseException | None = None
        for attempt in range(1, self.policy.max_attempts + 1):
            self._emit("attempt", op=op, attempt=attempt)
            try:
                result = fn()
            except Exception as e:  # noqa: BLE001 — classified below
                if not retryable(e):
                    self._emit("failure", op=op, attempt=attempt,
                               error=self._describe(e), retryable=False)
                    raise
                last = e
                # Drop the traceback now: its frames pin the failed
                # attempt's locals (tables on the card) through the
                # probe, the backoff and the next attempt.
                last.__traceback__ = None
                self._note_failure_identity(e)
                self._emit("failure", op=op, attempt=attempt,
                           error=self._describe(e), retryable=True)
                if attempt == self.policy.max_attempts:
                    break
                if self.permanent():
                    # N identical consecutive failures: dead, not
                    # flapping — exhaust now; the elastic controller
                    # decides whether to shrink.
                    self._emit("permanent_fault", op=op,
                               identical_failures=self.identical_failures,
                               skipped_attempts=(self.policy.max_attempts
                                                 - attempt))
                    break
                healthy = self.probe()
                if not healthy and self.context_lost:
                    break        # retrying into a dead context is futile
                delay = self.policy.delay(attempt, self._rng)
                self._emit("backoff", op=op, attempt=attempt,
                           delay_s=round(delay, 3), healthy=healthy)
                with obs.span("resilience/backoff", op=op,
                              delay_s=round(delay, 3)):
                    self._sleep(delay)
            else:
                self.note_success(op)
                return result
        self._note_op_failure(op)
        raise RetriesExhausted(
            f"{op}: {self.policy.max_attempts} attempts failed "
            f"(last: {self._describe(last)})"
        ) from last

    def recover(self, op: str, exc: BaseException) -> None:
        """Account one caught device-loss failure for a caller that owns
        its retry loop (``FMTrainer.fit``): journal it, trip the breaker
        at the threshold (raises :class:`CircuitOpen`), else probe and
        back off before the caller restores its checkpoint. A probe that
        finds this process's CUDA context lost opens the breaker at once
        (the module docstring's divergence)."""
        self.consecutive_failures += 1
        self._note_failure_identity(exc)
        self._emit("failure", op=op, error=self._describe(exc),
                   retryable=True,
                   consecutive_failures=self.consecutive_failures)
        if self.consecutive_failures >= self.breaker_threshold:
            self._set_state("open")
            self._emit("circuit_open", op=op,
                       consecutive_failures=self.consecutive_failures,
                       permanent=self.permanent())
            raise CircuitOpen(
                f"{op}: {self.consecutive_failures} consecutive device "
                "losses — escalating instead of thrashing the checkpoint"
            ) from exc
        # The probe and backoff each carry their own span: this is the
        # wall clock the trainer excludes from its throughput window.
        healthy = self.probe()
        if not healthy and self.context_lost:
            self._set_state("open")
            self._emit("circuit_open", op=op,
                       consecutive_failures=self.consecutive_failures,
                       permanent=self.permanent(), context_lost=True)
            raise CircuitOpen(
                f"{op}: the probe found this process's CUDA context lost "
                "(a sticky error); no retry in this process can use the "
                "card — restart it to resume from the checkpoint chain"
            ) from exc
        delay = self.policy.delay(self.consecutive_failures, self._rng)
        self._emit("backoff", op=op, delay_s=round(delay, 3),
                   healthy=healthy)
        with obs.span("resilience/backoff", op=op,
                      delay_s=round(delay, 3)):
            self._sleep(delay)
