"""Divergence guard: NaN/Inf and loss-spike detection with rollback (the
port's copy of ``fm_spark_tpu/resilience/divergence.py``).

A numeric blowup is the third run-killer this subsystem covers (after
transient flaps and permanent device loss): one bad batch or an
optimizer excursion turns the loss to NaN, the NaN writes into the
tables on the very next step, and every checkpoint from then on
snapshots poisoned state — by the time a human reads the metrics, the
run is unsalvageable. The guard makes that cost ONE CHECKPOINT WINDOW:

- :meth:`DivergenceGuard.check` watches every fetched training loss.
  Non-finite is divergence, full stop. A finite loss is a SPIKE when it
  exceeds ``spike_factor`` × the median of the trailing window (the
  median is robust to the window itself containing the start of the
  blowup; no trigger until ``min_history`` losses are banked, so warmup
  noise cannot fire it).
- On detection it raises :class:`DivergenceDetected`;
  ``FMTrainer.fit`` catches it BEFORE the step's state can reach a
  checkpoint, restores ``last_good`` (the crash-consistent chain,
  checkpoint.py) in place, and resumes with a REDUCED STEP BUDGET — the run now
  targets the last step before the spike. Deterministic pipelines
  replay the same batches, so retrying through the same poison batch
  would diverge identically forever; stopping just short converts a
  blowup into a complete, slightly-shorter run with verified-good
  final state (the loss at the restored step is bit-identical to the
  pre-spike value, by the same replay contract as kill-and-resume).
- ``max_rollbacks`` bounds the policy: a loss landscape that keeps
  spiking at new places is a modeling problem, not a robustness one,
  and propagates after the budget is spent.

Maximize mode: the same trailing-median machinery watches a
HIGHER-IS-BETTER metric — the online protocol's day-over-day eval AUC —
with ``mode="max"``: detection fires when a finite value DROPS below
``trailing median / spike_factor`` (the mirror of the loss-spike test;
``spike_factor`` is sized near 1 for AUC, e.g. 1.1 ≈ a 9% relative
drop). The ``min_history`` floor applies in both directions, so a short
eval series — the first days of an online run — can never trip the
spike/drop test; only non-finite values are unconditional. This is the
concept-drift sentry: the trainer did not blow up, the WORLD changed
under it, and the verdict routes into the same rollback budget.

Every decision is journaled through
:class:`~fm_spark_tpu_torch.utils.logging.EventLog` (``divergence_detected``
/ ``divergence_rollback``).
"""

from __future__ import annotations

import math
from collections import deque

__all__ = ["DivergenceDetected", "DivergenceGuard"]


class DivergenceDetected(RuntimeError):
    """Raised by :meth:`DivergenceGuard.check` at the first diverged
    loss; carries the step and value so the rollback can journal them
    and truncate the resumed budget to ``step - 1``."""

    def __init__(self, step: int, loss: float, reason: str):
        super().__init__(
            f"divergence at step {step}: loss={loss!r} ({reason})"
        )
        self.step = int(step)
        self.loss = float(loss)
        self.reason = reason


class DivergenceGuard:
    """Opt-in training-loop monitor (see module docstring).

    ``spike_factor``: a finite loss > factor × trailing-median is a
    spike (``mode="min"``, the default); with ``mode="max"`` (a
    higher-is-better metric, e.g. eval AUC) a finite value < trailing
    median ÷ factor is a DROP — the concept-drift direction.
    ``window``/``min_history``: trailing-median shape; no verdict of
    either direction before ``min_history`` values are banked. On
    detection :meth:`check` raises; the trainer calls
    :meth:`note_rollback` once per recovery — it returns the truncated
    step target and raises the original detection when the rollback
    budget is spent.
    """

    def __init__(self, spike_factor: float = 10.0, window: int = 16,
                 min_history: int = 3, max_rollbacks: int = 2,
                 journal=None, mode: str = "min"):
        if spike_factor <= 1.0:
            raise ValueError(
                f"spike_factor must be > 1, got {spike_factor}"
            )
        if mode not in ("min", "max"):
            raise ValueError(
                f"mode must be 'min' (lower-is-better, loss) or 'max' "
                f"(higher-is-better, AUC), got {mode!r}"
            )
        self.spike_factor = float(spike_factor)
        self.mode = mode
        self.min_history = max(int(min_history), 1)
        self.max_rollbacks = int(max_rollbacks)
        self.journal = journal
        self.rollbacks = 0
        self._recent: deque[float] = deque(maxlen=max(int(window), 2))

    def _emit(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.emit(event, **fields)

    def _baseline(self) -> float | None:
        if len(self._recent) < self.min_history:
            return None
        ordered = sorted(self._recent)
        return ordered[len(ordered) // 2]

    def baseline(self) -> float | None:
        """The current trailing median (None until ``min_history``
        values are banked) — exposed for the drift-score gauge the
        online loop publishes alongside each verdict."""
        return self._baseline()

    def history(self) -> list[float]:
        """The banked trailing window, oldest first — the durable half
        of the sentry's state: the online loop persists it in each
        checkpoint's ``extra`` so a killed-and-resumed run re-seeds
        the window and its drift verdicts replay exactly."""
        return list(self._recent)

    def seed_history(self, values) -> None:
        """Re-seed the trailing window from a checkpoint (see
        :meth:`history`); replaces whatever was banked."""
        self._recent.clear()
        for v in values:
            self._recent.append(float(v))

    def check(self, step: int, loss: float) -> None:
        """Bank a healthy loss, or raise :class:`DivergenceDetected`.

        Call with every fetched loss BEFORE it can be logged or reach a
        checkpoint snapshot — the poisoned step's state must never be
        savable.
        """
        loss = float(loss)
        reason = None
        if not math.isfinite(loss):
            reason = ("non-finite loss" if self.mode == "min"
                      else "non-finite metric")
        else:
            baseline = self._baseline()
            if baseline is not None and self.mode == "min" and (
                    loss > self.spike_factor * max(baseline, 1e-12)):
                reason = (f"loss spike: {loss:.6g} > {self.spike_factor}x "
                          f"trailing median {baseline:.6g}")
            elif (baseline is not None and self.mode == "max"
                    and baseline > 0
                    and loss < baseline / self.spike_factor):
                # The drift direction: the metric is higher-is-better
                # and fell past the mirrored factor of its own trailing
                # median — the world moved, not the optimizer.
                reason = (f"metric drop: {loss:.6g} < trailing median "
                          f"{baseline:.6g} / {self.spike_factor}")
        if reason is not None:
            self._emit("divergence_detected", step=step, loss=repr(loss),
                       reason=reason, rollbacks=self.rollbacks,
                       mode=self.mode)
            raise DivergenceDetected(step, loss, reason)
        self._recent.append(loss)

    def note_rollback(self, detected: DivergenceDetected,
                      restored_step: int) -> int:
        """Account one rollback; returns the reduced step target (stop
        just before the diverging step). Re-raises the detection when
        ``max_rollbacks`` is exhausted. Clears the trailing window — the
        replayed losses re-bank from the restored point."""
        if self.rollbacks >= self.max_rollbacks:
            self._emit("divergence_rollback_exhausted",
                       step=detected.step, rollbacks=self.rollbacks)
            raise detected
        self.rollbacks += 1
        self._recent.clear()
        target = max(detected.step - 1, int(restored_step))
        self._emit("divergence_rollback", step=detected.step,
                   restored_step=int(restored_step),
                   reduced_target=target, rollbacks=self.rollbacks)
        return target
