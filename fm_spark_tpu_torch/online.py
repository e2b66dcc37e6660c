"""Continuous-learning loop: time-ordered train/eval with a drift
sentry and coordinated rollback (the port of ``fm_spark_tpu/online.py``).

The failure mode of continuous learning is quiet: the world drifts, the
freshly trained model is worse than yesterday's, and the serving fleet
hot-loads it anyway. This loop closes it:

- **Time-ordered protocol**: train on day ``k``'s records, then evaluate
  on day ``k+1``'s, which the model has NEVER seen (never a random
  split); eval AUC streams through the metrics accumulators
  (:mod:`fm_spark_tpu_torch.utils.metrics`).
- **Provenance**: every day's eval lands in the
  :class:`~fm_spark_tpu_torch.obs.ledger.PerfLedger` as a
  ``quality_eval`` record under its own ``leg`` namespace, judged by the
  regression :class:`~fm_spark_tpu_torch.obs.sentinel.Sentinel` before it
  is appended.
- **Drift sentry**: a :class:`~fm_spark_tpu_torch.resilience.divergence
  .DivergenceGuard` in ``mode="max"`` watches the AUC series, with the
  ``min_history`` floor keeping the first days from tripping it.
- **Coordinated rollback**: a drift verdict DEMOTES the offending day's
  checkpoints (:meth:`~fm_spark_tpu_torch.checkpoint.Checkpointer
  .demote_newer_than`: durable tombstones, ``last_good`` republished at
  the pre-drift save) and restores the pre-drift weights; the step axis
  keeps advancing past the tombstoned frontier, so no step number is
  reused and a serving follower (``serve/reload.py``, which refuses
  tombstoned generations) never hot-loads the bad model.

The loop checkpoints at DAY granularity: one verified save per trained
day (plus the step-0 anchor, so a drift verdict on the very first day
has a rollback target), the online cursor and the sentry's trailing
window in the save's ``extra``.

What the card changes: a rollback and a resume copy the restored params
and optimizer state INTO the trainer's tensors (``checkpoint.copy_into``),
where the reference rebinds them. The trainer's captured step is bound
to those tensors' storage, and the port's ``restore`` returns host
tensors: rebound, every later step would leave the card.
"""

from __future__ import annotations

import time

import numpy as np

from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.resilience import faults, watchdog
from fm_spark_tpu_torch.resilience.divergence import (DivergenceDetected,
                                                      DivergenceGuard)

__all__ = ["QUALITY_LEG_PREFIX", "drift_guard", "flip_labels", "run_online",
           "split_days"]

#: quality_eval ledger-leg prefix (cohort isolation from bench legs).
QUALITY_LEG_PREFIX = "quality/"


def drift_guard(drop_factor: float = 1.15, window: int = 8,
                min_history: int = 3, max_rollbacks: int = 2,
                journal=None) -> DivergenceGuard:
    """The online loop's concept-drift sentry: a maximize-mode
    :class:`DivergenceGuard` sized for AUC (a ``drop_factor`` of 1.15
    fires on a ~13% relative drop — outside early-training
    day-over-day improvement noise, far inside a label-flip drift; the
    ``min_history`` floor of 3 keeps the first, still-climbing days
    from tripping it)."""
    return DivergenceGuard(spike_factor=drop_factor, window=window,
                           min_history=min_history,
                           max_rollbacks=max_rollbacks,
                           journal=journal, mode="max")


def split_days(ids, vals, labels, n_days: int) -> list[tuple]:
    """Split one time-ordered dataset into ``n_days`` contiguous day
    slices (the synthetic stand-in for dated Criteo/Avazu shards).
    Order is preserved — this is a TEMPORAL split, never a shuffle."""
    n = len(labels)
    if n_days < 2:
        raise ValueError("online protocol needs >= 2 days "
                         "(day N trains, day N+1 evaluates)")
    if n < n_days:
        raise ValueError(f"{n} rows cannot fill {n_days} days")
    edges = np.linspace(0, n, n_days + 1).astype(int)
    return [(ids[a:b], vals[a:b], labels[a:b])
            for a, b in zip(edges[:-1], edges[1:])]


def flip_labels(days: list[tuple], from_day: int) -> list[tuple]:
    """The planted-drift drill lever, in ONE place (``fmtorch train
    --drift-inject`` and the tests inject drift through this): flip every
    label of day ``from_day`` onward — the sharpest possible concept
    drift, far outside any sane sentry threshold."""
    return [(i, v, (1.0 - l).astype(np.float32)
             if k >= int(from_day) else l)
            for k, (i, v, l) in enumerate(days)]


def _day_steps(day, batch_size: int) -> int:
    return max(1, len(day[2]) // int(batch_size))


def run_online(trainer, days, checkpointer, *, sentry=None,
               journal=None, ledger=None, leg=None, fingerprint=None,
               run_id=None, batch_tap=None) -> dict:
    """Run the continuous-learning protocol over time-ordered days.

    ``trainer`` is a constructed :class:`~fm_spark_tpu_torch.train.FMTrainer`
    (any optimizer — the per-coordinate FTRL/AdaGrad families are the
    intended ones); ``days`` a list of ``(ids, vals, labels)`` arrays
    in time order; ``checkpointer`` the crash-consistent chain the
    serving follower watches. ``sentry`` defaults to
    :func:`drift_guard`. ``ledger``/``leg``/``fingerprint``/``run_id``
    enable ``quality_eval`` provenance records (all four required
    together — the ledger refuses unattributable rows by design).
    ``batch_tap`` (drills) wraps each day's batch source.

    Returns a summary dict: per-day records (step, auc, sentinel
    verdict, rollback marker), total rollbacks, demoted steps, and the
    final ``last_good``. Raises :class:`DivergenceDetected` when the
    sentry's rollback budget is exhausted — persistent drift is a
    modeling/data problem the operator must see, not absorb.
    """
    from fm_spark_tpu_torch.checkpoint import copy_into
    from fm_spark_tpu_torch.data import Batches, iterate_once
    from fm_spark_tpu_torch.train import evaluate_params

    if len(days) < 2:
        raise ValueError("online protocol needs >= 2 time-ordered "
                         "days (day N trains, day N+1 evaluates)")
    if ledger is not None and not (leg and fingerprint and run_id):
        raise ValueError(
            "quality_eval provenance needs leg, fingerprint and run_id "
            "alongside the ledger (unattributable records are refused)")
    sentry = sentry or drift_guard(journal=journal)
    if sentry.mode != "max":
        raise ValueError(
            "the online drift sentry watches AUC (higher-is-better); "
            "pass a DivergenceGuard with mode='max'")
    sentinel = None
    if ledger is not None:
        from fm_spark_tpu_torch.obs.sentinel import Sentinel

        sentinel = Sentinel(ledger)

    def emit(event, **fields):
        obs.event(event, **fields)
        if journal is not None:
            journal.emit(event, **fields)

    cfg = trainer.config
    batch_size = int(cfg.batch_size)
    day_records: list[dict] = []
    demoted_all: list[int] = []
    state = {"rollbacks": 0, "records": 0}

    def day_save(day_idx: int, evals_done: int) -> None:
        """One verified day-boundary save; ``extra`` carries the
        online cursor AND the sentry's trailing window — the durable
        state a killed run resumes the protocol from."""
        checkpointer.save(trainer.step_count, trainer.params, None,
                          {"online_day": day_idx,
                           "online_records": state["records"],
                           "online_evals_done": evals_done,
                           "online_auc_history": sentry.history()},
                          force=True, opt_state=trainer.opt_state)
        checkpointer.wait()

    def eval_and_judge(k_eval: int, pre_day_step: int) -> dict:
        """Evaluate day ``k_eval`` with the current model (streamed
        AUC), record provenance, run the drift sentry, and perform the
        coordinated rollback on a verdict. Returns the day entry."""
        nxt = days[k_eval]
        with watchdog.phase("online_eval"):
            faults.inject("online_eval")
            with obs.span("online/eval_day", day=k_eval):
                metrics = evaluate_params(
                    trainer.spec, trainer.params,
                    iterate_once(*nxt, min(batch_size, len(nxt[2]))),
                    step=trainer._eval_step)
        auc = float(metrics["auc"])
        base = sentry.baseline()
        drift_score = ((base - auc) / base
                       if base is not None and base > 0 else 0.0)
        obs.gauge("online/auc").set(auc)
        obs.gauge("online/drift_score").set(round(drift_score, 6))
        obs.counter("online.days_total").add(1)
        verdict = None
        if ledger is not None:
            record = {
                "kind": "quality_eval", "leg": leg, "run_id": run_id,
                "fingerprint": fingerprint, "value": auc,
                "day": k_eval, "step": trainer.step_count,
                "metrics": {m: round(float(x), 6)
                            for m, x in metrics.items()},
            }
            verdict = sentinel.observe(record).get("verdict")
        entry = {"day": k_eval - 1, "eval_day": k_eval,
                 "step": trainer.step_count, "auc": round(auc, 6),
                 "logloss": round(float(metrics["logloss"]), 6),
                 "drift_score": round(drift_score, 6),
                 "sentinel": verdict, "rolled_back": False}
        emit("quality_eval", **{f: entry[f] for f in
                                ("day", "eval_day", "step", "auc",
                                 "drift_score", "sentinel")})
        try:
            sentry.check(trainer.step_count, auc)
        except DivergenceDetected as e:
            # ---- coordinated rollback: demote the drifted day's
            # saves (durable tombstones, last_good republished at the
            # pre-drift save — crash-consistent at every kill point),
            # restore the pre-drift weights, and keep the step axis
            # moving past the tombstoned frontier (a demoted step
            # number is never reused: serving generation monotonicity
            # depends on it). note_rollback accounts the budget and
            # re-raises when it is spent.
            demoted = checkpointer.demote_newer_than(
                pre_day_step,
                reason=f"drift verdict at eval day {k_eval}: {e.reason}")
            restored = checkpointer.restore(trainer.params)
            if restored is None:
                raise
            sentry.note_rollback(e, restored["step"])
            state["rollbacks"] += 1
            demoted_all.extend(demoted)
            copy_into(trainer.params, restored["params"])
            copy_into(trainer.opt_state, restored["opt_state"])
            trainer.step_count = max(
                trainer.step_count,
                checkpointer.tombstone_frontier()) + 1
            obs.counter("online.rollbacks_total").add(1)
            # Republish the restored state as a NEW generation just
            # past the frontier: the chain's tip is good again (the
            # serving follower converges forward, never back), and a
            # kill landing after the rollback resumes at the next
            # day with the pre-drift weights — the same place the
            # uninterrupted run continues from.
            day_save(k_eval - 1, evals_done=k_eval)
            entry["rolled_back"] = True
            entry["demoted_steps"] = demoted
            emit("online_rollback", day=k_eval - 1, demoted=demoted,
                 restored_step=int(restored["step"]),
                 republished_step=trainer.step_count,
                 rollbacks=state["rollbacks"])
        return entry

    # ---- resume: day cursor + step axis past the tombstoned frontier
    start_day = 0
    restored = checkpointer.restore(trainer.params)
    if restored is not None:
        copy_into(trainer.params, restored["params"])
        copy_into(trainer.opt_state, restored["opt_state"])
        extra = restored.get("extra") or {}
        start_day = int(extra.get("online_day", -1)) + 1
        state["records"] = int(extra.get("online_records", 0))
        evals_done = int(extra.get("online_evals_done",
                                   max(start_day - 1, 0)))
        sentry.seed_history(extra.get("online_auc_history") or [])
        # Time never rewinds past a demoted save: resuming after a
        # kill that landed mid-rollback must keep the step axis ahead
        # of the tombstoned frontier, or the next day's save would
        # collide with a vetoed step number.
        trainer.step_count = max(int(restored["step"]),
                                 checkpointer.tombstone_frontier())
        emit("online_resume", start_day=start_day,
             step=trainer.step_count, evals_done=evals_done)
        if 1 <= start_day <= len(days) - 1 and evals_done < start_day:
            # The restored save's eval never completed (or its banked
            # verdict died with the process): replay it BEFORE
            # training, so a kill between save and eval can never
            # skip a drift check — the sentry series is bit-identical
            # to the uninterrupted run's.
            pre = trainer.step_count - _day_steps(days[start_day - 1],
                                                  batch_size)
            day_records.append(eval_and_judge(start_day, max(pre, 0)))
    else:
        # Step-0 anchor: the rollback target for a drift verdict on
        # the very first trained day.
        checkpointer.save(0, trainer.params, None,
                          {"online_day": -1, "online_records": 0,
                           "online_evals_done": 0,
                           "online_auc_history": []},
                          force=True, opt_state=trainer.opt_state)
        checkpointer.wait()
    emit("online_start", start_day=start_day,
         step=trainer.step_count, days=len(days), run_id=run_id)

    for k in range(start_day, len(days) - 1):
        day = days[k]
        pre_day_step = trainer.step_count
        steps = _day_steps(day, batch_size)
        source = Batches(*day, min(batch_size, len(day[2])),
                         seed=cfg.seed + k)
        if batch_tap is not None:
            source = batch_tap(k, source)
        with obs.span("online/train_day", day=k, steps=steps):
            trainer.fit(source, num_steps=steps)
        state["records"] += len(day[2])
        day_save(k, evals_done=k)
        day_records.append(eval_and_judge(k + 1, pre_day_step))

    summary = {
        "days_trained": len(day_records),
        "rollbacks": state["rollbacks"],
        "demoted_steps": demoted_all,
        "final_step": trainer.step_count,
        "last_good": checkpointer.last_good_step(),
        "records_seen": state["records"],
        "days": day_records,
        "ts": round(time.time(), 3),
    }
    emit("online_end", days_trained=summary["days_trained"],
         rollbacks=state["rollbacks"],
         last_good=summary["last_good"])
    return summary
