"""Noise-aware regression sentinel over perf-ledger cohorts (the port's
copy of ``fm_spark_tpu/obs/sentinel.py``).

Given a new measurement and its (leg, fingerprint) cohort history from
the :mod:`~fm_spark_tpu_torch.obs.ledger`, the sentinel emits ONE
structured verdict:

======================  ==================================================
``improved``            value above the trailing band by ≥ z_threshold
``flat``                value inside the band (noise, not signal)
``regressed``           value below the band with a HEALTHY attachment
``attachment_transient``a null measurement, or a below-band value
                        measured under adverse attachment weather
                        (``attachment_health`` flaky/degraded/down)
``insufficient_history``fewer than ``min_history`` comparable values —
                        no statistical claim is possible yet
======================  ==================================================

The band is a robust trailing statistic: the median of the last
``window`` valid cohort values, with the noise scale
``max(MAD_diff·1.4826/√2, rel_floor·median)`` where ``MAD_diff`` is the
median absolute deviation of SUCCESSIVE DIFFERENCES — trend-robust: a
slow drift inflates the plain window MAD fast enough to hide itself,
while its successive differences stay at the step-to-step jitter. The
relative floor keeps a cohort that repeats to 4 digits from flagging
every 0.5% wiggle as signal.

Cohort selection (:meth:`Sentinel.judge`): the EXACT fingerprint cohort
when it has enough history, else widened across lever configs but NEVER
across hardware (the same ``device_kind`` and ``n_chips``, and the same
chaos-ness), with the widening recorded in the verdict.

The keep-best gate (:func:`keepbest_allowed`): only ``improved`` / ``flat``
verdicts may promote a measurement; ``insufficient_history`` defers to a
strictly-greater rule; ``regressed`` and ``attachment_transient`` never
promote. The online loop stamps each ``quality_eval`` record's verdict
through :meth:`Sentinel.observe`.

Side-effect-free apart from the ledger append; imports nothing.
"""

from __future__ import annotations

import dataclasses

__all__ = [
    "ALL_VERDICTS",
    "Sentinel",
    "SentinelPolicy",
    "classify",
    "keepbest_allowed",
]

ALL_VERDICTS = ("improved", "flat", "regressed", "attachment_transient",
                "insufficient_history")

#: Attachment-health verdicts that turn a below-band value into
#: ``attachment_transient`` instead of ``regressed``.
_ADVERSE_WEATHER = frozenset({"flaky", "degraded", "down"})


@dataclasses.dataclass(frozen=True)
class SentinelPolicy:
    """Classification knobs (defaults sized from the real r01–r05 +
    round-5 cap-ladder spread: leg-to-leg MAD on a healthy attachment
    was ~5%, the genuine round-5 improvement ~+40% over the r02 band,
    and the throttled-window transients −40%+ under flaky health)."""

    min_history: int = 3      #: valid values needed for any claim
    window: int = 8           #: trailing values the band is built on
    z_threshold: float = 3.0  #: |z| needed to call signal over noise
    rel_floor: float = 0.02   #: noise floor as a fraction of the median
    #: diff-MAD → sigma: 1.4826 (MAD under normality) / sqrt(2) (a
    #: difference of two iid values has twice the variance).
    mad_scale: float = 1.4826 / 1.4142135623730951


def _median(vals: list[float]) -> float:
    ordered = sorted(vals)
    n = len(ordered)
    mid = ordered[n // 2]
    if n % 2 == 0:
        mid = 0.5 * (mid + ordered[n // 2 - 1])
    return mid


def classify(history: list[float | None], value: float | None,
             attachment_health: str = "healthy",
             policy: SentinelPolicy | None = None) -> dict:
    """Classify one measurement against its cohort history.

    ``history`` is the cohort's prior values in measurement order
    (``None`` entries — recorded nulls — carry no statistical weight
    but are accepted so callers can feed raw ledger values).
    Returns the verdict block stamped into each record:
    ``{"verdict", "reason", "n_history", "median", "mad", "z"}``.
    """
    policy = policy or SentinelPolicy()
    valid = [float(v) for v in history if isinstance(v, (int, float))]
    n = len(valid)
    block = {"verdict": None, "reason": None, "n_history": n,
             "median": None, "mad": None, "z": None}

    if value is None:
        # A recorded null is a first-class event, not a gap: under
        # adverse weather it is the attachment's fault; with no adverse
        # evidence there is simply nothing to judge.
        if attachment_health in _ADVERSE_WEATHER:
            block.update(verdict="attachment_transient",
                         reason=f"no measurement; attachment "
                                f"{attachment_health}")
        else:
            block.update(verdict="insufficient_history",
                         reason="no measurement recorded")
        return block

    if n < policy.min_history:
        block.update(verdict="insufficient_history",
                     reason=f"{n} comparable value(s) < min_history "
                            f"{policy.min_history}")
        return block

    recent = valid[-policy.window:]
    med = _median(recent)
    # Trend-robust noise: MAD of successive differences (see module
    # docstring). With min_history >= 3 there are always >= 2 diffs;
    # the single-value-window edge degenerates to the relative floor.
    diffs = [b - a for a, b in zip(recent, recent[1:])]
    dmed = _median(diffs) if diffs else 0.0
    mad = _median([abs(d - dmed) for d in diffs]) if diffs else 0.0
    noise = max(mad * policy.mad_scale,
                policy.rel_floor * abs(med), 1e-12)
    z = (float(value) - med) / noise
    block.update(median=round(med, 3), mad=round(mad, 3),
                 z=round(z, 3))
    if z >= policy.z_threshold:
        block.update(verdict="improved",
                     reason=f"z={z:+.2f} above the trailing band "
                            f"(median {med:,.1f}, noise {noise:,.1f})")
    elif z <= -policy.z_threshold:
        if attachment_health in _ADVERSE_WEATHER:
            block.update(verdict="attachment_transient",
                         reason=f"z={z:+.2f} below the band but the "
                                f"attachment was {attachment_health} — "
                                "weather, not code")
        else:
            block.update(verdict="regressed",
                         reason=f"z={z:+.2f} below the trailing band "
                                f"(median {med:,.1f}, noise "
                                f"{noise:,.1f}) on a healthy "
                                "attachment")
    else:
        block.update(verdict="flat",
                     reason=f"z={z:+.2f} within ±{policy.z_threshold} "
                            "of the trailing band")
    return block


def keepbest_allowed(verdict_block: dict | None) -> bool:
    """May a measurement with this sentinel verdict touch
    a keep-best record? ``improved``/``flat`` yes; ``regressed``/
    ``attachment_transient`` never; ``insufficient_history`` defers to
    the legacy strictly-greater rule (see module docstring). A missing
    block (a pre-sentinel artifact) is treated as legacy-allowed."""
    if not verdict_block:
        return True
    return verdict_block.get("verdict") in (
        "improved", "flat", "insufficient_history")


class Sentinel:
    """The ledger-bound classifier, per leg."""

    def __init__(self, ledger, policy: SentinelPolicy | None = None):
        self.ledger = ledger
        self.policy = policy or SentinelPolicy()

    def _history(self, leg: str, fp: dict) -> tuple[list, str]:
        """Cohort values in append order: the exact fingerprint cohort
        when it has ``min_history`` valid values, else the leg widened
        across lever configs but pinned to the same hardware
        (``cohort: "leg"`` in the verdict — see module docstring)."""
        # ONE ledger scan per judgment (the file grows forever; the
        # exact and widened cohorts are both filtered from this read).
        rows = self.ledger.records(leg=leg)
        fp_key = fp.get("key")
        exact = [r for r in rows
                 if (r.get("fingerprint") or {}).get("key") == fp_key
                 ] if fp_key else []
        vals = [r.get("value") for r in exact]
        if sum(isinstance(v, (int, float)) for v in vals) \
                >= self.policy.min_history:
            return vals, "exact"
        # Widened = same hardware, same chaos-ness: a
        # fault-drill row must never lend its band to a real cohort
        # (or vice versa) just because the exact history is thin.
        env = (fp.get("device_kind"), fp.get("n_chips"),
               bool(fp.get("chaos")))
        wide = [r for r in rows
                if ((r.get("fingerprint") or {}).get("device_kind"),
                    (r.get("fingerprint") or {}).get("n_chips"),
                    bool((r.get("fingerprint") or {}).get("chaos")))
                == env]
        return [r.get("value") for r in wide], "leg"

    def judge(self, leg: str, value: float | None,
              fingerprint: dict | None = None) -> dict:
        """Verdict for a NEW measurement against the recorded history
        (which must not yet contain it — judge, then
        :meth:`observe`)."""
        fp = fingerprint or {}
        vals, cohort = self._history(leg, fp)
        block = classify(vals, value,
                         attachment_health=fp.get("attachment_health",
                                                  "healthy"),
                         policy=self.policy)
        block["cohort"] = cohort
        return block

    def observe(self, record: dict) -> dict:
        """Judge ``record`` against prior history, stamp the verdict
        block into it as ``sentinel``, append it to the ledger, and
        return the verdict block. The verdict is published to the
        ``/healthz`` endpoint's status, and a ``regressed`` one fires a
        rate-limited deep capture while the anomalous program is still
        resident (both best-effort; no-ops while the engine is unarmed)."""
        block = self.judge(record["leg"], record.get("value"),
                           record.get("fingerprint"))
        record = dict(record)
        record["sentinel"] = block
        self.ledger.append(record)
        try:
            from fm_spark_tpu_torch.obs import export as _export
            from fm_spark_tpu_torch.obs import introspect as _introspect

            _export.note_sentinel_verdict(record.get("leg"), block)
            if block.get("verdict") == "regressed":
                _introspect.fire(
                    "sentinel_regressed", leg=record.get("leg"),
                    variant=record.get("variant"),
                    value=record.get("value"), z=block.get("z"),
                    reason=block.get("reason"))
        except Exception:
            pass
        return block
