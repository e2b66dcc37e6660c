"""Elastic degraded mode: permanent-fault classification and shrink (the
port's copy of ``fm_spark_tpu/resilience/elastic.py``).

The supervisor treats every device loss as transient: probe, back off,
retry, and circuit-break when the attachment keeps dying. That is right
for a flap and wrong for dead capacity. *The same failure, N times in a
row, is not a flap.* This module encodes it:

- :func:`classify_failures`: the pure classifier over failure
  descriptions (numerals normalized, so ``within 126s`` equals
  ``within 125s``): the last N identical give ``"permanent"``, else
  ``"transient"``. Shared by the supervisor (exceptions in a process)
  and the elastic parent of ``fmtorch train --elastic`` (a rank's
  error text), so the two can never disagree on what "identical" means.
- :class:`ElasticController`: the degraded-mode state machine. Given a
  permanent verdict it SHRINKS the device set (halving toward
  ``min_devices``, bounded by ``max_shrinks``) instead of dying, so the
  caller relaunches a smaller gang, restores the last good checkpoint in
  the canonical layout (portable across mesh sizes) and keeps training
  on 8→4→2→1 cards. Every transition is journaled
  (``fault_classified`` / ``mesh_shrink`` / ``elastic_exhausted``), and
  :meth:`summary` feeds the ``degraded``/``chips``/``shrinks`` block a
  result carries, so a degraded rate never passes for a full one.

Which devices survive: the controller shrinks by CAPACITY, keeping a
prefix of the current set. In the port a "device" is a rank of the
elastic parent's gang (one process per card) or a replica slot of the
serving fleet; pass the set at construction, else the visible cards
are enumerated. Nothing here imports torch at module scope: the elastic
parent and the fleet parent classify without touching a card.
"""

from __future__ import annotations

import re

__all__ = [
    "ElasticController",
    "ElasticExhausted",
    "classify_failures",
    "normalize_failure",
]

#: Default "N identical consecutive failures ⇒ permanent" threshold,
#: matched to the supervisor's default breaker_threshold so the breaker
#: opening and the classification flipping happen on the same failure.
PERMANENT_THRESHOLD = 3

_NUMERALS = re.compile(r"(rc=\d+)|(\d+(?:\.\d+)?)")


class ElasticExhausted(RuntimeError):
    """The controller cannot shrink further (``min_devices`` reached or
    ``max_shrinks`` spent): degraded mode is out of capacity to shed,
    so the permanent fault propagates to the caller."""


def normalize_failure(description: str) -> str:
    """Collapse numerals so two descriptions differing only in measured
    values (``within 126s`` vs ``within 125s``, occurrence counters,
    timestamps) compare as the SAME failure mode. Exit codes are the
    one numeral that IS identity — ``rc=1`` (a program bug) and
    ``rc=3`` (the init-watchdog exit) are different failure modes, so
    ``rc=<n>`` survives normalization verbatim."""
    return _NUMERALS.sub(lambda m: m.group(1) or "#", str(description))


def classify_failures(failures, threshold: int = PERMANENT_THRESHOLD
                      ) -> str:
    """``"permanent"`` iff the last ``threshold`` failure descriptions
    are present and identical after :func:`normalize_failure`, else
    ``"transient"``. Pure and dependency-free — callable from a parent
    process before any device work."""
    tail = [normalize_failure(f) for f in list(failures)[-threshold:]]
    if threshold > 0 and len(tail) == threshold and len(set(tail)) == 1:
        return "permanent"
    return "transient"


class ElasticController:
    """Degraded-mode device-capacity state machine.

    Usage (the shape every consumer follows — FMTrainer.fit, the CLI's
    elastic parent, the serving fleet)::

        elastic = ElasticController(journal=journal, max_shrinks=3)
        ...
        cls = elastic.note_failure("train", exc)       # journal + classify
        if cls == "permanent":
            ranks = elastic.shrink("train")            # 8 -> 4 (or raises)
            # relaunch len(ranks) ranks; they resume from the chain
    """

    def __init__(self, devices=None, max_shrinks: int = 3,
                 min_devices: int = 1,
                 identical_threshold: int = PERMANENT_THRESHOLD,
                 journal=None):
        if min_devices < 1:
            raise ValueError(f"min_devices must be >= 1, got {min_devices}")
        self._devices = list(devices) if devices is not None else None
        self.max_shrinks = int(max_shrinks)
        self.min_devices = int(min_devices)
        self.identical_threshold = int(identical_threshold)
        self.journal = journal
        self.shrinks = 0
        self._failures: list[str] = []

    # ------------------------------------------------------------ events

    def _emit(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.emit(event, **fields)

    # ------------------------------------------------------------ devices

    def devices(self) -> list:
        """The current surviving device set (lazily enumerated, as the
        visible cards' indices, on first use when not given at
        construction)."""
        if self._devices is None:
            import torch

            self._devices = list(range(torch.cuda.device_count()))
        return list(self._devices)

    @property
    def n_chips(self) -> int:
        return len(self.devices())

    @property
    def degraded(self) -> bool:
        return self.shrinks > 0

    # ------------------------------------------------------ classification

    def note_failure(self, op: str, exc) -> str:
        """Record one failure (an exception or a description string) and
        return its classification. Transient failures accumulate; the
        ``identical_threshold``-th identical consecutive one flips the
        verdict to ``"permanent"`` (the caller then decides to shrink)."""
        if isinstance(exc, BaseException):
            first = (str(exc).splitlines() or [""])[0]
            desc = f"{type(exc).__name__}: {first[:200]}"
        else:
            desc = str(exc)
        if self._failures and (normalize_failure(desc)
                               != normalize_failure(self._failures[-1])):
            # A DIFFERENT failure mode restarts the identical run: only
            # consecutive repeats of one mode mean "permanently dead".
            self._failures.clear()
        self._failures.append(desc)
        verdict = classify_failures(self._failures,
                                    self.identical_threshold)
        self._emit("fault_classified", op=op, classification=verdict,
                   identical_failures=len(self._failures),
                   error=desc)
        return verdict

    def note_success(self) -> None:
        """Real progress clears the failure run (a later fault starts a
        fresh classification window)."""
        self._failures.clear()

    # ------------------------------------------------------------- shrink

    def can_shrink(self) -> bool:
        return (self.shrinks < self.max_shrinks
                and self.n_chips > self.min_devices)

    def shrink(self, op: str = "train") -> list:
        """Halve the device set (floored at ``min_devices``) and return
        the survivors; raises :class:`ElasticExhausted` when no capacity
        is left to shed. Journals the ``mesh_shrink`` transition."""
        devices = self.devices()
        if not self.can_shrink():
            self._emit("elastic_exhausted", op=op, chips=len(devices),
                       shrinks=self.shrinks,
                       max_shrinks=self.max_shrinks)
            raise ElasticExhausted(
                f"{op}: cannot shrink below {len(devices)} device(s) "
                f"(shrinks={self.shrinks}/{self.max_shrinks}, "
                f"min_devices={self.min_devices})"
            )
        survivors = devices[:max(self.min_devices, len(devices) // 2)]
        self._devices = survivors
        self.shrinks += 1
        self._failures.clear()
        self._emit("mesh_shrink", op=op, from_chips=len(devices),
                   to_chips=len(survivors), shrinks=self.shrinks,
                   max_shrinks=self.max_shrinks)
        return list(survivors)

    # ------------------------------------------------------------ summary

    def summary(self) -> dict:
        """The provenance block degraded artifacts carry: whether the
        run shrank, how often, and the chip count its per-chip metrics
        are normalized to."""
        return {"degraded": self.degraded, "chips": self.n_chips,
                "shrinks": self.shrinks}
