"""Bidirectional fleet autoscaler (the port's copy of
``fm_spark_tpu/serve/autoscale.py``).

The elastic controller only ever shrinks: it retires crash-looping
slots, but nothing ADDS capacity when the front door starts shedding,
and nothing reclaims an idle replica. This module closes the loop with
a pure decision policy the :class:`~fm_spark_tpu_torch.serve.fleet.Fleet`
ticks on its health-poll cadence.

Signals (all monotone counters; the policy differences them per tick):

- **shed fraction** — ``frontdoor.shed_total`` vs ``accepted_total``
  from the parent's registry: the demand the fleet turned away.
  Shedding is the GROW signal.
- **coalescer fill** — ``serve.rows_total`` vs ``padded_rows_total``
  summed over the replicas' metric scrapes: how much of each padded
  batch was real work. Mostly-padding batches are the SHRINK signal.

Policy shape (all knobs are constructor args):

- **hysteresis bands**: grow above ``grow_shed_frac``, shrink only
  below ``shrink_fill`` AND with zero shed this tick — the dead band
  between them holds, so the policy cannot oscillate on a boundary.
- **sustain**: pressure must persist ``sustain_ticks`` consecutive
  ticks before a decision.
- **cooldown**: after any decision, ``cooldown_ticks`` of mandatory
  hold — a grown replica needs time to warm up before its effect is
  measurable.
- **bounds**: never above ``max_replicas`` live or below
  ``min_replicas`` ready.

Every decision is journaled as an ``autoscale_decision`` event in
``fleet_health.jsonl`` (action, reason, the deltas that justified it).
The policy extends — never replaces — the elastic controller:
crash-loop retirement still wins (a ``retired`` slot is permanently
gone; a ``parked`` one is not).
"""

from __future__ import annotations

__all__ = ["Autoscaler"]


class Autoscaler:
    """Pure decision policy: feed it counter snapshots, get back
    ``"grow"``, ``"shrink"``, or ``None``. Deterministic — unit tests
    drive it with hand-written counter sequences; the fleet drives it
    with live registries. Not thread-safe; the fleet ticks it from the
    single health thread."""

    def __init__(self, *, min_replicas: int = 1, max_replicas: int = 4,
                 grow_shed_frac: float = 0.05,
                 shrink_fill: float = 0.25,
                 sustain_ticks: int = 3, cooldown_ticks: int = 12,
                 journal=None):
        if min_replicas < 1:
            raise ValueError(f"min_replicas >= 1, got {min_replicas}")
        if max_replicas < min_replicas:
            raise ValueError(
                f"max_replicas {max_replicas} < min_replicas "
                f"{min_replicas}")
        if not 0.0 <= grow_shed_frac <= 1.0:
            raise ValueError(f"grow_shed_frac in [0,1], "
                             f"got {grow_shed_frac}")
        if not 0.0 <= shrink_fill <= 1.0:
            raise ValueError(f"shrink_fill in [0,1], got {shrink_fill}")
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.grow_shed_frac = float(grow_shed_frac)
        self.shrink_fill = float(shrink_fill)
        self.sustain_ticks = int(sustain_ticks)
        self.cooldown_ticks = int(cooldown_ticks)
        self.journal = journal
        self._last = None          # previous counter snapshot
        self._grow_streak = 0
        self._shrink_streak = 0
        self._cooldown = 0
        #: Applied decisions, in order: ("grow"|"shrink", tick_no).
        self.decisions: list = []
        self._tick_no = 0

    # ------------------------------------------------------------ tick

    def tick(self, *, shed_total: int, accepted_total: int,
             rows_total: int, padded_rows_total: int,
             n_ready: int, n_live: int) -> "str | None":
        """One observation on the health-poll cadence. All ``*_total``
        args are monotone counters; the policy acts on their deltas
        since the previous tick (the first tick only baselines)."""
        self._tick_no += 1
        now = (int(shed_total), int(accepted_total),
               int(rows_total), int(padded_rows_total))
        prev, self._last = self._last, now
        if prev is None:
            return None
        d_shed = max(0, now[0] - prev[0])
        d_accepted = max(0, now[1] - prev[1])
        d_rows = max(0, now[2] - prev[2])
        d_padded = max(0, now[3] - prev[3])
        demand = d_shed + d_accepted
        shed_frac = d_shed / demand if demand else 0.0
        batched = d_rows + d_padded
        fill = d_rows / batched if batched else 0.0

        if self._cooldown > 0:
            self._cooldown -= 1
            # Pressure streaks do not accrue during cooldown: the
            # fleet's response to the LAST decision is still settling,
            # so this tick's signal is not evidence about the new size.
            self._grow_streak = self._shrink_streak = 0
            return None

        if shed_frac > self.grow_shed_frac:
            self._grow_streak += 1
            self._shrink_streak = 0
        elif (d_shed == 0 and batched > 0
                and fill < self.shrink_fill):
            self._shrink_streak += 1
            self._grow_streak = 0
        else:
            # Dead band between the hysteresis edges: hold.
            self._grow_streak = self._shrink_streak = 0
            return None

        action = None
        reason = None
        if (self._grow_streak >= self.sustain_ticks
                and n_live < self.max_replicas):
            action = "grow"
            reason = (f"shed_frac={shed_frac:.3f}>"
                      f"{self.grow_shed_frac} for "
                      f"{self._grow_streak} ticks")
        elif (self._shrink_streak >= self.sustain_ticks
                and n_ready > self.min_replicas):
            action = "shrink"
            reason = (f"fill={fill:.3f}<{self.shrink_fill} "
                      f"with zero shed for "
                      f"{self._shrink_streak} ticks")
        if action is None:
            return None

        self._grow_streak = self._shrink_streak = 0
        self._cooldown = self.cooldown_ticks
        self.decisions.append((action, self._tick_no))
        if self.journal is not None:
            self.journal.emit(
                "autoscale_decision", action=action, reason=reason,
                tick=self._tick_no, n_ready=n_ready, n_live=n_live,
                to_n=n_live + (1 if action == "grow" else -1),
                d_shed=d_shed, d_accepted=d_accepted,
                d_rows=d_rows, d_padded=d_padded,
                shed_frac=round(shed_frac, 4),
                fill=round(fill, 4))
        return action

    # --------------------------------------------------------- summary

    def summary(self) -> dict:
        grows = sum(1 for a, _ in self.decisions if a == "grow")
        shrinks = sum(1 for a, _ in self.decisions if a == "shrink")
        flips = sum(1 for (a, _), (b, _t) in
                    zip(self.decisions, self.decisions[1:])
                    if a != b)
        return {"ticks": self._tick_no, "grows": grows,
                "shrinks": shrinks, "direction_changes": flips,
                "decisions": [list(d) for d in self.decisions]}
