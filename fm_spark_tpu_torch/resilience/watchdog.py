"""Per-phase deadline watchdogs: convert a hang into a detected fault
(the port's copy of ``fm_spark_tpu/resilience/watchdog.py``).

A hang is the one failure mode with no exception to classify: without a
deadline it destroys its own evidence by never returning. So each guarded
phase gets a budget, and overrunning it produces a STRUCTURED ending
instead of a stuck process:

- a ``hang_detected`` journal and flight event naming the phase, its
  deadline and the observed elapsed time;
- an atomic flight-recorder dump (:func:`fm_spark_tpu_torch.obs
  .flight_dump`), so the last-N window survives whatever happens next;
- then, per the configured action: ``raise`` — :class:`HangDetected`
  raised at phase exit (for hangs that eventually return; thread-free
  and deterministic), or ``exit`` — a daemon monitor thread hard-exits
  the process with :data:`HANG_EXIT_RC` while the hung thread is still
  stuck (for hangs that never return).

A phase that finishes past :data:`NEAR_MISS_FRACTION` of its deadline is
a near miss: counted (``near_misses``, ``resilience.near_misses_total``),
and it fires the ``watchdog_near_miss`` deep capture
(:func:`fm_spark_tpu_torch.obs.introspect.fire`) while the near-hanging
program is still resident; its journal line and flight dump are
rate-limited (by the capture engine's limiter when one is armed, else
per phase).

Configuration: in-process via :func:`configure`, or by environment for
subprocesses::

    FM_SPARK_WATCHDOG="ingest_chunk=2;ckpt_commit=10;step_window=30"
    FM_SPARK_WATCHDOG_ACTION=exit        # or: raise

Unconfigured, :func:`phase` returns a shared no-op context manager — one
dict miss per guarded call, nothing armed, no thread. Importing this
module starts no thread.
"""

from __future__ import annotations

import os
import threading
import time

from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.obs.introspect import NEAR_MISS_FRACTION

__all__ = [
    "ENV_ACTION",
    "ENV_SPEC",
    "HANG_EXIT_RC",
    "KNOWN_PHASES",
    "NEAR_MISS_FRACTION",
    "HangDetected",
    "WatchdogTable",
    "active",
    "clear",
    "configure",
    "phase",
]

ENV_SPEC = "FM_SPARK_WATCHDOG"
ENV_ACTION = "FM_SPARK_WATCHDOG_ACTION"

#: The rc a hard-exit watchdog dies with — distinct from every rc the
#: fault injector can produce, so a supervising parent can tell "hang
#: detected and bounded" from "crashed for an unexplained reason".
HANG_EXIT_RC = 87

#: Minimum seconds between two near-miss flight dumps of the same phase
#: when NO capture engine is armed (armed, the engine's own rate limiter
#: gates the heavy evidence): a steady-state phase living at 85% of its
#: deadline must not fsync a dump per occurrence.
NEAR_MISS_DUMP_INTERVAL_S = 30.0

#: Guarded production phases (the registry the chaos auditor samples
#: deadlines for): the shard reader's chunk read (data/stream.py), the
#: checkpoint manifest-commit window (checkpoint.py), one training
#: step including its batch fetch (train.py), one serving micro-batch
#: execute — deadline = the SLO — in the predict engine
#: (serve/engine.py), and one day's time-ordered eval pass
#: in the continuous-learning loop (online.py) — a hang
#: there would silently stall the drift sentry while training keeps
#: publishing generations. ``frontdoor_request`` guards one
#: ADMITTED request end-to-end through the serving front door
#: (serve/frontdoor.py): admission → dispatch → response write;
#: deadline = the front door's worst acceptable response time, so a
#: wedged replica or a stuck backend surfaces as a structured hang
#: instead of a silently open socket.
KNOWN_PHASES = ("ingest_chunk", "ckpt_commit", "step_window",
                "serve_request", "online_eval", "frontdoor_request")

_ACTIONS = ("raise", "exit")


class HangDetected(RuntimeError):
    """A guarded phase overran its deadline — the structured verdict a
    hang converts into (the generalization of the supervisor's
    init-probe timeout)."""

    def __init__(self, phase: str, deadline_s: float, elapsed_s: float):
        self.phase = str(phase)
        self.deadline_s = float(deadline_s)
        self.elapsed_s = float(elapsed_s)
        super().__init__(
            f"phase {self.phase!r} overran its {self.deadline_s:g}s "
            f"deadline (observed {self.elapsed_s:.3f}s) — hang detected"
        )


class _Noop:
    """Shared disabled-path context manager (allocation-free)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


def parse_spec(spec: str) -> dict[str, float]:
    """Parse ``phase=secs;phase=secs`` (the :data:`ENV_SPEC` grammar);
    unknown phases are rejected eagerly — same policy as the fault
    points' validation."""
    out: dict[str, float] = {}
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        name, sep, secs = entry.partition("=")
        name = name.strip()
        if not sep or name not in KNOWN_PHASES:
            raise ValueError(
                f"bad watchdog entry {entry!r} (want phase=secs with "
                f"phase in {KNOWN_PHASES})"
            )
        out[name] = float(secs)
        if out[name] <= 0:
            raise ValueError(
                f"watchdog deadline for {name!r} must be > 0, "
                f"got {out[name]!r}"
            )
    return out


class _PhaseGuard:
    """One armed phase entry: deadline bookkeeping on enter/exit."""

    __slots__ = ("_table", "phase", "deadline_s", "_t0", "_token")

    def __init__(self, table: "WatchdogTable", phase: str,
                 deadline_s: float):
        self._table = table
        self.phase = phase
        self.deadline_s = deadline_s
        self._t0 = 0.0
        self._token = None

    def __enter__(self):
        self._t0 = time.monotonic()
        self._token = self._table._arm(self.phase, self._t0,
                                       self.deadline_s)
        return self

    def __exit__(self, exc_type, exc, tb):
        elapsed = time.monotonic() - self._t0
        self._table._disarm(self._token)
        if elapsed > self.deadline_s:
            # The phase DID return (a finite hang) — emit the same
            # structured evidence the exit-mode monitor would have, and
            # in raise mode surface the verdict unless a real exception
            # is already unwinding (never mask the primary failure).
            self._table._note_overrun(self.phase, self.deadline_s,
                                      elapsed)
            if self._table.action == "raise" and exc_type is None:
                raise HangDetected(self.phase, self.deadline_s, elapsed)
        elif elapsed > NEAR_MISS_FRACTION * self.deadline_s:
            # Near miss: the phase survived but spent >80% of its
            # budget — the last observable moment BEFORE a hang verdict.
            self._table._note_near_miss(self.phase, self.deadline_s,
                                        elapsed)
        return False


class WatchdogTable:
    """A set of phase deadlines plus the machinery that enforces them.

    ``action='raise'`` is thread-free and deterministic: the overrun is
    detected at phase exit (finite hangs only). ``action='exit'``
    additionally runs a daemon monitor thread that hard-exits the
    process (:data:`HANG_EXIT_RC`) when any armed phase passes its
    deadline — the only way out of a phase that never returns. Events
    are journaled best-effort (``journal`` is any EventLog-shaped
    object) and mirrored to :func:`fm_spark_tpu_torch.obs.event`.
    """

    def __init__(self, deadlines: dict[str, float],
                 action: str = "raise", journal=None,
                 exit_rc: int = HANG_EXIT_RC, poll_s: float = 0.05,
                 _exit=os._exit):
        if action not in _ACTIONS:
            raise ValueError(
                f"watchdog action must be one of {_ACTIONS}, "
                f"got {action!r}"
            )
        self.deadlines = {str(k): float(v) for k, v in deadlines.items()}
        self.action = action
        self.journal = journal
        self.exit_rc = int(exit_rc)
        self._poll_s = float(poll_s)
        self._exit = _exit
        self._lock = threading.Lock()
        self._armed: dict[int, tuple[str, float, float]] = {}
        self._next_token = 0
        self._monitor: threading.Thread | None = None
        self._stop = threading.Event()
        self.hangs_detected = 0
        self.near_misses = 0
        self._last_near_dump: dict[str, float] = {}

    # ----------------------------------------------------------- arming

    def phase(self, name: str):
        limit = self.deadlines.get(name)
        if limit is None:
            return _NOOP
        return _PhaseGuard(self, name, limit)

    def _arm(self, name: str, t0: float, limit: float):
        if self.action != "exit":
            return None
        with self._lock:
            token = self._next_token
            self._next_token += 1
            self._armed[token] = (name, t0, t0 + limit)
            if self._monitor is None or not self._monitor.is_alive():
                self._stop.clear()
                self._monitor = threading.Thread(
                    target=self._watch, name="fm-spark-watchdog",
                    daemon=True)
                self._monitor.start()
        return token

    def _disarm(self, token) -> None:
        if token is None:
            return
        with self._lock:
            self._armed.pop(token, None)

    # --------------------------------------------------------- verdicts

    def _note_overrun(self, name: str, limit: float,
                      elapsed: float) -> None:
        # Under the table lock: the exit-mode monitor thread and a
        # raise-mode phase exit (caller thread) can both note overruns
        # — an unlocked += here drops counts.
        with self._lock:
            self.hangs_detected += 1
        fields = dict(phase=name, deadline_s=round(limit, 3),
                      elapsed_s=round(elapsed, 3), action=self.action)
        if self.journal is not None:
            try:
                self.journal.emit("hang_detected", **fields)
            except Exception:
                pass
        try:
            obs.event("hang_detected", **fields)
            obs.counter("resilience.hangs_detected_total").add(1)
            obs.flight_dump("hang_detected", **fields)
        except Exception:
            pass

    def _note_near_miss(self, name: str, limit: float,
                        elapsed: float) -> None:
        """A phase finished past :data:`NEAR_MISS_FRACTION` of its
        deadline: count it, arm a rate-limited deep capture, and journal
        and flight-dump the context. The heavy evidence is rate-limited
        (a phase living at 85% of its deadline near-misses every
        occurrence): with a capture engine armed its limiter decides (a
        suppressed fire suppresses the dump); unarmed, at most one per
        :data:`NEAR_MISS_DUMP_INTERVAL_S` per phase."""
        with self._lock:
            self.near_misses += 1
        fields = dict(phase=name, deadline_s=round(limit, 3),
                      elapsed_s=round(elapsed, 3),
                      frac=round(elapsed / limit, 3))
        try:
            obs.counter("resilience.near_misses_total").add(1)
        except Exception:
            pass
        armed = False
        bundle = None
        try:
            from fm_spark_tpu_torch.obs import introspect

            armed = introspect.active()
            if armed:
                bundle = introspect.fire("watchdog_near_miss", **fields)
        except Exception:
            pass
        if armed and bundle is None:
            return  # the engine's rate limiter suppressed this one
        if not armed:
            now = time.monotonic()
            with self._lock:
                last = self._last_near_dump.get(name)
                if last is not None and \
                        now - last < NEAR_MISS_DUMP_INTERVAL_S:
                    return
                self._last_near_dump[name] = now
        if self.journal is not None:
            try:
                self.journal.emit("watchdog_near_miss", **fields)
            except Exception:
                pass
        try:
            obs.event("watchdog_near_miss", **fields)
            obs.flight_dump("watchdog_near_miss", **fields)
        except Exception:
            pass

    def _watch(self) -> None:
        while not self._stop.wait(self._poll_s):
            now = time.monotonic()
            fired = None
            with self._lock:
                for name, t0, deadline in self._armed.values():
                    if now > deadline:
                        fired = (name, deadline - t0, now - t0)
                        break
            if fired is None:
                continue
            # The hung thread is still stuck inside the phase: dump the
            # evidence from here, then hard-exit — a detected, bounded,
            # journaled ending instead of an eternal hang.
            self._note_overrun(*fired)
            self._exit(self.exit_rc)
            return  # test doubles for _exit return instead of dying

    def close(self) -> None:
        self._stop.set()
        with self._lock:
            self._armed.clear()
            monitor = self._monitor
            self._monitor = None
        if monitor is not None:
            # Joined on the shutdown path: daemon or not, a monitor left
            # spinning between configure() cycles leaks one poll thread
            # per table.
            monitor.join(timeout=5.0)


# Module state, faults.py-style: None = env not looked at yet; False =
# looked, nothing configured (phase() stays one comparison); else the
# active table.
_table: WatchdogTable | None | bool = None


def configure(deadlines: dict[str, float] | str,
              action: str = "raise", journal=None,
              **kw) -> WatchdogTable:
    """Install a watchdog table in-process (chaos drills/tests); a
    string is parsed with the :data:`ENV_SPEC` grammar."""
    global _table
    if isinstance(deadlines, str):
        deadlines = parse_spec(deadlines)
    clear()
    _table = WatchdogTable(deadlines, action=action, journal=journal,
                           **kw)
    return _table


def clear() -> None:
    """Drop the active table AND forget the env lookup, so a later
    :func:`phase` re-reads the environment (test isolation)."""
    global _table
    if isinstance(_table, WatchdogTable):
        _table.close()
    _table = None


def _load_env() -> "WatchdogTable | bool":
    spec = os.environ.get(ENV_SPEC, "").strip()
    if not spec:
        return False
    action = os.environ.get(ENV_ACTION, "exit").strip() or "exit"
    return WatchdogTable(parse_spec(spec), action=action)


def phase(name: str):
    """The production hook: a deadline-armed context manager for
    ``name``, or the shared no-op when unconfigured / not budgeted."""
    global _table
    t = _table
    if t is None:
        t = _table = _load_env()
    if t is False:
        return _NOOP
    return t.phase(name)


def active(name: str | None = None) -> bool:
    """Is a watchdog configured (optionally: with a budget for
    ``name``)? Cheap enough to latch outside hot loops."""
    global _table
    t = _table
    if t is None:
        t = _table = _load_env()
    if t is False:
        return False
    return True if name is None else name in t.deadlines
