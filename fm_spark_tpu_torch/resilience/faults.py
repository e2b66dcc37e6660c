"""Deterministic fault injection (the port's copy of
``fm_spark_tpu/resilience/faults.py``): the failure modes a run meets —
a hang, a process that exits, a mid-step device loss, a SIGTERM landing
mid-run, a slow step — on demand, at named points, on any device (the
CPU included).

A fault PLAN is a ``;``-separated list of rules::

    <point>@<occurrence>[-<last>]=<action>[:<param>]

    FM_SPARK_FAULTS="train_step@3=device_loss;ckpt_commit@1=hang:300"

means: the 3rd time any process hits the ``train_step`` point, raise
:class:`InjectedDeviceLoss`; the 1st ``ckpt_commit`` sleeps 300 s (a
hang, for the watchdog to catch). ``@a-b`` covers a range of
occurrences with one rule.

Actions: ``hang[:secs]`` (sleep; default 3600 s: something else must
kill it), ``sleep:secs`` (a slow step), ``exit[:rc]`` (``os._exit``),
``device_loss`` (raise :class:`InjectedDeviceLoss`), ``error`` (raise
:class:`FaultInjected`), ``sigterm`` (``os.kill(self, SIGTERM)``); and
the socket- and disk-level actions of the ``net_*`` and ``io_*`` points,
which :mod:`.netfaults` and :mod:`.iofaults` interpret.

Occurrences are counted PER POINT, in-process by default; when
``FM_SPARK_FAULTS_STATE=<file>`` names a JSON file, the counters persist
across processes (flock-serialized), so "the first process's 2nd step,
then the respawned one's 1st save" is one plan.

Production code calls :func:`inject` at its fault points; with no active
plan that is a single ``is None`` check. Tests set the environment of a
subprocess or call :func:`activate`/:func:`clear` in-process. Nothing
here imports torch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import signal
import time

__all__ = [
    "ACTIONS",
    "ENV_PLAN",
    "ENV_STATE",
    "IO_ACTIONS",
    "IO_PATH_CLASSES",
    "IO_POINTS",
    "KNOWN_POINTS",
    "NET_ACTIONS",
    "NET_POINTS",
    "FaultInjected",
    "FaultPlan",
    "InjectedDeviceLoss",
    "activate",
    "clear",
    "current_plan",
    "inject",
    "is_device_loss",
]

#: Environment variables read lazily at the first :func:`inject` call.
ENV_PLAN = "FM_SPARK_FAULTS"
ENV_STATE = "FM_SPARK_FAULTS_STATE"

#: The injection points: the reference's registry, name for name. The
#: port calls these (the rest wait for the modules that call them):
#:
#: - ``train_step``: once per step of ``FMTrainer``'s loop and of
#:   ``fit_field_sparse``'s, before the batch is fetched;
#: - ``ckpt_commit``: inside a save's commit window, under the
#:   ``ckpt_commit`` watchdog phase, before the manifest verifies
#:   (``checkpoint.Checkpointer``);
#: - ``ckpt_demote``: a demotion's tombstone is durable and the
#:   ``last_good`` pointer is not yet republished, so an ``exit`` there
#:   is the SIGKILL-mid-demotion drill;
#: - ``ckpt_gc``: the emergency GC's intent is journaled and nothing is
#:   deleted yet;
#: - ``serve_reload``: at the start of each hot-reload attempt
#:   (``serve/reload.py``): an ``error`` is the degraded-serving path, an
#:   ``exit`` the SIGKILL-during-reload drill;
#: - ``ingest_truncate``: once per chunk a raw-text reader reads;
#:   ``ingest_corrupt``: once per record before its parse (Python path)
#:   or once per parsed chunk (native path); an ``error`` there is a
#:   corrupt record and takes the data policy's path;
#: - ``online_eval``: at the start of each eval day of ``online.py``;
#: - ``embed_prefetch``: once per bucket the tiered store stages, on its
#:   prefetch thread; ``embed_evict``: at the start of each eviction's
#:   dirty write-back;
#: - ``io_write``, ``io_fsync``, ``io_rename``, ``io_read``: the durable
#:   seam (``utils/durable.py``), interpreted by
#:   :mod:`~fm_spark_tpu_torch.resilience.iofaults`, scoped by path class
#:   (``io_write.ckpt``);
#: - ``net_connect``, ``net_send``, ``net_recv``: the fleet's transport,
#:   interpreted by :mod:`~fm_spark_tpu_torch.resilience.netfaults`,
#:   scoped by peer (``net_connect.replica-1``); like ``backend_init``,
#:   ``sweep_leg``, ``probe``, ``frontdoor_accept``, ``replica_kill`` and
#:   ``fleet_dispatch`` they fire in modules the port has not taken yet
#:   (ROADMAP Queue 1 items 6b and 12a).
KNOWN_POINTS = (
    "backend_init",
    "sweep_leg",
    "train_step",
    "probe",
    "ckpt_commit",
    "ingest_corrupt",
    "ingest_truncate",
    "serve_reload",
    "online_eval",
    "ckpt_demote",
    "embed_prefetch",
    "embed_evict",
    "frontdoor_accept",
    "replica_kill",
    "fleet_dispatch",
    "net_connect",
    "net_send",
    "net_recv",
    "io_write",
    "io_fsync",
    "io_rename",
    "io_read",
    "ckpt_gc",
)

#: The network points and their socket-level action vocabulary.
#: Net actions are only valid on ``net_*`` points (and
#: vice versa peer scoping is only valid there); they are interpreted
#: by :mod:`fm_spark_tpu_torch.resilience.netfaults` at the transport seam.
NET_POINTS = ("net_connect", "net_send", "net_recv")
NET_ACTIONS = ("refuse", "blackhole", "slow_ms", "truncate_after",
               "reset")

#: The storage points and their disk-level action vocabulary.
#: IO actions are only valid on ``io_*`` points;
#: ``slow_ms`` is shared with the net plane (a slow fsync and a slow
#: link are the same latency primitive). Interpreted by
#: :mod:`fm_spark_tpu_torch.resilience.iofaults` at the durable-write seam.
IO_POINTS = ("io_write", "io_fsync", "io_rename", "io_read")
IO_ACTIONS = ("eio", "enospc", "torn_write", "readonly")

#: The path classes an ``io_*`` point may scope to (``io_write.ckpt``).
#: Unlike net peer scopes (free-form replica names), path classes are a
#: closed vocabulary — each names one durability tier declared at a
#: :mod:`fm_spark_tpu_torch.utils.durable` call site — so a typo'd class is a
#: plan that silently never fires and is rejected eagerly.
IO_PATH_CLASSES = ("ckpt", "obs", "embed", "cache", "quarantine")

#: The action vocabulary (public: the chaos schedule
#: generator samples from it, and the eager-validation error cites it).
ACTIONS = ("hang", "sleep", "exit", "device_loss", "error", "sigterm",
           *NET_ACTIONS, *IO_ACTIONS)
_ACTIONS = ACTIONS

#: Actions that must carry a numeric parameter (``slow_ms:N`` in
#: milliseconds, ``truncate_after:K`` / ``torn_write:K`` in bytes).
_PARAM_REQUIRED = ("slow_ms", "truncate_after", "torn_write")

#: Occurrence-range expansion bound: ``point@1-512=...`` is the widest
#: window one rule may cover (a wider one is almost certainly a typo).
_MAX_RANGE = 512


class FaultInjected(RuntimeError):
    """An injected generic failure (action ``error``)."""


class InjectedDeviceLoss(FaultInjected):
    """An injected mid-step device loss.

    The message mimics the runtime-error text a real detachment produces
    so string-matching consumers exercise the same path either way.
    """

    def __init__(self, point: str, occurrence: int):
        super().__init__(
            f"INTERNAL: device lost / attachment detached "
            f"(injected fault at {point}#{occurrence})"
        )


@dataclasses.dataclass(frozen=True)
class _Rule:
    point: str
    occurrence: int
    action: str
    param: str | None

    def fire(self, count: int) -> None:
        if self.action == "hang":
            time.sleep(float(self.param) if self.param else 3600.0)
        elif self.action == "sleep":
            time.sleep(float(self.param or 1.0))
        elif self.action == "exit":
            os._exit(int(self.param or 1))
        elif self.action == "device_loss":
            raise InjectedDeviceLoss(self.point, count)
        elif self.action == "error":
            raise FaultInjected(
                f"injected failure at {self.point}#{count}"
            )
        elif self.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)


class FaultPlan:
    """A parsed set of injection rules, matched at :func:`inject` points."""

    def __init__(self, rules: list[_Rule]):
        self._rules: dict[tuple[str, int], _Rule] = {
            (r.point, r.occurrence): r for r in rules
        }
        self.points = {r.point for r in rules}

    @classmethod
    def from_spec(cls, spec: str,
                  points: "tuple[str, ...] | None" = KNOWN_POINTS
                  ) -> "FaultPlan":
        """Parse a plan, validating it EAGERLY: an
        unknown point or action used to surface only when (never) the
        point fired — a typo'd plan silently tested nothing. Both are
        rejected up front with the registry/action set in the error.
        ``points=None`` disables the registry check (harness-internal
        plans over synthetic points).

        Grammar extensions, for the network and storage fault planes:
        ``net_*`` points accept a PEER SCOPE (``net_connect.replica-1``
        — fires only on that peer's transport, with its own occurrence
        counter), and any rule accepts an occurrence RANGE
        (``point@3-9=action`` expands to one rule per occurrence) so a
        bounded partition window is one rule, not seven.
        """
        rules = []
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            m = re.fullmatch(
                r"(?P<point>[\w.-]+)@(?P<n>\d+)(?:-(?P<n2>\d+))?="
                r"(?P<action>[a-z_]+)(?::(?P<param>[\w.+-]+))?",
                entry,
            )
            if m is None:
                raise ValueError(
                    f"bad fault rule {entry!r} (want "
                    "point@occurrence[-occurrence]=action[:param])"
                )
            if m["action"] not in _ACTIONS:
                raise ValueError(
                    f"unknown fault action {m['action']!r} "
                    f"(know {_ACTIONS})"
                )
            point = m["point"]
            base = point.split(".", 1)[0]
            if points is not None and point not in points:
                # A dotted point is a peer-scoped NET point
                # (``net_connect.replica-1``) or a path-class-scoped
                # IO point (``io_write.ckpt``); scoping any other
                # point is as much a typo as an unknown one.
                if not ("." in point
                        and (base in NET_POINTS or base in IO_POINTS)
                        and base in points):
                    raise ValueError(
                        f"unknown fault point {point!r} — a rule "
                        "naming a point nothing injects would silently "
                        f"never fire (known points: {tuple(points)}; "
                        f"actions: {_ACTIONS})"
                    )
                if (base in IO_POINTS
                        and point[len(base) + 1:] not in IO_PATH_CLASSES):
                    raise ValueError(
                        f"unknown io path class in {point!r} — io "
                        "points scope to the durable-seam path classes "
                        f"{IO_PATH_CLASSES}, not free-form names"
                    )
            if (m["action"] in NET_ACTIONS and base not in NET_POINTS
                    and not (m["action"] == "slow_ms"
                             and base in IO_POINTS)):
                raise ValueError(
                    f"net action {m['action']!r} on non-network point "
                    f"{point!r} — socket-level actions only make "
                    f"sense at {NET_POINTS} (see resilience/netfaults)"
                )
            if m["action"] in IO_ACTIONS and base not in IO_POINTS:
                raise ValueError(
                    f"io action {m['action']!r} on non-storage point "
                    f"{point!r} — disk-level actions only make sense "
                    f"at {IO_POINTS} (see resilience/iofaults)"
                )
            if (m["action"] in _PARAM_REQUIRED
                    and not (m["param"] or "").replace(".", "").isdigit()):
                raise ValueError(
                    f"action {m['action']!r} needs a numeric "
                    f"parameter (got {m['param']!r}) — e.g. "
                    "slow_ms:50 or truncate_after:64"
                )
            first, last = int(m["n"]), int(m["n2"] or m["n"])
            if last < first or last - first >= _MAX_RANGE:
                raise ValueError(
                    f"bad occurrence range {first}-{last} in "
                    f"{entry!r} (want first <= last, width < "
                    f"{_MAX_RANGE})"
                )
            for n in range(first, last + 1):
                rules.append(_Rule(point, n, m["action"], m["param"]))
        return cls(rules)

    @classmethod
    def from_env(cls) -> "FaultPlan | None":
        spec = os.environ.get(ENV_PLAN, "").strip()
        return cls.from_spec(spec) if spec else None

    def rule_for(self, point: str, count: int) -> _Rule | None:
        return self._rules.get((point, count))


# Module state: the active plan (None until loaded; False = "looked at
# the env, nothing there" so inject() stays one comparison on the hot
# path) and the in-process occurrence counters.
_plan: FaultPlan | None | bool = None
_counts: dict[str, int] = {}


def activate(plan: "FaultPlan | str") -> FaultPlan:
    """Install a plan in-process (tests); resets occurrence counters."""
    global _plan
    if isinstance(plan, str):
        plan = FaultPlan.from_spec(plan)
    _plan = plan
    _counts.clear()
    return plan


def clear() -> None:
    """Drop the active plan AND forget the env lookup, so a later
    :func:`inject` re-reads the environment (test isolation)."""
    global _plan
    _plan = None
    _counts.clear()


def _next_count(point: str) -> int:
    """Increment and return this point's occurrence counter — in the
    shared state file when ``FM_SPARK_FAULTS_STATE`` is set (counts
    survive process respawn), else in-process."""
    path = os.environ.get(ENV_STATE, "").strip()
    if not path:
        _counts[point] = _counts.get(point, 0) + 1
        return _counts[point]
    import fcntl

    with open(path, "a+") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        f.seek(0)
        raw = f.read().strip()
        data = json.loads(raw) if raw else {}
        data[point] = int(data.get(point, 0)) + 1
        f.seek(0)
        f.truncate()
        json.dump(data, f)
        f.flush()
        return data[point]


def current_plan() -> "FaultPlan | None":
    """The active plan, loading the environment lazily on first use —
    the same resolution :func:`inject` performs, exposed so the
    network fault plane (:mod:`fm_spark_tpu_torch.resilience.netfaults`) can
    consult the SAME plan and occurrence counters from the transport
    seam."""
    global _plan
    if _plan is None:
        _plan = FaultPlan.from_env() or False
    return None if _plan is False else _plan


def inject(point: str) -> None:
    """Fault point: a no-op without an active plan; with one, the
    matching rule for this point's Nth occurrence fires (sleep / raise /
    exit / signal). Call sites name the observable failure surface —
    see :data:`KNOWN_POINTS` for the registry (device/runtime faults
    plus the streaming-ingest data faults). ``net_*`` points are NOT
    injected here — :mod:`fm_spark_tpu_torch.resilience.netfaults` interprets
    their socket-level actions at the transport seam."""
    plan = current_plan()
    if plan is None:
        return
    if point not in plan.points:
        return
    count = _next_count(point)
    rule = plan.rule_for(point, count)
    if rule is not None:
        rule.fire(count)


# Substrings (lowercased) that mark a runtime error as a lost/unhealthy
# device attachment rather than a program bug: the reference's
# vocabulary, kept word for word so both packages classify an error
# alike. A compile error or a shape mismatch must NEVER
# match — retrying those burns the whole deadline re-crashing.
_DEVICE_LOSS_MARKERS = (
    "device lost",
    "device is lost",
    "data_loss",
    "attachment detached",
    "unable to initialize backend",
    "failed to enqueue",
    "device unavailable",
    "tpu driver",
    "socket closed",
    "connection reset",
    "transport closed",
    "halted execution",
)


def is_device_loss(exc: BaseException) -> bool:
    """Is this exception a lost/unhealthy device attachment (injected or
    real)? The supervisor's retryability test: device loss is transient
    by definition here (the attachment flaps); anything else is a
    program error and must propagate."""
    if isinstance(exc, InjectedDeviceLoss):
        return True
    if isinstance(exc, (KeyboardInterrupt, SystemExit)):
        return False
    text = f"{type(exc).__name__}: {exc}".lower()
    return any(marker in text for marker in _DEVICE_LOSS_MARKERS)
