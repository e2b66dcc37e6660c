"""Deterministic network faults (the port's copy of
``fm_spark_tpu/resilience/netfaults.py``: the plan semantics and
:class:`TransportFailure`). Partitions, slow links, half-open
connections and truncated responses kill no process, so the process-kill
model cannot express them; this module makes them injectable with the
SAME plan grammar, environment variables and occurrence counters as
:mod:`fm_spark_tpu_torch.resilience.faults`.

Its seam is the serving fleet's transport (the reference's
``serve/fleet.py`` connection pool), which the port takes with ROADMAP
Queue 1 item 6b; until then nothing in the port calls
:func:`on_connect`, :func:`on_send` or :func:`on_recv` but the tests.

Points and their actions::

    net_connect     per TCP dial           refuse | blackhole[:cap_s]
    net_send        per request write      | slow_ms:N | reset
    net_recv        per response read      | truncate_after:K (recv)

- ``refuse``           ConnectionRefusedError (connect) / reset (send)
- ``reset``            ConnectionResetError at that phase
- ``blackhole``        sleep min(caller timeout, cap), then time out
- ``slow_ms:N``        N ms of link latency, then proceed
- ``truncate_after:K`` deliver only the first K response-body bytes, then
                       kill the connection (``net_recv`` only; on
                       ``net_send``/``net_connect`` it degrades to
                       ``reset``)

Peer scoping: ``net_connect.replica-1@1-8=refuse`` fires only on the
transport to the peer labelled ``replica-1`` (its own occurrence
counter); unscoped rules count occurrences fleet-wide.

Phase discipline (the exactly-once contract): ``net_connect`` and
``net_send`` faults strike BEFORE the request reached the replica, so a
retry elsewhere is safe; ``net_recv`` faults strike AFTER it may have
executed, and :class:`TransportFailure` classifies them.
"""

from __future__ import annotations

import socket
import threading
import time

from fm_spark_tpu_torch.resilience import faults
from fm_spark_tpu_torch.utils import sleeps

__all__ = [
    "BLACKHOLE_CAP_S",
    "TransportFailure",
    "check",
    "on_connect",
    "on_recv",
    "on_send",
]

#: Default ceiling on a blackhole's sleep (scaled by
#: ``FM_SPARK_TEST_SLEEP_SCALE``): a blackhole emulates "packets
#: vanish until the caller's timeout", and the sleep is bounded by
#: min(caller timeout, cap) so a drill never waits minutes to prove a
#: timeout fired.
BLACKHOLE_CAP_S = 5.0

#: In-process occurrence counting is shared across the health thread
#: and every dispatch thread; faults' in-proc counter dict is not
#: locked (its points fire from one thread each), so the net plane
#: serializes its own counter consumption.
_count_lock = threading.Lock()


class TransportFailure(OSError):
    """A classified replica-transport failure.

    ``phase`` is where the underlying failure struck — ``connect``
    (dial), ``send`` (request write), or ``recv`` (response read) —
    and ``bytes_received`` is > 0 once any response bytes (status
    line/headers/body) arrived. :attr:`retry_safe` is the exactly-once
    gate: a connect/send failure means the replica never saw the
    request; a recv failure with zero bytes means it died before
    answering (the kill-mid-burst semantics); a recv failure
    AFTER response bytes arrived means the replica executed and
    answered — replaying that request on another replica would score
    it twice.
    """

    def __init__(self, message: str, *, phase: str,
                 bytes_received: int = 0):
        super().__init__(message)
        self.phase = phase
        self.bytes_received = int(bytes_received)

    @property
    def retry_safe(self) -> bool:
        return self.phase != "recv" or self.bytes_received == 0


def check(point: str, peer: "str | None" = None):
    """The matching rule for this transport event, or None.

    Consults the ACTIVE faults plan (env or ``faults.activate``).
    A peer-scoped rule set (``point.peer``) is consulted first with
    its own occurrence counter; the unscoped point counts fleet-wide.
    Both counters only advance when the plan names their key — an
    inactive plane is one ``is None`` check, same as ``inject``.
    """
    plan = faults.current_plan()
    if plan is None:
        return None
    scoped = unscoped = None
    with _count_lock:
        # Both counters advance on every event their key is planned
        # for — "this peer's Nth dial" and "the fleet's Nth dial"
        # stay independently meaningful; the peer-scoped rule wins
        # when both match.
        if peer is not None:
            key = f"{point}.{peer}"
            if key in plan.points:
                scoped = plan.rule_for(key, faults._next_count(key))
        if point in plan.points:
            unscoped = plan.rule_for(point, faults._next_count(point))
    return scoped if scoped is not None else unscoped


def _strike(rule, phase: str, timeout_s: "float | None") -> "int | None":
    """Take a rule's action at a transport phase. Raises the
    socket-level error the action emulates, sleeps for latency
    actions, or returns a byte budget for ``truncate_after`` on recv
    (the caller owns the response bytes to truncate). Non-net actions
    (``sleep``/``error``/``exit``...) fall through to the generic
    :meth:`faults._Rule.fire`."""
    a = rule.action
    where = f"{rule.point}#{rule.occurrence}"
    if a == "refuse":
        if phase == "connect":
            raise ConnectionRefusedError(
                f"[netfault] connection refused ({where})")
        raise ConnectionResetError(
            f"[netfault] connection refused mid-{phase} ({where})")
    if a == "reset":
        raise ConnectionResetError(
            f"[netfault] connection reset during {phase} ({where})")
    if a == "blackhole":
        cap = sleeps.scaled(float(rule.param)
                            if rule.param else BLACKHOLE_CAP_S)
        time.sleep(min(timeout_s, cap)
                   if timeout_s is not None else cap)
        raise socket.timeout(
            f"[netfault] {phase} blackholed ({where})")
    if a == "slow_ms":
        time.sleep(float(rule.param) / 1e3)
        return None
    if a == "truncate_after":
        if phase == "recv":
            return int(rule.param)
        # A truncated dial/request is a connection the server never
        # parsed a full request from: dead, nothing executed.
        raise ConnectionResetError(
            f"[netfault] {phase} truncated ({where})")
    rule.fire(rule.occurrence)
    return None


def on_connect(peer: "str | None",
               timeout_s: "float | None" = None) -> None:
    """``net_connect`` — fires per TCP dial (pool fresh dials, the
    pool-less health/metrics probes)."""
    rule = check("net_connect", peer)
    if rule is not None:
        _strike(rule, "connect", timeout_s)


def on_send(peer: "str | None",
            timeout_s: "float | None" = None) -> None:
    """``net_send`` — fires per request write, BEFORE bytes leave.
    Every failure raised here is send-phase: the replica never saw
    the request, so a retry elsewhere is exactly-once safe."""
    rule = check("net_send", peer)
    if rule is not None:
        _strike(rule, "send", timeout_s)


def on_recv(peer: "str | None",
            timeout_s: "float | None" = None) -> "int | None":
    """``net_recv`` — fires per response read. Returns a byte budget
    when the rule is ``truncate_after:K`` (the caller delivers only K
    body bytes then treats the connection as dead); raises the
    emulated socket error otherwise."""
    rule = check("net_recv", peer)
    if rule is None:
        return None
    return _strike(rule, "recv", timeout_s)
