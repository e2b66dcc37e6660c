"""The multi-process replica fleet behind the serving front door (the
port's copy of ``fm_spark_tpu/serve/fleet.py``).

Topology: N replica PROCESSES, each running the port's serving stack —
a :class:`~fm_spark_tpu_torch.serve.engine.PredictEngine` (a CUDA graph
per bucket on the card) and, with a chain, its own read-only
:class:`~fm_spark_tpu_torch.serve.reload.ReloadFollower` — behind one
in-parent :class:`Fleet` backend the
:class:`~fm_spark_tpu_torch.serve.frontdoor.FrontDoor` dispatches
through. Each replica runs on the device the parent gives it
(``device``): several replicas share one card as separate processes,
each with its own CUDA context, tables and graphs. They share the
kernel build cache (``compile_cache_dir``): the first to need a library
builds it under the cache's lock, the rest load it (the warm-up's
``fresh_compiles``). A replica imports no JAX.

Replica lifecycle (all transitions journaled by the parent, in
``fleet_health.jsonl`` under the run dir):

``starting``   spawned; the parent waits for the atomic port file, then
               for ``/healthz`` to report ready (warm-up complete)
``ready``      in the dispatch rotation
``suspect``    drained: failed a health check or a dispatch — no new
               traffic; re-admitted the moment ``/healthz`` goes green
``dead``       process exited (SIGKILL mid-burst is the drill) —
               respawned, then re-admitted through the same readiness
               gate
``retired``    permanently failed (the elastic controller classified
               the respawn failures permanent and shrank the fleet's
               capacity — scale-down, not a crash loop)

Dispatch is round-robin over ready replicas; an in-flight request on a
replica that dies mid-burst is retried ONCE on a live replica
(``frontdoor.retries_total``) or failed with an explicit
:class:`~fm_spark_tpu_torch.serve.frontdoor.BackendError` — never
silently dropped — and only when the failure was exactly-once safe
(:class:`TransportFailure`). The ``fleet_dispatch`` fault point fires
per dispatch attempt in the parent; ``replica_kill`` fires per scored
request inside the replica (an ``exit`` action IS the kill-mid-burst
drill, counted across processes with ``FM_SPARK_FAULTS_STATE``).

Run one replica: ``python -m fm_spark_tpu_torch.serve.fleet
--replica-id 0 --model DIR --port-file P [--chain-dir C] [--device D]``
— it announces its port by atomically writing the port file.
"""

from __future__ import annotations

import dataclasses
import http.client
import http.server
import json
import os
import signal
import socketserver
import subprocess
import sys
import threading
import time

from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.resilience import faults, netfaults
from fm_spark_tpu_torch.resilience.elastic import ElasticController
from fm_spark_tpu_torch.utils.logging import EventLog

#: Re-exported: the classified transport error ``_http_json`` raises
#: (phase + bytes_received — the exactly-once retry gate).
TransportFailure = netfaults.TransportFailure

__all__ = ["ConnectionPool", "Fleet", "HostSpec", "ReplicaAddr",
           "ReplicaHandle", "TransportFailure", "replica_main"]

#: Parent-side health cadence and thresholds.
DEFAULT_HEALTH_POLL_S = 0.25
SUSPECT_AFTER_FAILURES = 2
SPAWN_TIMEOUT_S = 120.0


def _json_body(doc) -> bytes:
    # HTTP wire format / port-file payload — the sanctioned json.dumps
    # seam (journal writes go through EventLog).
    return (json.dumps(doc) + "\n").encode()


def _write_port_file(path: str, port: int) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        f.write(_json_body({"port": int(port), "pid": os.getpid()}))
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclasses.dataclass(frozen=True)
class ReplicaAddr:
    """Where the parent dials one replica: every transport path
    (dispatch, health poll, metrics scrape) threads this instead of a
    hardcoded loopback literal."""

    host: str
    port: int


@dataclasses.dataclass(frozen=True)
class HostSpec:
    """Where/how one replica launches: a multi-host fleet is a config
    change, not a rewrite. ``connect_host`` is what the parent dials,
    ``bind_host`` what the replica's HTTP server binds, and ``spawn``
    an optional launch hook ``(cmd, env, stderr_path) -> Popen-like``
    (an ssh/container wrapper; it must arrange the shared ``work_dir``
    the port files and journals land in). ``spawn=None`` is the local
    subprocess — the tested default, loopback end to end."""

    connect_host: str = "127.0.0.1"
    bind_host: str = "127.0.0.1"
    spawn: "object | None" = None


class ConnectionPool:
    """Bounded keep-alive pool of :class:`http.client.HTTPConnection`
    to ONE replica.

    A fresh TCP connect per dispatch was pure transport tax; replicas
    speak HTTP/1.1, so the parent parks the connection after each
    response and the next dispatch to the same replica reuses it
    (``fleet.dispatch_reused_connection_total`` counts the wins). Stale
    sockets (replica died, restarted, or idled out) surface as an
    exception on first use; :func:`_http_json` retries ONCE on a fresh
    connection before failing upward — but only when the failure was
    exactly-once safe (see :class:`TransportFailure`). Thread-safe; the
    pool never blocks — an empty pool just dials.

    Every dial routes through the network fault plane
    (:mod:`fm_spark_tpu_torch.resilience.netfaults`): ``peer`` is the
    logical label (``replica-N``) a chaos schedule scopes partition
    rules to.
    """

    def __init__(self, host: str, port: int, max_idle: int = 4,
                 peer: "str | None" = None):
        self.host, self.port = host, int(port)
        self.max_idle = int(max_idle)
        self.peer = peer
        self._lock = threading.Lock()
        self._idle: list = []
        self._closed = False

    def fresh(self):
        return netfaults.FaultyHTTPConnection(self.host, self.port,
                                              peer=self.peer)

    def take(self):
        """(connection, reused) — a parked connection when one exists,
        else a fresh dial."""
        with self._lock:
            if self._idle:
                return self._idle.pop(), True
        return self.fresh(), False

    def give(self, conn) -> None:
        """Park a connection whose response was fully read."""
        with self._lock:
            if not self._closed and len(self._idle) < self.max_idle:
                self._idle.append(conn)
                return
        try:
            conn.close()
        except Exception:  # noqa: BLE001 — closing is best-effort
            pass

    def close(self) -> None:
        with self._lock:
            self._closed = True
            idle, self._idle = self._idle, []
        for conn in idle:
            try:
                conn.close()
            except Exception:  # noqa: BLE001
                pass


def _http_json(host, port, method, path, body=None, timeout_s=2.0,
               trace=None, pool=None, peer=None):
    """One JSON request to a replica; returns (status, doc).

    ``trace`` (a :class:`~fm_spark_tpu_torch.obs.trace.TraceContext`) rides
    the ``X-FM-Trace`` header so the replica's spans join the caller's
    timeline. ``pool`` enables keep-alive: take/give through it, with
    one fresh-connection retry when a REUSED socket turns out stale
    (a fresh socket's failure is real and propagates). ``peer`` labels
    the transport for the network fault plane (netfaults).

    Every transport failure surfaces as a :class:`TransportFailure`
    classifying WHERE it struck — ``connect`` (dial), ``send``
    (request write), ``recv`` (response read) — and whether any
    response bytes had arrived. That classification is the
    exactly-once gate: the stale-reuse retry
    below and the fleet's dispatch retry both replay a request ONLY
    when the replica cannot have answered it — a recv failure after
    response bytes arrived is never replayed.
    """
    payload = _json_body(body) if body is not None else None

    def _attempt(conn):
        # The one serve-side seam that puts dispatch bytes on the
        # wire.
        conn.timeout = timeout_s
        if conn.sock is not None:
            conn.sock.settimeout(timeout_s)
        headers = {}
        if payload is not None:
            headers["Content-Type"] = "application/json"
        if trace is not None:
            headers[obs.TRACE_HEADER] = trace.to_header()
        phase, got_response = "connect", False
        try:
            if conn.sock is None:
                conn.connect()
            phase = "send"
            netfaults.on_send(peer, timeout_s=timeout_s)
            conn.request(method, path, body=payload, headers=headers)
            phase = "recv"
            trunc = netfaults.on_recv(peer, timeout_s=timeout_s)
            resp = conn.getresponse()
            got_response = True  # status line + headers arrived
            raw = resp.read()
            if trunc is not None and trunc < len(raw):
                raise TransportFailure(
                    f"[netfault] response truncated after {trunc} "
                    f"of {len(raw)} body bytes",
                    phase="recv", bytes_received=max(1, trunc))
        except TransportFailure:
            raise
        except (http.client.HTTPException, OSError) as e:
            nbytes = (1 if got_response
                      else len(getattr(e, "partial", b"") or b""))
            raise TransportFailure(
                f"{type(e).__name__}: {e}", phase=phase,
                bytes_received=nbytes) from e
        try:
            doc = json.loads(raw.decode() or "{}")
        except ValueError:
            doc = {}
        return resp.status, doc, bool(resp.will_close)

    if pool is None:
        conn = netfaults.FaultyHTTPConnection(host, port, peer=peer,
                                              timeout=timeout_s)
        try:
            status, doc, _ = _attempt(conn)
            return status, doc
        finally:
            conn.close()

    conn, reused = pool.take()
    try:
        try:
            status, doc, will_close = _attempt(conn)
        except TransportFailure as e:
            conn.close()
            if not reused or not e.retry_safe:
                # A fresh socket's failure is real; a reused one that
                # failed AFTER response bytes arrived must not be
                # replayed — the replica may have executed (the
                # exactly-once hazard the truncation faults expose).
                raise
            # Parked socket went stale between dispatches: one retry
            # on a fresh dial before the failure goes upward.
            conn, reused = pool.fresh(), False
            status, doc, will_close = _attempt(conn)
    except BaseException:
        try:
            conn.close()
        except Exception:  # noqa: BLE001
            pass
        raise
    if reused:
        obs.counter("fleet.dispatch_reused_connection_total").add(1)
    if will_close:
        conn.close()
    else:
        pool.give(conn)
    return status, doc


# =================================================== parent-side fleet


class ReplicaHandle:
    """One replica slot: the process, its port, and its health state.
    All mutation happens under the owning :class:`Fleet`'s lock."""

    def __init__(self, idx: int, spec: "HostSpec | None" = None):
        self.idx = int(idx)
        self.spec = spec or HostSpec()
        self.host = self.spec.connect_host
        self.proc = None
        self.port = None
        self.state = "starting"
        self.health_failures = 0
        self.last_doc: dict = {}
        self.spawned_at = None
        self.incarnations = 0
        self.pool: "ConnectionPool | None" = None
        self.metrics_doc: dict = {}
        self.scrape_tick = 0

    @property
    def peer(self) -> str:
        """The logical transport label netfault rules scope to."""
        return f"replica-{self.idx}"

    @property
    def addr(self) -> "ReplicaAddr | None":
        return (ReplicaAddr(self.host, self.port)
                if self.port is not None else None)

    def drop_pool(self) -> None:
        pool, self.pool = self.pool, None
        if pool is not None:
            pool.close()

    def doc(self) -> dict:
        return {
            "replica": self.idx, "state": self.state,
            "pid": (self.proc.pid if self.proc is not None else None),
            "host": self.host, "port": self.port,
            "incarnations": self.incarnations,
            "generation_step": self.last_doc.get("generation_step"),
            "staleness_steps": self.last_doc.get("staleness_steps"),
            "degraded": self.last_doc.get("degraded"),
            "fresh_compiles": self.last_doc.get("fresh_compiles"),
            "graph_replays": self.last_doc.get("graph_replays"),
            "kernel_runs": self.last_doc.get("kernel_runs"),
        }


class Fleet:
    """N replica processes + health monitoring + retry-once dispatch.
    A :class:`FrontDoor` backend (``score/healthz/close``)."""

    def __init__(self, model_dir: str, *, n_replicas: int = 2,
                 chain_dir: "str | None" = None,
                 work_dir: str, journal=None,
                 buckets: str = "1,4", latency_budget_ms: float = 2.0,
                 reload_poll_s: float = 0.2,
                 compile_cache_dir: "str | None" = None,
                 health_poll_s: float = DEFAULT_HEALTH_POLL_S,
                 spawn_timeout_s: float = SPAWN_TIMEOUT_S,
                 replica_env: "dict | None" = None,
                 max_shrinks: "int | None" = None,
                 obs_root: "str | None" = None,
                 hosts: "list | None" = None,
                 autoscaler=None, device=None):
        if n_replicas < 1:
            raise ValueError(f"need >= 1 replica, got {n_replicas}")
        self.model_dir = model_dir
        self.chain_dir = chain_dir
        self.work_dir = work_dir
        self.journal = journal
        self.buckets = buckets
        self.latency_budget_ms = float(latency_budget_ms)
        self.reload_poll_s = float(reload_poll_s)
        self.compile_cache_dir = compile_cache_dir
        #: The device every replica serves on (``--device``; None: the
        #: replica's default, the card).
        self.device = device
        self.health_poll_s = float(health_poll_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.replica_env = dict(replica_env or {})
        #: When set, each replica gets ``--obs-dir`` here and opens its
        #: own run dir under it (per-process span files of one request
        #: timeline).
        self.obs_root = obs_root
        os.makedirs(work_dir, exist_ok=True)
        self._lock = threading.Lock()
        self._rr = 0
        self._stopping = False
        #: Launch placement: replica i runs on
        #: hosts[i % len(hosts)] — default one loopback HostSpec, the
        #: tested topology; a multi-host fleet passes real specs.
        self.hosts = list(hosts) if hosts else [HostSpec()]
        #: Optional bidirectional autoscaler (serve/autoscale.py):
        #: ticked on the health-poll cadence; its grow/park decisions
        #: extend — never replace — the elastic controller's
        #: crash-loop retirement below.
        self.autoscaler = autoscaler
        if (autoscaler is not None
                and getattr(autoscaler, "journal", None) is None):
            autoscaler.journal = journal
        self.replicas = [
            ReplicaHandle(i, spec=self.hosts[i % len(self.hosts)])
            for i in range(n_replicas)]
        #: Scale-down primitive: replica slots are the
        #: "devices"; a permanently crash-looping slot shrinks the
        #: fleet's capacity target instead of respawning forever.
        self.elastic = ElasticController(
            devices=list(range(n_replicas)),
            max_shrinks=(n_replicas - 1 if max_shrinks is None
                         else max_shrinks),
            journal=journal)
        self._capacity = n_replicas
        self._monitor = None

    # ------------------------------------------------------ lifecycle

    def start(self, wait_ready: bool = True) -> "Fleet":
        for rep in self.replicas:
            self._spawn(rep)
        self._monitor = threading.Thread(
            target=self._health_loop, name="fm-spark-fleet-health",
            daemon=True)
        self._monitor.start()
        if wait_ready:
            self.wait_ready()
        return self

    def wait_ready(self, min_ready: "int | None" = None,
                   timeout_s: "float | None" = None) -> None:
        """Block until ``min_ready`` replicas (default: all live
        slots) pass the readiness gate."""
        deadline = time.monotonic() + (timeout_s
                                       or self.spawn_timeout_s)
        while True:
            with self._lock:
                live = [r for r in self.replicas
                        if r.state not in ("retired", "parked")]
                ready = sum(r.state == "ready" for r in live)
                want = (len(live) if min_ready is None
                        else min(min_ready, len(live)))
            if ready >= want and want > 0:
                return
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"fleet not ready: {ready}/{want} replicas after "
                    f"{self.spawn_timeout_s:.0f}s")
            time.sleep(0.05)

    def _journal(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.emit(event, **fields)

    def _spawn(self, rep: ReplicaHandle) -> None:
        port_file = os.path.join(self.work_dir,
                                 f"replica_{rep.idx}.port")
        try:
            os.unlink(port_file)
        except FileNotFoundError:
            pass
        cmd = [sys.executable, "-m", "fm_spark_tpu_torch.serve.fleet",
               "--replica-id", str(rep.idx),
               "--model", self.model_dir,
               "--port-file", port_file,
               "--bind-host", rep.spec.bind_host,
               "--buckets", self.buckets,
               "--latency-budget-ms", str(self.latency_budget_ms),
               "--journal", os.path.join(
                   self.work_dir, f"replica_{rep.idx}.jsonl")]
        if self.chain_dir:
            cmd += ["--chain-dir", self.chain_dir,
                    "--reload-poll-s", str(self.reload_poll_s)]
        if self.compile_cache_dir:
            cmd += ["--compile-cache", self.compile_cache_dir]
        if self.device is not None:
            cmd += ["--device", str(self.device)]
        if self.obs_root:
            cmd += ["--obs-dir", self.obs_root]
        env = dict(os.environ)
        # The child must import this very package even when the parent
        # runs from an arbitrary cwd.
        repo_root = os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))))
        env["PYTHONPATH"] = (repo_root + os.pathsep + env["PYTHONPATH"]
                             if env.get("PYTHONPATH") else repo_root)
        env.update(self.replica_env)
        # stderr lands next to the journal (append across
        # incarnations): a crash-looping replica must leave evidence.
        stderr_path = os.path.join(self.work_dir,
                                   f"replica_{rep.idx}.stderr")
        if rep.spec.spawn is not None:
            # The HostSpec launch hook (multi-host): whatever it
            # returns must quack like Popen (pid/poll/terminate/...).
            rep.proc = rep.spec.spawn(cmd, env, stderr_path)
        else:
            with open(stderr_path, "ab") as errf:
                rep.proc = subprocess.Popen(
                    cmd, env=env, stdout=subprocess.DEVNULL,
                    stderr=errf)
        rep.port = None
        rep.drop_pool()  # the old incarnation's sockets are dead
        rep.state = "starting"
        rep.health_failures = 0
        rep.spawned_at = time.monotonic()
        rep.incarnations += 1
        self._journal("replica_spawn", replica=rep.idx,
                      pid=rep.proc.pid,
                      incarnation=rep.incarnations)

    def _read_port(self, rep: ReplicaHandle) -> "int | None":
        path = os.path.join(self.work_dir,
                            f"replica_{rep.idx}.port")
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            return None
        # Stale port file from a previous incarnation is not ours.
        if (rep.proc is not None
                and doc.get("pid") != rep.proc.pid):
            return None
        return int(doc["port"])

    # ---------------------------------------------------- health loop

    def _health_loop(self) -> None:
        while True:
            with self._lock:
                if self._stopping:
                    return
                reps = list(self.replicas)
            for rep in reps:
                try:
                    self._check_one(rep)
                except Exception:  # noqa: BLE001 — the monitor must
                    # outlive any single replica's weirdness
                    pass
            if self.autoscaler is not None:
                try:
                    self._autoscale_tick()
                except Exception:  # noqa: BLE001 — scaling policy
                    # must never kill the health monitor
                    pass
            time.sleep(self.health_poll_s)

    def _check_one(self, rep: ReplicaHandle) -> None:
        with self._lock:
            if self._stopping or rep.state in ("retired", "parked"):
                return
            proc = rep.proc
        rc = proc.poll() if proc is not None else None
        if rc is not None:
            self._on_death(rep, rc)
            return
        if rep.port is None:
            port = self._read_port(rep)
            if port is None:
                if (time.monotonic() - rep.spawned_at
                        > self.spawn_timeout_s):
                    self._on_death(rep, None, reason="spawn_timeout")
                return
            with self._lock:
                rep.port = port
                rep.pool = ConnectionPool(rep.host, port,
                                          peer=rep.peer)
        try:
            status, doc = _http_json(rep.host, rep.port, "GET",
                                     "/healthz", timeout_s=2.0,
                                     peer=rep.peer)
        except OSError:
            status, doc = None, {}
        if status == 200:
            rep.scrape_tick += 1
            if rep.scrape_tick % 4 == 1:
                self._scrape_metrics(rep)
        with self._lock:
            was = rep.state
            if status == 200 and doc.get("ready"):
                changed = (doc.get("generation_step")
                           != rep.last_doc.get("generation_step")
                           or was != "ready")
                rep.last_doc = doc
                rep.health_failures = 0
                if was in ("starting", "suspect"):
                    rep.state = "ready"
                    self.elastic.note_success()
                    self._journal(
                        "replica_ready", replica=rep.idx,
                        incarnation=rep.incarnations,
                        generation_step=doc.get("generation_step"))
                elif changed:
                    self._journal(
                        "replica_state", replica=rep.idx,
                        state=rep.state,
                        generation_step=doc.get("generation_step"),
                        staleness_steps=doc.get("staleness_steps"))
            else:
                rep.health_failures += 1
                if (was == "ready" and rep.health_failures
                        >= SUSPECT_AFTER_FAILURES):
                    # Drain: out of the rotation until /healthz goes
                    # green again (re-admission is the same gate as
                    # first admission).
                    rep.state = "suspect"
                    self._journal("replica_drained", replica=rep.idx,
                                  health_failures=rep.health_failures,
                                  via="health")

    def _on_death(self, rep: ReplicaHandle, rc,
                  reason: str = "exited") -> None:
        with self._lock:
            if self._stopping or rep.state in ("retired", "parked"):
                return
            rep.state = "dead"
            rep.drop_pool()
            self._journal("replica_down", replica=rep.idx, rc=rc,
                          reason=reason,
                          incarnation=rep.incarnations)
            verdict = self.elastic.note_failure(
                "replica_respawn",
                f"replica {rep.idx} {reason} rc={rc}")
            if verdict == "permanent" and self.elastic.can_shrink():
                survivors = self.elastic.shrink("fleet")
                self._capacity = len(survivors)
                rep.state = "retired"
                if rep.proc is not None:
                    try:
                        rep.proc.kill()
                    except OSError:
                        pass
                self._journal("fleet_shrink", replica=rep.idx,
                              capacity=self._capacity)
                return
            live = [r for r in self.replicas
                    if r.state not in ("retired", "dead", "parked")]
            if len(live) >= self._capacity:
                # Over capacity after an elastic shrink: the dead
                # slot retires instead of respawning.
                rep.state = "retired"
                self._journal("replica_retired", replica=rep.idx)
                return
        self._spawn(rep)

    # ------------------------------------------- drain / re-admission

    def drain(self, idx: int) -> None:
        """Administratively take a replica out of the rotation (it
        keeps running; ``readmit`` or a green health check restores
        it)."""
        with self._lock:
            rep = self.replicas[idx]
            if rep.state == "ready":
                rep.state = "suspect"
                rep.health_failures = SUSPECT_AFTER_FAILURES
                self._journal("replica_drained", replica=idx,
                              health_failures=-1)

    def readmit(self, idx: int) -> None:
        with self._lock:
            rep = self.replicas[idx]
            if rep.state == "suspect":
                rep.health_failures = 0
        # The health loop re-admits on its next green poll.

    # ---------------------------------------------------- autoscaling

    def grow(self) -> "int | None":
        """Add one replica: re-spawn the first ``parked`` slot if any,
        else append a fresh slot (round-robin over host specs).
        Returns the slot index, or None while stopping."""
        with self._lock:
            if self._stopping:
                return None
            parked = [r for r in self.replicas if r.state == "parked"]
            if parked:
                rep = parked[0]
            else:
                rep = ReplicaHandle(
                    len(self.replicas),
                    spec=self.hosts[len(self.replicas)
                                    % len(self.hosts)])
                self.replicas.append(rep)
            self._capacity += 1
            capacity = self._capacity
        self._spawn(rep)
        self._journal("fleet_grow", replica=rep.idx,
                      capacity=capacity)
        return rep.idx

    def park(self) -> "int | None":
        """Shrink by one: terminate the highest-index ready replica
        and mark its slot ``parked`` — re-growable, distinct from the
        elastic controller's permanent ``retired``. Refuses to park
        the last ready replica."""
        with self._lock:
            if self._stopping:
                return None
            ready = [r for r in self.replicas if r.state == "ready"]
            if len(ready) <= 1:
                return None
            rep = max(ready, key=lambda r: r.idx)
            rep.state = "parked"
            rep.drop_pool()
            self._capacity -= 1
            capacity = self._capacity
            proc = rep.proc
        if proc is not None and proc.poll() is None:
            try:
                proc.terminate()
            except OSError:
                pass
        self._journal("replica_parked", replica=rep.idx,
                      capacity=capacity)
        return rep.idx

    def _autoscale_tick(self) -> None:
        """Feed the autoscaler one observation on the health-poll
        cadence (health thread) and apply its verdict. Pressure
        signals: the front door's closed-books shed/accepted counters
        (parent registry) and the coalescer's padded-row occupancy
        from the replicas' scraped snapshots."""
        with self._lock:
            reps = list(self.replicas)
            n_ready = sum(r.state == "ready" for r in reps)
            n_live = sum(r.state not in ("retired", "dead", "parked")
                         for r in reps)
            rows = padded = 0
            for r in reps:
                counters = ((r.metrics_doc or {})
                            .get("snapshot", {}).get("counters", {}))
                rows += int(counters.get("serve.rows_total") or 0)
                padded += int(
                    counters.get("serve.padded_rows_total") or 0)
        reg = obs.registry()
        decision = self.autoscaler.tick(
            shed_total=int(reg.peek("frontdoor.shed_total") or 0),
            accepted_total=int(
                reg.peek("frontdoor.accepted_total") or 0),
            rows_total=rows, padded_rows_total=padded,
            n_ready=n_ready, n_live=n_live)
        if decision == "grow":
            self.grow()
        elif decision == "shrink":
            self.park()

    # ------------------------------------------------------- dispatch

    def _pick(self, exclude=()) -> "ReplicaHandle | None":
        with self._lock:
            ready = [r for r in self.replicas
                     if r.state == "ready"
                     and r.idx not in exclude]
            if not ready:
                return None
            rep = ready[self._rr % len(ready)]
            self._rr += 1
            return rep

    def score(self, ids, vals, deadline: float, trace=None):
        """Dispatch one admitted request; retry ONCE on a different
        live replica if the first dies/fails mid-flight. ``trace``
        propagates cross-process: the dispatch hop gets its own span
        and the replica receives a context parented to it."""
        tried: list[int] = []
        last_error = "no ready replica"
        for attempt in (1, 2):
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError("deadline expired in dispatch")
            rep = self._pick(exclude=tried)
            if rep is None and tried:
                # Nothing else is ready: the retry may land on the
                # original (it might have merely hiccuped).
                rep = self._pick()
            if rep is None:
                raise frontdoor.BackendError("no ready replica")
            tried.append(rep.idx)
            sp = (obs.span("fleet/dispatch", trace=trace.trace_id,
                           replica=rep.idx, attempt=attempt)
                  if trace is not None else obs.NOOP_SPAN)
            try:
                with sp as dsp:
                    faults.inject("fleet_dispatch")
                    child = (trace.child(getattr(dsp, "span_id",
                                                 None))
                             if trace is not None else None)
                    status, doc = _http_json(
                        rep.host, rep.port, "POST", "/predict",
                        body={"ids": ids, "vals": vals,
                              "deadline_ms": remaining * 1e3},
                        timeout_s=remaining + 0.25,
                        trace=child, pool=rep.pool, peer=rep.peer)
            except Exception as e:  # noqa: BLE001 — connection died
                # (replica killed mid-burst) or injected dispatch
                # fault: mark suspect, retry once elsewhere
                last_error = f"{type(e).__name__}: {e}"
                retry_safe = getattr(e, "retry_safe", True)
                drained = False
                with self._lock:
                    if rep.state == "ready":
                        rep.state = "suspect"
                        rep.health_failures = SUSPECT_AFTER_FAILURES
                        drained = True
                self._journal("replica_dispatch_failed",
                              replica=rep.idx, attempt=attempt,
                              error=type(e).__name__,
                              phase=getattr(e, "phase", None),
                              retry_safe=retry_safe)
                if drained:
                    # The same drain the health poller performs, from
                    # the dispatch seam — journaled under the same
                    # event whichever path noticed the dead link first.
                    self._journal(
                        "replica_drained", replica=rep.idx,
                        health_failures=SUSPECT_AFTER_FAILURES,
                        via="dispatch")
                if not retry_safe:
                    # Response bytes had arrived when the link failed:
                    # the replica executed and answered. Replaying the
                    # request elsewhere could score it twice —
                    # exactly-once wins over availability; fail upward
                    # and let the CLIENT retry on its own books.
                    obs.counter(
                        "fleet.dispatch_recv_abandoned_total").add(1)
                    raise frontdoor.BackendError(
                        "recv-phase failure after response bytes — "
                        f"not replayed: {last_error}")
                if attempt == 1:
                    obs.counter("frontdoor.retries_total").add(1)
                continue
            if status == 200:
                doc["replica"] = rep.idx
                return doc["scores"], doc
            if status == 504:
                raise TimeoutError("replica deadline expired")
            last_error = f"replica {rep.idx} status {status}"
            if attempt == 1:
                obs.counter("frontdoor.retries_total").add(1)
        raise frontdoor.BackendError(
            f"dispatch failed after retry: {last_error}")

    # ----------------------------------------------- metrics rollup

    def _scrape_metrics(self, rep: ReplicaHandle) -> None:
        """Pull one ``/metrics.json`` doc from a healthy replica (best
        effort, off the dispatch path — runs on the health thread)."""
        try:
            status, doc = _http_json(rep.host, rep.port, "GET",
                                     "/metrics.json", timeout_s=2.0,
                                     peer=rep.peer)
        except OSError:
            return
        if status == 200 and isinstance(doc, dict):
            with self._lock:
                rep.metrics_doc = doc

    def metrics_rollup(self) -> dict:
        """The fleet-level observability rollup: last
        scraped per-replica registry snapshot + RAW histogram bucket
        counts, keyed by replica index —
        :func:`fm_spark_tpu_torch.obs.export.render_fleet_metrics` renders it
        onto the front door's ``/metrics`` with ``replica`` labels."""
        with self._lock:
            reps = {r.idx: r.metrics_doc for r in self.replicas
                    if r.metrics_doc}
        return {"replicas": reps}

    # -------------------------------------------------------- healthz

    def healthz(self) -> dict:
        with self._lock:
            docs = [r.doc() for r in self.replicas]
            live = [d for d in docs
                    if d["state"] not in ("retired", "parked")]
        return {
            "ready": any(d["state"] == "ready" for d in docs),
            "n_replicas": len(live),
            "capacity": self._capacity,
            "elastic": self.elastic.summary(),
            "replicas": docs,
        }

    # ---------------------------------------------------------- close

    def close(self) -> None:
        with self._lock:
            self._stopping = True
        if self._monitor is not None:
            self._monitor.join(timeout=10.0)
        for rep in self.replicas:
            rep.drop_pool()
        for rep in self.replicas:
            proc = rep.proc
            if proc is None or proc.poll() is not None:
                continue
            try:
                proc.terminate()
            except OSError:
                pass
        for rep in self.replicas:
            proc = rep.proc
            if proc is None:
                continue
            try:
                proc.wait(timeout=10.0)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10.0)
        self._journal("fleet_summary",
                      capacity=self._capacity,
                      elastic=self.elastic.summary(),
                      replicas=[r.doc() for r in self.replicas])


# The circular half-import: Fleet raises frontdoor.BackendError so the
# door maps it to a 503; imported late to keep module import cheap for
# the replica child (which never builds a Fleet).
from fm_spark_tpu_torch.serve import frontdoor  # noqa: E402


# ================================================== replica child main


def replica_main(argv=None) -> int:
    """One replica process: engine + read-only chain follower + HTTP
    ``/predict``, ``/healthz``, ``/metrics`` and ``/metrics.json``, its
    port announced via the atomic port file. ``/healthz`` carries the
    warm-up's ``fresh_compiles`` and ``captures`` and the engine's own
    counts (``graph_replays``, ``kernel_runs``: each kernel's runs in
    the graphs' replays, by wrapper name)."""
    import argparse

    ap = argparse.ArgumentParser(
        description="fm_spark_tpu_torch serving fleet replica")
    ap.add_argument("--replica-id", type=int, required=True)
    ap.add_argument("--model", required=True,
                    help="models.save_model directory (spec + params)")
    ap.add_argument("--port-file", required=True)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--bind-host", default="127.0.0.1",
                    help="interface the replica HTTP server binds "
                         "(HostSpec.bind_host; loopback default)")
    ap.add_argument("--chain-dir", default=None,
                    help="checkpoint chain to hot-follow (read-only)")
    ap.add_argument("--reload-poll-s", type=float, default=0.2)
    ap.add_argument("--buckets", default="1,4")
    ap.add_argument("--latency-budget-ms", type=float, default=2.0)
    ap.add_argument("--journal", default=None)
    ap.add_argument("--compile-cache", default=None)
    ap.add_argument("--nnz", type=int, default=None,
                    help="request width (default: spec.num_fields)")
    ap.add_argument("--obs-dir", default=None,
                    help="obs ROOT: the replica opens its own run dir "
                         "under it (per-process span files of the "
                         "request timeline)")
    ap.add_argument("--device", default=None,
                    help="the device this replica serves on (default: the "
                         "card; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)

    if args.obs_dir:
        obs.configure(os.path.join(args.obs_dir, obs.new_run_id()))

    from fm_spark_tpu_torch.models import load_model
    from fm_spark_tpu_torch.serve.engine import PredictEngine
    from fm_spark_tpu_torch.serve.reload import ReloadFollower
    from fm_spark_tpu_torch.utils import compile_cache

    if args.compile_cache:
        compile_cache.enable(args.compile_cache)
    else:
        compile_cache.enable_from_env()

    journal = (EventLog(args.journal) if args.journal else None)

    def jlog(event, **fields):
        if journal is not None:
            journal.emit(event, replica=args.replica_id, **fields)

    spec, params = load_model(args.model, device=args.device)
    follower = None
    buckets = tuple(sorted({int(b) for b in args.buckets.split(",")
                            if b}))
    engine = PredictEngine(
        spec, params,
        nnz=(args.nnz if args.nnz
             else getattr(spec, "num_fields", None)),
        step=0, buckets=buckets,
        latency_budget_ms=args.latency_budget_ms, device=args.device,
        journal=journal)
    del params
    if args.chain_dir:
        follower = ReloadFollower(engine, args.chain_dir,
                                  poll_s=args.reload_poll_s,
                                  journal=journal)
        # One synchronous poll BEFORE readiness: a replica that joins
        # behind an advanced chain must not serve generation 0 to its
        # first request.
        follower.poll_once()
        follower.start()
    wstats = engine.warmup()
    jlog("replica_start", pid=os.getpid(),
         generation_step=engine.generation().step,
         warmup_s=round(wstats["seconds"], 3),
         fresh_compiles=wstats["fresh_compiles"],
         captures=wstats["captures"])

    ready = threading.Event()
    reg = obs.registry()

    class Handler(http.server.BaseHTTPRequestHandler):
        server_version = "fm-spark-replica/1"
        # Keep-alive: the parent's per-replica ConnectionPool parks
        # and reuses this very connection across dispatches; HTTP/1.0
        # would close it after every reply.
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):
            pass

        def _reply(self, status, doc):
            body = _json_body(doc)
            self.send_response(status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):  # noqa: N802 — http.server API
            try:
                path = self.path.split("?", 1)[0]
                if path == "/healthz":
                    self._reply(200, {
                        "ready": ready.is_set(),
                        "replica": args.replica_id,
                        "pid": os.getpid(),
                        "generation_step": engine.generation().step,
                        "staleness_steps": reg.peek(
                            "serve/staleness_steps"),
                        "degraded": bool(reg.peek("serve/degraded")
                                         or 0),
                        "reloads": (follower.reloads
                                    if follower is not None else 0),
                        "reload_failures": (follower.failures
                                            if follower is not None
                                            else 0),
                        "fresh_compiles": wstats["fresh_compiles"],
                        "captures": wstats["captures"],
                        "graph_replays": engine.graph_replays,
                        "kernel_runs": engine.kernel_runs(),
                    })
                elif path == "/metrics":
                    body = reg.prometheus_text().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length",
                                     str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif path == "/metrics.json":
                    # The fleet parent's rollup scrape: a snapshot
                    # (counters/gauges/summaries) plus RAW histogram
                    # buckets — summaries don't aggregate across
                    # processes, bucket counts do.
                    self._reply(200, {
                        "replica": args.replica_id,
                        "pid": os.getpid(),
                        "snapshot": reg.snapshot(),
                        "buckets": reg.bucket_snapshot(),
                    })
                else:
                    self.send_error(
                        404, "want /healthz, /metrics, "
                             "/metrics.json or /predict")
            except Exception:  # noqa: BLE001 — scrape socket died
                pass

        def do_POST(self):  # noqa: N802 — http.server API
            try:
                if self.path.split("?", 1)[0] != "/predict":
                    self.send_error(404, "want /predict")
                    return
                # The kill-mid-burst drill point: an ``exit`` action
                # here is os._exit — the parent sees this very
                # connection die and must answer the request exactly
                # once elsewhere.
                faults.inject("replica_kill")
                n = int(self.headers.get("Content-Length") or 0)
                req = json.loads(self.rfile.read(n).decode() or "{}")
                # Junk/absent header -> None -> the untraced path;
                # an untrusted peer never crashes the request.
                ctx = obs.TraceContext.from_header(
                    self.headers.get(obs.TRACE_HEADER))
                dl_ms = req.get("deadline_ms")
                deadline = (time.monotonic() + float(dl_ms) / 1e3
                            if dl_ms is not None else None)
                sp = (obs.span("replica/handle",
                               trace=ctx.trace_id,
                               remote_parent=ctx.parent_span_id,
                               replica=args.replica_id)
                      if ctx is not None else obs.NOOP_SPAN)
                with sp as hsp:
                    child = (ctx.child(getattr(hsp, "span_id", None))
                             if ctx is not None else None)
                    fut = engine.submit(req["ids"], req["vals"],
                                        deadline=deadline,
                                        trace=child)
                    wait = (max(deadline - time.monotonic(), 0.001)
                            if deadline is not None else 30.0)
                    try:
                        out = fut.result(wait)
                    except TimeoutError:
                        self._reply(504,
                                    {"error": "deadline expired"})
                        return
                doc = {
                    "scores": [float(x) for x in out],
                    "generation_step": engine.generation().step,
                    "replica": args.replica_id,
                }
                if ctx is not None:
                    doc["trace"] = ctx.trace_id
                self._reply(200, doc)
            except Exception as e:  # noqa: BLE001 — answer the
                # client explicitly (injected faults land here too);
                # a broken reply socket is the parent's signal
                try:
                    self._reply(500, {"error": type(e).__name__})
                except Exception:
                    pass

    class Server(socketserver.ThreadingMixIn, http.server.HTTPServer):
        daemon_threads = True
        request_queue_size = 128

    server = Server((args.bind_host, args.port), Handler)
    stop = threading.Event()

    def on_term(signum, frame):
        stop.set()

    signal.signal(signal.SIGTERM, on_term)
    serve_thread = threading.Thread(
        target=server.serve_forever, name="fm-spark-replica-http",
        daemon=True)
    serve_thread.start()
    _write_port_file(args.port_file, server.server_address[1])
    ready.set()
    jlog("replica_ready", port=server.server_address[1],
         generation_step=engine.generation().step)
    try:
        while not stop.wait(0.2):
            pass
    finally:
        ready.clear()
        server.shutdown()
        server.server_close()
        if follower is not None:
            follower.stop()
        engine.close()
        jlog("replica_stop", reason="sigterm",
             graph_replays=engine.graph_replays,
             kernel_runs=engine.kernel_runs())
        if args.obs_dir:
            obs.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(replica_main())
