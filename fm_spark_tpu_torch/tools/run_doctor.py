"""Automated run doctor over the port's run dirs (the port of
``tools/run_doctor.py``): attribute where a run's time went and why.

Given a per-run telemetry directory (``artifacts/obs/<run_id>/``), the
doctor turns the run's streams into ONE screen a human can act on:

- **Where the time went** — the compile-vs-execute split (bench legs:
  leg-span wall minus the ledger's timed window; train runs: a
  ``compile_split`` first-step fence where one is journaled), ingest
  busy time (from the rows/sec gauge + row counters), fault/backoff
  wall (the resilience spans), eval, and the unattributed remainder —
  each as a share of the observed wall-clock;
- **Per-leg verdicts** — every ``bench_leg`` ledger record for this
  run: variant, rate, the sentinel verdict, attachment health, memory
  peak, and the degraded/fused_fallback stamps (the port's ledger
  carries none until the port's benchmark writes them; the section
  says so);
- **Fault timeline** — event-kind counts plus total backoff seconds;
- **Serving** — request/batch latency percentiles, the
  ``serve_bench`` ledger rows with their sentinel verdicts, the
  reload/swap timeline, staleness + degraded-mode state, and the
  chaos auditor's serving-invariant verdict (the port's
  ``resilience/chaos_audit.py``, loaded by path);
- **Continuous learning** — the ``quality_eval`` AUC series with
  sentinel verdicts, the drift timeline (alarms, demotions, rollbacks,
  pointer republishes), and the rollback/quarantined-generation
  counters;
- **Static analysis** — the run's ``fmlint.json`` report (written by
  ``python -m fm_spark_tpu_torch.tools.fmlint --run-id <id>`` into the
  same run dir): per-rule finding counts, unbaselined findings,
  reasoned suppressions, and the baseline burn-down;
- **Request tracing** — the top-k slowest distributed traces merged
  from every process's span file under the obs root, with each trace's
  dominant hop named and torn/incomplete traces flagged
  (:mod:`.trace_report`);
- **Storage health** — the durable-write seam's failure counters by
  path class, the ``obs/io_degraded`` gauge + swallowed-failure window,
  the checkpoint tier's retry/backoff table and ENOSPC emergency-GC
  events, and the io-fault timeline (rendered only for runs that hit
  the fault surface);
- **Deep captures** — the run's trigger-fired bundles
  (``captures/<trigger>_<seq>/``) and, with ``--profile DIR``, the
  ``fmtorch train --profile DIR`` trace as a bundle of its own: the
  card's kernels by symbol, their runs and device milliseconds;
- **Cost attribution** — ``cost_attribution`` ledger rows;
- **Diagnosis** — the doctor's findings.

The ledger is found beside the run dir by default
(``<run_dir>/../ledger_torch.jsonl``, the port's ledger file) or via
``--ledger``.

Usage::

    python -m fm_spark_tpu_torch.tools.run_doctor artifacts/obs/<run_id>/
    python -m fm_spark_tpu_torch.tools.run_doctor --latest [obs_root]
    python -m fm_spark_tpu_torch.tools.run_doctor --run-id <id> [obs_root]
    ... [--ledger PATH] [--profile DIR]

``--run-id`` selects a run by name — ``--latest`` picks by mtime, which
is wrong while a serve daemon keeps its own run directory hot.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

from fm_spark_tpu_torch.obs.ledger import LEDGER_FILE, PerfLedger
from fm_spark_tpu_torch.tools import obs_report, trace_report

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: The port's serving-invariant auditor, import-free by design and loaded
#: by path (``fm_spark_tpu_torch/resilience/chaos_audit.py``).
CHAOS_AUDIT_PATH = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "resilience", "chaos_audit.py")


def _load_file(path, modname):
    """Standalone by-path module load (register in sys.modules BEFORE
    exec — dataclass processing looks the module up there)."""
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def _span_totals(spans: list[dict]) -> dict:
    out: dict[str, float] = {}
    for s in spans:
        out[s.get("name", "?")] = (out.get(s.get("name", "?"), 0.0)
                                   + float(s.get("dur_ms") or 0.0) / 1e3)
    return out


def _leg_rows(ledger_path: str, run_id: str) -> list[dict]:
    """This run's bench_leg ledger records."""
    return PerfLedger(ledger_path).records(kind="bench_leg", run_id=run_id)


def _serve_rows(ledger_path: str, run_id: str) -> list[dict]:
    """This run's serve_bench ledger records."""
    return PerfLedger(ledger_path).records(kind="serve_bench", run_id=run_id)


def _quality_rows(ledger_path: str, run_id: str) -> list[dict]:
    """This run's quality_eval ledger records: the online
    loop's day-over-day AUC series."""
    return PerfLedger(ledger_path).records(kind="quality_eval", run_id=run_id)


def _embed_rows(ledger_path: str, run_id: str) -> list[dict]:
    """This run's embed_bench ledger records: the tiered
    embedding store's ladder rungs."""
    return PerfLedger(ledger_path).records(kind="embed_bench", run_id=run_id)


def embed_diagnose(run: dict, embed_rows: list[dict]) -> dict | None:
    """The tiered-embedding view of a run: hot-tier hit
    rate / eviction / blocking-stall gauges plus this run's
    ``embed_bench`` ladder rungs. ``None`` when the run has no
    embedding-tier footprint (the gauges only exist once a
    TieredStore served a batch)."""
    snap = run.get("snapshot") or {}
    gauges = snap.get("gauges") or {}
    has_embed = bool(embed_rows or "embed/hit_rate" in gauges)
    if not has_embed:
        return None
    return {
        "hit_rate": gauges.get("embed/hit_rate"),
        "evictions": gauges.get("embed/evictions"),
        "stall_ms": gauges.get("embed/stall_ms"),
        "rows": embed_rows,
    }


def embed_findings(embed: dict | None) -> list[str]:
    if embed is None:
        return []
    out = []
    hr = embed.get("hit_rate")
    if hr is not None and hr < 0.5:
        out.append(
            f"embed-tier hit rate {hr:.3f} — the hot tier is thrashing "
            "(working set or drift outruns capacity); raise --hot-rows "
            "or shrink --embed-bucket-rows")
    stall = embed.get("stall_ms")
    if stall is not None and stall > 0:
        out.append(
            f"embed-tier blocking stalls {stall:.1f} ms — misses the "
            "prefetcher did not hide (counted, never hidden); deepen "
            "--prefetch or slow the working-set drift")
    for r in embed.get("rows") or []:
        if r.get("parity_ok") is False:
            out.append(
                f"embed_bench {r.get('leg')}: tiered/untiered parity "
                "FAILED — the merged view diverged from the in-memory "
                "trajectory (file this; never bench over it)")
        v = (r.get("sentinel") or {}).get("verdict")
        if v == "regressed":
            out.append(
                f"embed_bench {r.get('leg')}: sentinel verdict "
                "regressed vs its own tiered cohort")
    return out


# The durable-seam event kinds: the obs-tier swallowed
# failure, the checkpoint tier's bounded retry / ENOSPC emergency GC /
# loud give-up.
_STORAGE_KINDS = ("io_write_failed", "ckpt_io_retry",
                  "ckpt_emergency_gc", "ckpt_emergency_gc_done",
                  "checkpoint_io_error")


def storage_diagnose(run: dict, flight_events: list[dict]) -> dict | None:
    """The storage-health view of a run: the durable-write
    seam's failure counters by path class, the ``obs/io_degraded``
    gauge, the checkpoint tier's retry/backoff and emergency-GC
    evidence, and the io-fault event timeline. ``None`` when the run
    never hit the fault surface (counters/gauge unset, no io events) —
    a healthy disk renders no section."""
    snap = run.get("snapshot") or {}
    gauges = snap.get("gauges") or {}
    counters = snap.get("counters") or {}
    events = [e for e in flight_events
              if str(e.get("kind", "")) in _STORAGE_KINDS]
    write_failed = counters.get("io.write_failed_total") or 0
    retries = counters.get("checkpoint.io_retries_total") or 0
    gcs = counters.get("checkpoint.emergency_gc_total") or 0
    degraded = gauges.get("obs/io_degraded")
    if not (events or write_failed or retries or gcs or degraded):
        return None
    prefix = "io.write_failed."
    by_class = {k[len(prefix):-len("_total")]: v
                for k, v in sorted(counters.items())
                if k.startswith(prefix) and k.endswith("_total")}
    # Degraded-obs window: the span of swallowed best-effort failures —
    # the stretch of this run whose telemetry has holes on disk.
    besteff = [e for e in events if e.get("kind") == "io_write_failed"
               and e.get("best_effort")]
    window = None
    if besteff:
        ts = [float(e.get("ts") or 0.0) for e in besteff]
        window = {"first_ts": min(ts), "last_ts": max(ts),
                  "n": len(besteff)}
    return {
        "degraded": degraded,
        "write_failed_total": write_failed,
        "by_class": by_class,
        "retries": retries,
        "retry_rows": [e for e in events
                       if e.get("kind") == "ckpt_io_retry"],
        "emergency_gcs": gcs,
        "gc_rows": [e for e in events
                    if e.get("kind") == "ckpt_emergency_gc"],
        "io_errors": [e for e in events
                      if e.get("kind") == "checkpoint_io_error"],
        "degraded_window": window,
        "events": events,
    }


def storage_findings(storage: dict | None) -> list[str]:
    """Storage-health one-liners for the diagnosis section."""
    if storage is None:
        return []
    out = []
    for e in storage["io_errors"]:
        out.append(
            f"CHECKPOINT IO ERROR: durable write of {e.get('path')} "
            f"failed loud (errno {e.get('errno')}) after bounded "
            "retries/emergency GC — the chain stopped advancing; fix "
            "the disk, then resume from last_good")
    if storage["degraded"] or storage["degraded_window"]:
        w = storage["degraded_window"] or {}
        out.append(
            f"DISK_DEGRADED: {w.get('n', '?')} obs-tier write "
            "failure(s) swallowed (obs/io_degraded gauge set) — the "
            "telemetry record on disk has holes; training/serving "
            "bytes are unaffected by design (best-effort tier)")
    if storage["emergency_gcs"]:
        steps = sorted({s for e in storage["gc_rows"]
                        for s in (e.get("steps") or [])})
        out.append(
            f"{storage['emergency_gcs']:.0f} ENOSPC emergency GC "
            f"pass(es) collected demoted generation(s) {steps} — "
            "journaled before deletion; last_good never a candidate")
    if storage["retries"] and not storage["io_errors"]:
        out.append(
            f"transient disk errors absorbed: "
            f"{storage['retries']:.0f} bounded checkpoint "
            "retry/backoff(s), chain committed")
    return out


def _cost_rows(ledger_path: str, run_id: str) -> list[dict]:
    """This run's cost_attribution ledger records: measured
    step time paired with the bytes-moved model per leg/kernel."""
    return PerfLedger(ledger_path).records(kind="cost_attribution", run_id=run_id)


def online_diagnose(run: dict, timeline: list[dict],
                    quality_rows: list[dict]) -> dict | None:
    """The continuous-learning view of a run: the AUC/
    drift-score gauges, rollback/demotion counters, and the drift
    event timeline (pre-deduped by ``obs_report.online_timeline`` —
    a journaled event and its flight-ring mirror are the same
    transition). ``None`` when the run has no online footprint."""
    snap = run.get("snapshot") or {}
    gauges = snap.get("gauges") or {}
    counters = snap.get("counters") or {}
    events = timeline
    # A genuine ONLINE footprint is required — a plain offline run's
    # divergence_detected (loss-spike guard) rides the same timeline
    # helper but must not conjure a Continuous-learning section.
    has_online = bool(
        quality_rows or counters.get("online.days_total")
        or any(str(e.get("kind", "")).startswith(("online_",
                                                  "quality_eval"))
               for e in events))
    if not has_online:
        return None
    return {
        "auc": gauges.get("online/auc"),
        "drift_score": gauges.get("online/drift_score"),
        "quarantined": gauges.get(
            "checkpoint/quarantined_generations") or 0,
        "days": counters.get("online.days_total") or 0,
        "rollbacks": counters.get("online.rollbacks_total") or 0,
        "demotions": counters.get("checkpoint.demotions_total") or 0,
        "events": events,
        "quality_rows": quality_rows,
    }


def online_findings(online: dict | None) -> list[str]:
    """Continuous-learning one-liners for the diagnosis section."""
    if online is None:
        return []
    out = []
    if online["rollbacks"]:
        out.append(
            f"DRIFT ROLLBACK: {online['rollbacks']:.0f} coordinated "
            f"rollback(s), {online['demotions']:.0f} generation(s) "
            "demoted — the chain's tombstoned saves will never serve; "
            "check the eval-day AUC series for when the world moved")
    elif online["quarantined"]:
        out.append(
            f"{online['quarantined']:.0f} quarantined generation(s) "
            "in the chain (tombstoned by an earlier run)")
    regressed = [r for r in online["quality_rows"]
                 if (r.get("sentinel") or {}).get("verdict")
                 == "regressed"]
    if regressed:
        out.append(
            f"QUALITY REGRESSED: eval AUC {regressed[-1].get('value')}"
            f" on day {regressed[-1].get('day')} — "
            f"{(regressed[-1].get('sentinel') or {}).get('reason')}")
    if not out and online["days"]:
        out.append(
            f"online learning clean: {online['days']:.0f} day(s) "
            f"trained, AUC {online['auc']}, no drift verdicts")
    return out


def serve_diagnose(run: dict, timeline: list[dict],
                   serve_legs: list[dict]) -> dict | None:
    """The serving view of a run: latency percentiles from
    the serve histograms, the reload/swap timeline (pre-deduped by
    ``obs_report.serve_timeline``), staleness and degraded-mode state,
    and the chaos auditor's serving-invariant verdict over the
    observed event stream. ``None`` when the run has no serving
    footprint."""
    snap = run.get("snapshot") or {}
    hists = {k: v for k, v in (snap.get("histograms") or {}).items()
             if k.startswith("serve/")}
    gauges = snap.get("gauges") or {}
    counters = snap.get("counters") or {}
    if not (hists or timeline or serve_legs):
        return None
    # Standalone by-path load of the port's auditor (import-free by
    # design).
    audit = _load_file(CHAOS_AUDIT_PATH, "_doctor_torch_chaos_audit")

    staleness = gauges.get("serve/staleness_steps")
    # Staleness here is an OBSERVATION, not an invariant verdict: a
    # server that exits mid-stream is honestly behind the tip, and
    # only a drill (which knows recovery completed) may hold a bound
    # against it — so the doctor reports it as a finding below and
    # audits the event stream for torn swaps only.
    violations = audit.audit_serve_events(timeline)
    return {
        "histograms": hists,
        "timeline": timeline,
        "staleness_steps": staleness,
        "degraded": bool(gauges.get("serve/degraded") or 0),
        "swaps": counters.get("serve.swaps_total") or 0,
        "reload_failures": counters.get(
            "serve.reload_failures_total") or 0,
        "requests": counters.get("serve.requests_total") or 0,
        "batches": counters.get("serve.batches_total") or 0,
        "violations": violations,
    }


def serve_findings(serve: dict | None, serve_legs: list[dict]
                   ) -> list[str]:
    """Serving one-liners for the diagnosis section."""
    if serve is None:
        return []
    out = []
    for v in serve["violations"]:
        out.append(f"SERVE INVARIANT VIOLATED — {v['invariant']}: "
                   f"{v['detail']}")
    if serve["degraded"]:
        out.append(
            "serving DEGRADED: the last reload attempt failed "
            f"({serve['reload_failures']:.0f} failure(s)) — the old "
            "generation keeps serving; check the chain")
    elif serve["staleness_steps"]:
        out.append(
            f"serving stale: {serve['staleness_steps']:.0f} step(s) "
            "behind the published chain tip")
    for r in serve_legs:
        v = (r.get("sentinel") or {}).get("verdict")
        if v == "regressed":
            out.append(
                f"SERVING REGRESSED: {r.get('leg')} at "
                f"{r.get('value'):,.0f} rows/s — "
                f"{(r.get('sentinel') or {}).get('reason')}")
    if not out and (serve["requests"] or serve_legs):
        out.append(
            f"serving clean: {serve['requests']:.0f} request(s) in "
            f"{serve['batches']:.0f} micro-batch(es), "
            f"{serve['swaps']:.0f} hot swap(s), staleness "
            f"{serve['staleness_steps'] or 0:.0f}")
    return out


def fleet_diagnose(run: dict, fleet_events: list[dict]
                   ) -> dict | None:
    """The serving-fleet view of a run: per-replica
    lifecycle/generation state from the fleet health journal
    (``fleet_health.jsonl``), the front door's admission accounting
    (its ``frontdoor_summary`` journal event, falling back to the
    snapshot's ``frontdoor.*`` counters), and the replica-loss ->
    recovery timeline (each ``replica_down`` paired with that
    replica's next ``replica_ready``). ``None`` when the run has no
    fleet footprint.

    Each replica loss is CLASSIFIED — a
    ``replica_drained`` healed by ``replica_ready`` with no
    ``replica_down`` between is a PARTITION (the link failed, the
    process lived; collected under ``partitions``), while a
    ``replica_down`` -> ``replica_ready`` pair is a crash+respawn
    (``recoveries``, as before) — and the autoscaler's journaled
    ``autoscale_decision`` events roll up under ``autoscale``
    (decision log, grow/shrink counts, direction changes)."""
    snap = run.get("snapshot") or {}
    snap_counters = snap.get("counters") or {}
    has_fd = any(k.startswith("frontdoor.")
                 for k in snap_counters)
    if not fleet_events and not has_fd:
        return None
    stats = None
    replicas: dict[int, dict] = {}
    recoveries: list[dict] = []
    partitions: list[dict] = []
    decisions: list[dict] = []
    for e in fleet_events:
        kind = e.get("event") or e.get("kind")
        rep = e.get("replica")
        r = None
        if rep is not None:
            r = replicas.setdefault(int(rep), {
                "replica": int(rep), "spawns": 0, "downs": 0,
                "drains": 0, "state": "?", "generation_step": None,
                "staleness_steps": None, "last_rc": None,
                "_down_ts": None, "_drain_ts": None})
        if kind == "replica_spawn" and r is not None:
            r["spawns"] += 1
            r["state"] = "starting"
        elif kind == "replica_ready" and r is not None:
            r["state"] = "ready"
            if r.get("generation_step") is None:
                r["generation_step"] = e.get("generation_step")
            if r["_down_ts"] is not None and e.get("ts") is not None:
                recoveries.append({
                    "replica": int(rep), "down_ts": r["_down_ts"],
                    "rc": r["last_rc"],
                    "recovery_s": round(e["ts"] - r["_down_ts"], 3)})
                r["_down_ts"] = None
            elif (r["_drain_ts"] is not None
                    and e.get("ts") is not None):
                # Drained then readmitted with NO death between: the
                # loss was a parent<->replica LINK failure, not a
                # crash.
                partitions.append({
                    "replica": int(rep),
                    "drain_ts": r["_drain_ts"],
                    "heal_s": round(e["ts"] - r["_drain_ts"], 3)})
            r["_drain_ts"] = None
        elif kind == "replica_state" and r is not None:
            if e.get("generation_step") is not None:
                r["generation_step"] = e["generation_step"]
            if e.get("staleness_steps") is not None:
                r["staleness_steps"] = e["staleness_steps"]
        elif kind == "replica_down" and r is not None:
            r["downs"] += 1
            r["state"] = "dead"
            r["last_rc"] = e.get("rc")
            if e.get("ts") is not None:
                r["_down_ts"] = e["ts"]
            r["_drain_ts"] = None  # it died: a crash, not a partition
        elif kind == "replica_drained" and r is not None:
            r["state"] = "suspect"
            r["drains"] += 1
            if r["_drain_ts"] is None:
                r["_drain_ts"] = e.get("ts")
        elif kind == "replica_parked" and r is not None:
            r["state"] = "parked"
        elif kind in ("fleet_shrink", "replica_retired"):
            if r is not None:
                r["state"] = "retired"
        elif kind == "autoscale_decision":
            decisions.append({k: e.get(k) for k in
                              ("ts", "action", "reason", "tick",
                               "n_ready", "to_n", "shed_frac",
                               "fill")})
        elif kind == "frontdoor_summary":
            stats = e  # the door's closing books (flattened stats())
    if stats is None and has_fd:
        stats = {k.split(".", 1)[1].rsplit("_total", 1)[0]: v
                 for k, v in snap_counters.items()
                 if k.startswith("frontdoor.") and k.count(".") == 1}
    counters = {k: int((stats or {}).get(k) or 0)
                for k in ("accepted", "answered", "shed",
                          "shed_queue", "shed_deadline", "rejected",
                          "timeout", "failed", "retries")}
    for r in replicas.values():
        r.pop("_down_ts", None)
        r.pop("_drain_ts", None)
    gens = [r["generation_step"] for r in replicas.values()
            if r["generation_step"] is not None
            and r["state"] == "ready"]
    actions = [d.get("action") for d in decisions]
    return {
        "replicas": [replicas[i] for i in sorted(replicas)],
        "counters": counters,
        "recoveries": recoveries,
        "partitions": partitions,
        "autoscale": {
            "decisions": decisions,
            "grows": actions.count("grow"),
            "shrinks": actions.count("shrink"),
            "direction_changes": sum(
                1 for a, b in zip(actions, actions[1:]) if a != b),
        },
        "generation_skew": (max(gens) - min(gens)) if gens else 0,
    }


def fleet_findings(fleet: dict | None) -> list[str]:
    """Serving-fleet one-liners for the diagnosis section."""
    if fleet is None:
        return []
    out = []
    c = fleet["counters"]
    offered = c["accepted"] + c["shed"] + c["rejected"]
    if c["shed"] and offered and c["shed"] / offered > 0.25:
        out.append(
            f"FRONT DOOR SHEDDING {c['shed'] / offered:.0%} of "
            f"offered load ({c['shed']} of {offered}) — unbounded "
            "shed growth means the fleet is undersized for the "
            "offered SLO (add replicas or loosen deadlines)")
    if fleet["generation_skew"] > 0:
        out.append(
            f"GENERATION SKEW across ready replicas: "
            f"{fleet['generation_skew']} step(s) — identical "
            "requests score differently depending on the replica "
            "drawn; check the lagging replica's reload journal")
    closed = c["answered"] + c["timeout"] + c["failed"]
    if c["accepted"] != closed:
        out.append(
            f"FLEET BOOKS OPEN: accepted={c['accepted']} but "
            f"answered+timeout+failed={closed} — admitted request(s) "
            "without a terminal outcome")
    for rec in fleet["recoveries"]:
        out.append(
            f"replica {rec['replica']} lost (rc={rec['rc']}) and "
            f"re-admitted after {rec['recovery_s']:.3f}s — CRASH "
            "(process died, respawned)")
    for p in fleet.get("partitions", []):
        out.append(
            f"replica {p['replica']} PARTITIONED (drained with no "
            f"process death) and readmitted after "
            f"{p['heal_s']:.3f}s — link fault, not a crash; no "
            "respawn was spent on it")
    auto = fleet.get("autoscale") or {}
    if auto.get("decisions"):
        out.append(
            f"autoscaler: {auto['grows']} grow / {auto['shrinks']} "
            f"shrink decision(s), {auto['direction_changes']} "
            "direction change(s)")
        if auto["direction_changes"] > 1:
            out.append(
                "AUTOSCALER FLAPPING: more than one grow<->shrink "
                "reversal — widen the hysteresis dead band or "
                "lengthen the cooldown")
    flapping = [r for r in fleet["replicas"] if r["downs"] >= 3]
    for r in flapping:
        out.append(
            f"replica {r['replica']} CRASH-LOOPING: {r['downs']} "
            f"death(s) over {r['spawns']} spawn(s) — check "
            "fleet/replica_*.stderr")
    if not out and (c["accepted"] or fleet["replicas"]):
        out.append(
            f"fleet clean: {c['accepted']} accepted / "
            f"{c['answered']} answered, {c['shed']} shed, "
            f"{c['retries']} retried, {len(fleet['replicas'])} "
            "replica(s)")
    return out


def tracing_diagnose(obs_dir: str) -> dict | None:
    """The distributed-tracing view of a run: merge every
    process's span file under the shared obs ROOT (the run dir's
    parent — front door, fleet parent, replicas and the client each
    keep their own run dir there), rank traces by end-to-end wall,
    and name the dominant hop of each. ``None`` when nothing under
    the root carries a ``trace`` id."""
    tr = trace_report
    root = os.path.dirname(os.path.normpath(obs_dir))
    merged = tr.merge(root)
    if not merged:
        return None
    ranked = sorted(merged.values(), key=lambda t: -t["total_ms"])
    rows = []
    for t in ranked[:5]:
        bd = tr.breakdown(t)
        rows.append({
            "trace_id": t["trace_id"], "total_ms": t["total_ms"],
            "hops": t["hops"], "pids": len(t["pids"]),
            "dominant": bd.get("dominant"),
            "incomplete": t["incomplete"],
        })
    ex = tr.tail_exemplar(root)
    if ex is not None:
        ex = dict(ex)
        ex["resolved"] = ex["trace_id"] in merged
    return {
        "n_traces": len(merged),
        "incomplete": sum(t["incomplete"] for t in merged.values()),
        "top": rows,
        "exemplar": ex,
        "root": root,
    }


def tracing_findings(tracing: dict | None) -> list[str]:
    """Distributed-tracing one-liners for the diagnosis section."""
    if tracing is None:
        return []
    out = []
    if tracing["top"]:
        t = tracing["top"][0]
        out.append(
            f"slowest trace {t['trace_id']}: {t['total_ms']:.2f} ms "
            f"end-to-end across {t['pids']} process(es) — dominant "
            f"hop {t['dominant'] or '?'}")
    if tracing["incomplete"]:
        out.append(
            f"{tracing['incomplete']} of {tracing['n_traces']} "
            "trace(s) INCOMPLETE (torn span file, or a replica lost "
            "mid-request) — the surviving hops still render; "
            "python -m fm_spark_tpu_torch.tools.trace_report <root> "
            "--trace <id> shows the hole")
    ex = tracing.get("exemplar")
    if ex is not None and not ex["resolved"]:
        out.append(
            f"tail exemplar trace {ex['trace_id']} does NOT resolve "
            "to a merged trace — a process's trace.jsonl is missing "
            "from the obs root (sampled out, or the writer died "
            "before its first flush)")
    return out


def diagnose(run: dict, legs: list[dict],
             flight_events: list[dict]) -> dict:
    """The attribution numbers (testable separately from rendering)."""
    spans = run["spans"]
    totals = _span_totals(spans)
    starts = [s["t_start"] for s in spans
              if s.get("t_start") is not None]
    ends = [s["t_start"] + float(s.get("dur_ms") or 0.0) / 1e3
            for s in spans if s.get("t_start") is not None]
    wall = (max(ends) - min(starts)) if starts else 0.0

    # Bench legs: span wall minus the ledger's timed window is the
    # compile + warmup (+ retry) share of that leg.
    timed_by_label = {r.get("variant"): float(r.get("dt_s") or 0.0)
                      for r in legs}
    leg_span_s = 0.0
    leg_timed_s = 0.0
    for s in spans:
        if s.get("name") != "bench/leg":
            continue
        dur = float(s.get("dur_ms") or 0.0) / 1e3
        leg_span_s += dur
        leg_timed_s += min(timed_by_label.get(s.get("label"), 0.0), dur)

    # Train runs: the first-step fence records the compile directly.
    compile_events = [e for e in flight_events
                      if e.get("kind") == "compile_split"]
    fence_compile_s = sum(float(e.get("first_step_ms") or 0.0) / 1e3
                          for e in compile_events)
    fresh_compiles = sum(int(e.get("fresh_compiles") or 0)
                         for e in compile_events)

    compile_s = max(leg_span_s - leg_timed_s, 0.0) + fence_compile_s
    execute_s = leg_timed_s + totals.get("train/steps", 0.0)
    fault_s = (totals.get("resilience/backoff", 0.0)
               + totals.get("resilience/probe", 0.0))
    eval_s = totals.get("train/eval", 0.0)

    snap = run.get("snapshot") or {}
    counters = snap.get("counters") or {}
    gauges = snap.get("gauges") or {}
    rows_ok = counters.get("ingest.rows_ok_total") or 0.0
    rate = gauges.get("ingest.rows_per_sec")
    ingest_s = (rows_ok / rate) if rate else 0.0

    attributed = compile_s + execute_s + fault_s + eval_s
    other_s = max(wall - attributed, 0.0)

    timeline = run["timeline"]
    kinds: dict[str, int] = {}
    for e in timeline:
        kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1

    return {
        "wall_s": wall,
        "phases": {
            "compile+warmup": compile_s,
            "execute": execute_s,
            "faults/backoff": fault_s,
            "eval": eval_s,
            "other": other_s,
        },
        "ingest_busy_s": ingest_s,
        "fresh_compiles": fresh_compiles,
        "fault_kinds": kinds,
        "backoff_s": totals.get("resilience/backoff", 0.0),
    }


def load_chaos_verdict(obs_dir: str) -> dict | None:
    """The run's chaos-campaign verdict (``chaos_verdict.json``,
    written by :mod:`.chaos_drill`), if this run dir holds one."""
    path = os.path.join(obs_dir, "chaos_verdict.json")
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def chaos_findings(chaos: dict | None) -> list[str]:
    """Chaos-verdict one-liners for the diagnosis section."""
    if not chaos:
        return []
    out = []
    if chaos.get("all_green"):
        out.append(
            f"chaos campaign green: {chaos.get('n_green')} seeded "
            "schedule(s), every invariant held "
            f"({chaos.get('total_s', 0):.1f}s)")
        return out
    for f in chaos.get("failures", []):
        inv = ", ".join(sorted({v["invariant"]
                                for v in f.get("violations", [])}))
        line = (f"CHAOS: seed {f.get('seed')} "
                f"({f.get('scenario')}) violated [{inv}]")
        if f.get("minimized_plan"):
            line += (f" — minimized repro "
                     f"FM_SPARK_FAULTS='{f['minimized_plan']}'")
        out.append(line)
    if chaos.get("budget_exhausted"):
        out.append(
            f"chaos campaign ran out of budget: "
            f"{chaos.get('n_skipped', 0)} schedule(s) skipped")
    return out


def load_fmlint_report(obs_dir: str) -> dict | None:
    """The run's static-analysis report (``fmlint.json``, written by
    :mod:`.fmlint`), if this run dir holds one."""
    path = os.path.join(obs_dir, "fmlint.json")
    try:
        with open(path) as f:
            doc = json.load(f)
        return doc if isinstance(doc, dict) else None
    except (OSError, ValueError):
        return None


def fmlint_findings(rep: dict | None) -> list[str]:
    """Static-analysis one-liners for the diagnosis section — analysis
    regressions render next to perf ones."""
    if not rep:
        return []
    out = []
    new = rep.get("new") or []
    if new:
        out.append(
            f"STATIC ANALYSIS: {len(new)} unbaselined finding(s) — "
            "the build is red until fixed, suppressed with a reason, "
            "or baselined")
        for f in new[:5]:
            out.append(f"  fmlint {f.get('rule')}: {f.get('path')}:"
                       f"{f.get('line')} {f.get('message', '')[:90]}")
    elif rep.get("baselined_total"):
        out.append(
            f"fmlint: clean vs baseline, {rep['baselined_total']} "
            "baselined finding(s) still burning down")
    else:
        out.append("fmlint: clean — zero findings beyond reasoned "
                   "suppressions")
    if rep.get("burned_down"):
        out.append(
            f"fmlint baseline burn-down: {len(rep['burned_down'])} "
            "(rule, file) cell(s) below budget — run python -m "
            "fm_spark_tpu_torch.tools.fmlint --write-baseline to lock "
            "the progress in")
    return out


def render_fmlint(rep: dict | None) -> list[str]:
    """The Static-analysis section lines ('' terminated), or []."""
    if not rep:
        return []
    counts = rep.get("counts") or {}
    out = [f"## Static analysis (fmlint — "
           f"{len(rep.get('rules') or {})} rule(s), "
           f"{'OK' if rep.get('ok') else 'FAILING'})"]
    total = rep.get("total_findings", 0)
    out.append(f"  findings {total}  new {len(rep.get('new') or [])}  "
               f"baselined {rep.get('baselined_total', 0)}  "
               f"suppressed {len(rep.get('suppressed') or [])}  "
               f"burned-down {len(rep.get('burned_down') or [])}")
    for rule_id in sorted(counts):
        files = counts[rule_id]
        out.append(f"  {rule_id:24} {sum(files.values()):>4}  "
                   f"in {len(files)} file(s)")
    for f in (rep.get("new") or [])[:10]:
        out.append(f"  NEW {f.get('path')}:{f.get('line')} "
                   f"[{f.get('rule')}] {f.get('message', '')[:80]}")
    out.append("")
    return out


def findings(diag: dict, legs: list[dict]) -> list[str]:
    """The doctor's opinionated one-liners."""
    out = []
    wall = diag["wall_s"] or 1e-9
    ph = diag["phases"]
    if ph["compile+warmup"] / wall > 0.30:
        fresh = (f" ({diag['fresh_compiles']} fresh compiles)"
                 if diag["fresh_compiles"] else "")
        out.append(
            f"compile-dominated: {ph['compile+warmup'] / wall:.0%} of "
            f"wall-clock in compile/warmup{fresh} — warm the "
            "persistent cache (--compile-cache)")
    if ph["faults/backoff"] / wall > 0.10 or diag["fault_kinds"].get(
            "circuit_open") or diag["fault_kinds"].get("permanent_fault"):
        out.append(
            "attachment weather: "
            f"{diag['fault_kinds'].get('failure', 0)} failure(s), "
            f"{diag['backoff_s']:.1f}s in backoff"
            + (", circuit opened"
               if diag["fault_kinds"].get("circuit_open") else ""))
    if diag["ingest_busy_s"] > 0.5 * max(ph["execute"], 1e-9) \
            and diag["ingest_busy_s"] > 1.0:
        out.append(
            f"ingest-bound: {diag['ingest_busy_s']:.1f}s of host parse "
            f"busy time vs {ph['execute']:.1f}s device execute — "
            "consider --native-ingest / more prefetch")
    for r in legs:
        fp = r.get("fingerprint") or {}
        v = (r.get("sentinel") or {}).get("verdict")
        if v == "regressed":
            out.append(
                f"REGRESSED: {r.get('variant')} at "
                f"{r.get('value'):,.0f} — "
                f"{(r.get('sentinel') or {}).get('reason')}")
        elif v == "attachment_transient":
            out.append(
                f"transient (weather, not code): {r.get('variant')} — "
                f"{(r.get('sentinel') or {}).get('reason')}")
        if fp.get("degraded"):
            out.append(f"degraded leg (shrunk mesh): {r.get('variant')}")
        if fp.get("fused_fallback"):
            out.append("fused-embed fallback (library path measured): "
                       f"{r.get('variant')}")
    if not out:
        out.append("clean run: no faults, no regressions, "
                   f"{ph['execute'] / wall:.0%} of wall-clock executing")
    return out


#: Chrome-trace categories of the card's kernel records (torch.profiler).
_KERNEL_CATEGORIES = ("kernel",)


def profile_bundle(path: str, top: int = 12) -> dict | None:
    """The ``fmtorch train --profile DIR`` trace (``DIR/trace.json``, or
    the file itself) as a capture bundle of its own: the card's kernels
    by symbol — runs and device milliseconds, most expensive first.
    ``None`` when there is no parseable trace."""
    f = os.path.join(path, "trace.json") if os.path.isdir(path) else path
    try:
        with open(f) as fh:
            doc = json.load(fh)
    except (OSError, ValueError):
        return None
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    agg: dict[str, list] = {}
    for e in events or []:
        if not isinstance(e, dict) or e.get("cat") not in _KERNEL_CATEGORIES:
            continue
        row = agg.setdefault(str(e.get("name", "?")), [0, 0.0])
        row[0] += 1
        row[1] += float(e.get("dur") or 0.0) / 1e3
    kernels = [{"name": n, "runs": r, "device_ms": round(ms, 3)}
               for n, (r, ms) in sorted(agg.items(),
                                        key=lambda kv: -kv[1][1])]
    total = sum(k["device_ms"] for k in kernels)
    return {
        "trigger": "profile", "seq": 0,
        "profiler": {"status": "ok" if kernels else "no_device_events"},
        "context": {"kernels": len(kernels), "kernel_runs": sum(
            k["runs"] for k in kernels), "device_ms": round(total, 3)},
        "dir": os.path.dirname(os.path.abspath(f)),
        "kernels": kernels[:max(int(top), 0)],
    }


def render_profile(bundle: dict | None) -> list[str]:
    """The 'Device profile' section: the ``--profile`` bundle's kernels
    by symbol ('' terminated), or []."""
    if not bundle:
        return []
    ctx = bundle["context"]
    out = [f"## Device profile ({ctx['kernels']} kernel symbol(s), "
           f"{ctx['kernel_runs']} run(s), {ctx['device_ms']:,.3f} ms on "
           "the card)"]
    if bundle["kernels"]:
        out.append(f"  {'runs':>7} {'device_ms':>11}  kernel")
    for k in bundle["kernels"]:
        out.append(f"  {k['runs']:>7} {k['device_ms']:>11,.3f}  "
                   f"{k['name'][:120]}")
    out.append("")
    return out


def capture_findings(captures: list[dict]) -> list[str]:
    """Deep-capture one-liners: a fired capture is evidence
    the operator should open, so each bundle gets a pointer."""
    out = []
    for m in captures or []:
        ctx = m.get("context") or {}
        detail = ctx.get("reason") or " ".join(
            f"{k}={v}" for k, v in sorted(ctx.items()))
        out.append(
            f"DEEP CAPTURE [{m.get('trigger')}]: {str(detail)[:120]} "
            f"— evidence at {m.get('dir')}")
    return out


def render(run: dict, diag: dict, legs: list[dict],
           chaos: dict | None = None, serve: dict | None = None,
           serve_legs: list[dict] | None = None,
           online: dict | None = None,
           cost_rows: list[dict] | None = None,
           fmlint_rep: dict | None = None,
           embed: dict | None = None,
           fleet: dict | None = None,
           tracing: dict | None = None,
           storage: dict | None = None,
           profile: dict | None = None) -> str:
    out = [f"# fm_spark_tpu_torch run doctor — {run['run_id']}",
           f"obs dir: {run['dir']}", ""]

    out.append("## Where the time went "
               f"(observed wall-clock {diag['wall_s']:,.1f} s)")
    wall = diag["wall_s"] or 1e-9
    for name, secs in diag["phases"].items():
        out.append(f"  {name:16} {secs:>10,.2f} s  {secs / wall:>6.1%}")
    if diag["ingest_busy_s"]:
        out.append(f"  {'ingest busy':16} {diag['ingest_busy_s']:>10,.2f}"
                   " s  (host-side, overlaps execute)")
    out.append("")

    out.append(f"## Per-leg verdicts ({len(legs)} ledger record(s))")
    if legs:
        out.append(f"  {'variant':52} {'value':>12} {'verdict':>22} "
                   f"{'weather':>9} {'hbm_peak':>10}")
        for r in legs:
            fp = r.get("fingerprint") or {}
            v = r.get("value")
            peak = r.get("hbm_peak_bytes")
            stamps = "".join(
                s for s, on in (("/degraded", fp.get("degraded")),
                                ("/fallback", fp.get("fused_fallback")))
                if on)
            out.append(
                f"  {str(r.get('variant'))[:52]:52} "
                f"{(f'{v:,.0f}' if isinstance(v, (int, float)) else '-'):>12} "
                f"{((r.get('sentinel') or {}).get('verdict') or '?') + stamps:>22} "
                f"{fp.get('attachment_health', '?'):>9} "
                f"{(f'{peak / 2**30:.2f}G' if peak else '-'):>10}")
    else:
        out.append("  (no bench_leg ledger records for this run — the "
                   "port's ledger carries none until its benchmark "
                   "writes them, or a train-only run)")
    out.append("")

    cost_rows = cost_rows or []
    if cost_rows:
        out.append(f"## Cost attribution ({len(cost_rows)} record(s): "
                   "measured step time x bytes-moved model)")
        out.append(f"  {'variant':52} {'GB/s(model)':>12} "
                   f"{'step_ms':>10} {'bytes/step':>12}")
        for r in cost_rows:
            v = r.get("value")
            ms = r.get("step_ms")
            bts = r.get("bytes_per_step")
            v_s = f"{v:,.1f}" if isinstance(v, (int, float)) else "-"
            ms_s = f"{ms:,.2f}" if isinstance(ms, (int, float)) else "-"
            b_s = (f"{bts / 2**20:,.1f}M"
                   if isinstance(bts, (int, float)) else "-")
            out.append(f"  {str(r.get('variant'))[:52]:52} "
                       f"{v_s:>12} {ms_s:>10} {b_s:>12}")
        out.append("")

    captures = (run.get("captures") or []) + ([profile] if profile
                                               else [])
    if captures:
        # One shared renderer (obs_report.render_captures) — the
        # section format can never drift between the two tools.
        out.extend(obs_report.render_captures(captures))
    out.extend(render_profile(profile))

    if diag["fault_kinds"]:
        out.append("## Fault timeline (event counts)")
        for kind in sorted(diag["fault_kinds"]):
            out.append(f"  {kind:28} {diag['fault_kinds'][kind]:>5}")
        out.append("")

    if chaos is not None:
        out.append(
            f"## Chaos verdict ({chaos.get('mode', '?')} campaign, "
            f"{chaos.get('n_schedules', 0)} schedule(s))")
        out.append(
            f"  green {chaos.get('n_green', 0)}  failed "
            f"{chaos.get('n_failed', 0)}  skipped "
            f"{chaos.get('n_skipped', 0)}  "
            f"({chaos.get('total_s', 0):.1f}s)")
        for e in chaos.get("schedules", []):
            if e.get("verdict") == "green":
                continue
            out.append(f"  seed {e.get('seed')}: {e.get('verdict')} "
                       f"[{e.get('scenario')}] {e.get('plan') or ''}")
            for viol in e.get("violations", []):
                out.append(f"    - {viol['invariant']}: "
                           f"{viol['detail']}")
            if e.get("minimized_plan"):
                out.append("    minimized repro: FM_SPARK_FAULTS="
                           f"'{e['minimized_plan']}'")
        out.append("")

    serve_legs = serve_legs or []
    if serve is not None:
        out.append("## Serving")
        if serve["histograms"]:
            out.append(f"  {'latency':28} {'count':>8} {'mean_ms':>10} "
                       f"{'p50':>10} {'p95':>10} {'p99':>10}")
            for name in sorted(serve["histograms"]):
                s = serve["histograms"][name]
                out.append(
                    f"  {name:28} {s.get('count', 0):>8.0f} "
                    f"{s.get('mean') if s.get('mean') is not None else '-':>10} "
                    f"{s.get('p50') if s.get('p50') is not None else '-':>10} "
                    f"{s.get('p95') if s.get('p95') is not None else '-':>10} "
                    f"{s.get('p99') if s.get('p99') is not None else '-':>10}")
        if serve_legs:
            out.append(f"  {'serve leg':24} {'rows/s/chip':>14} "
                       f"{'p50_ms':>9} {'p99_ms':>9} {'verdict':>22}")
            for r in serve_legs:
                v = r.get("value")
                out.append(
                    f"  {str(r.get('leg'))[:24]:24} "
                    f"{(f'{v:,.0f}' if isinstance(v, (int, float)) else '-'):>14} "
                    f"{r.get('p50_ms', '-'):>9} {r.get('p99_ms', '-'):>9} "
                    f"{((r.get('sentinel') or {}).get('verdict') or '?'):>22}")
        if serve["timeline"]:
            out.append("  reload timeline:")
            t0 = serve["timeline"][0].get("ts") or 0.0
            for e in serve["timeline"]:
                extras = {k: v for k, v in e.items()
                          if k not in ("ts", "kind", "seq")}
                detail = " ".join(f"{k}={v}" for k, v in
                                  sorted(extras.items()))
                out.append(f"    +{(e.get('ts') or t0) - t0:>8.3f}s "
                           f"{e.get('kind'):20} {detail}"[:160])
        out.append(
            f"  swaps {serve['swaps']:.0f}  reload_failures "
            f"{serve['reload_failures']:.0f}  staleness "
            f"{serve['staleness_steps'] or 0:.0f}  degraded "
            f"{str(serve['degraded']).lower()}")
        out.append("")

    if fleet is not None:
        out.append("## Serving fleet")
        c = fleet["counters"]
        out.append(
            f"  accepted {c['accepted']}  answered {c['answered']}  "
            f"shed {c['shed']} (queue {c['shed_queue']} / deadline "
            f"{c['shed_deadline']})  rejected {c['rejected']}  "
            f"timeout {c['timeout']}  failed {c['failed']}  retries "
            f"{c['retries']}")
        if fleet["replicas"]:
            out.append(f"  {'replica':>8} {'state':>9} {'spawns':>7} "
                       f"{'downs':>6} {'generation':>11} "
                       f"{'staleness':>10}")
            for r in fleet["replicas"]:
                out.append(
                    f"  {r['replica']:>8} {r['state']:>9} "
                    f"{r['spawns']:>7} {r['downs']:>6} "
                    f"{str(r['generation_step'] if r['generation_step'] is not None else '-'):>11} "
                    f"{str(r['staleness_steps'] if r['staleness_steps'] is not None else '-'):>10}")
        if fleet["recoveries"] or fleet.get("partitions"):
            out.append("  replica-loss timeline (crash vs "
                       "partition):")
            losses = ([dict(r, _t=r["down_ts"], _kind="crash")
                       for r in fleet["recoveries"]]
                      + [dict(p, _t=p["drain_ts"], _kind="partition")
                         for p in fleet.get("partitions", [])])
            losses.sort(key=lambda x: x["_t"])
            t0 = losses[0]["_t"]
            for x in losses:
                if x["_kind"] == "crash":
                    out.append(
                        f"    +{x['_t'] - t0:>8.3f}s replica "
                        f"{x['replica']} down (rc={x['rc']}) -> "
                        f"ready after {x['recovery_s']:.3f}s "
                        "[crash: respawned]")
                else:
                    out.append(
                        f"    +{x['_t'] - t0:>8.3f}s replica "
                        f"{x['replica']} drained -> readmitted "
                        f"after {x['heal_s']:.3f}s [partition: "
                        "process stayed alive, no respawn]")
        auto = fleet.get("autoscale") or {}
        if auto.get("decisions"):
            out.append(
                f"  autoscale decision log ({auto['grows']} grow / "
                f"{auto['shrinks']} shrink, "
                f"{auto['direction_changes']} direction change(s)):")
            d0 = auto["decisions"][0].get("ts") or 0.0
            for d in auto["decisions"]:
                out.append(
                    f"    +{(d.get('ts') or d0) - d0:>8.3f}s "
                    f"{d.get('action'):6} -> {d.get('to_n')} "
                    f"replica(s)  [{d.get('reason')}]"[:160])
        out.append("")

    if tracing is not None:
        out.append(
            f"## Request tracing ({tracing['n_traces']} merged "
            f"trace(s), {tracing['incomplete']} incomplete)")
        out.append(f"  {'trace':>18} {'total_ms':>10} {'hops':>5} "
                   f"{'pids':>5}  dominant hop")
        for t in tracing["top"]:
            flag = "  INCOMPLETE" if t["incomplete"] else ""
            out.append(
                f"  {str(t['trace_id'])[:18]:>18} "
                f"{t['total_ms']:>10.2f} {t['hops']:>5} "
                f"{t['pids']:>5}  {t['dominant'] or '?'}{flag}")
        ex = tracing.get("exemplar")
        if ex is not None:
            out.append(
                f"  tail exemplar: trace {ex['trace_id']} at "
                f"{ex['value']:.2f} ms — "
                + ("resolves to a merged trace" if ex["resolved"]
                   else "NOT in the merged set"))
        out.append("  full hop tables: python -m "
                   "fm_spark_tpu_torch.tools.trace_report "
                   f"{tracing['root']}")
        out.append("")

    if embed is not None:
        out.append("## Embedding tier")
        hr = embed.get("hit_rate")
        ev = embed.get("evictions")
        stall = embed.get("stall_ms")
        out.append(
            "  hot-tier hit rate "
            + (f"{hr:.4f}" if isinstance(hr, (int, float)) else "-")
            + f"  evictions {ev if ev is not None else '-'}"
            + "  blocking stalls "
            + (f"{stall:.1f} ms" if isinstance(stall, (int, float))
               else "-"))
        if embed["rows"]:
            out.append(f"  {'ladder rung':22} {'rows/s':>12} "
                       f"{'hit':>7} {'stall_ms':>9} {'host RSS':>10} "
                       f"{'parity':>7} {'verdict':>22}")
            for r in embed["rows"]:
                v = r.get("value")
                rhr = r.get("hit_rate")
                rss = r.get("host_rss_bytes")
                par = r.get("parity_ok")
                out.append(
                    f"  {str(r.get('leg'))[:22]:22} "
                    f"{(f'{v:,.0f}' if isinstance(v, (int, float)) else '-'):>12} "
                    f"{(f'{rhr:.3f}' if isinstance(rhr, (int, float)) else '-'):>7} "
                    f"{r.get('stall_ms', '-'):>9} "
                    f"{(f'{rss / 1e9:.2f}GB' if isinstance(rss, (int, float)) else '-'):>10} "
                    f"{('-' if par is None else 'OK' if par else 'FAIL'):>7} "
                    f"{((r.get('sentinel') or {}).get('verdict') or '?'):>22}")
        out.append("")

    if storage is not None:
        out.append("## Storage health")
        cls = " / ".join(f"{k} {v:.0f}" for k, v in
                         storage["by_class"].items())
        out.append(
            f"  write failures {storage['write_failed_total']:.0f}"
            + (f" ({cls})" if cls else "")
            + f"  ckpt retries {storage['retries']:.0f}"
            + f"  emergency GCs {storage['emergency_gcs']:.0f}"
            + "  obs degraded "
            + str(bool(storage["degraded"])).lower())
        w = storage["degraded_window"]
        if w:
            out.append(
                f"  degraded-obs window: {w['n']} swallowed "
                "best-effort failure(s) over "
                f"{w['last_ts'] - w['first_ts']:.3f}s")
        if storage["retry_rows"]:
            out.append(f"  {'retry of':24} {'attempt':>8} "
                       f"{'errno':>6} {'backoff_s':>10}")
            for e in storage["retry_rows"]:
                out.append(
                    f"  {str(e.get('path'))[:24]:24} "
                    f"{e.get('attempt', '-'):>8} "
                    f"{str(e.get('errno', '-')):>6} "
                    f"{str(e.get('delay_s', '-')):>10}")
        if storage["events"]:
            out.append("  io-fault timeline:")
            t0 = storage["events"][0].get("ts") or 0.0
            for e in storage["events"][:40]:
                extras = {k: v for k, v in e.items()
                          if k not in ("ts", "kind", "seq")}
                detail = " ".join(f"{k}={v}" for k, v in
                                  sorted(extras.items()))
                out.append(f"    +{(e.get('ts') or t0) - t0:>8.3f}s "
                           f"{e.get('kind'):22} {detail}"[:160])
            if len(storage["events"]) > 40:
                out.append(f"    ... {len(storage['events']) - 40} "
                           "more io-fault event(s)")
        out.append("")

    if online is not None:
        out.append("## Continuous learning")
        if online["quality_rows"]:
            out.append(f"  {'eval day':>8} {'step':>8} {'auc':>8} "
                       f"{'verdict':>22}")
            for r in online["quality_rows"]:
                v = r.get("value")
                out.append(
                    f"  {str(r.get('day', '-')):>8} "
                    f"{str(r.get('step', '-')):>8} "
                    f"{(f'{v:.4f}' if isinstance(v, (int, float)) else '-'):>8} "
                    f"{((r.get('sentinel') or {}).get('verdict') or '?'):>22}")
        if online["events"]:
            out.append("  drift timeline:")
            t0 = online["events"][0].get("ts") or 0.0
            for e in online["events"]:
                extras = {k: v for k, v in e.items()
                          if k not in ("ts", "kind", "seq")}
                detail = " ".join(f"{k}={v}" for k, v in
                                  sorted(extras.items()))
                out.append(f"    +{(e.get('ts') or t0) - t0:>8.3f}s "
                           f"{e.get('kind'):22} {detail}"[:160])
        out.append(
            f"  days {online['days']:.0f}  rollbacks "
            f"{online['rollbacks']:.0f}  demoted generations "
            f"{online['demotions']:.0f}  quarantined "
            f"{online['quarantined']:.0f}  drift_score "
            f"{online['drift_score']}")
        out.append("")

    out.extend(render_fmlint(fmlint_rep))

    out.append("## Diagnosis")
    for line in (findings(diag, legs) + chaos_findings(chaos)
                 + serve_findings(serve, serve_legs)
                 + fleet_findings(fleet)
                 + online_findings(online)
                 + tracing_findings(tracing)
                 + embed_findings(embed)
                 + storage_findings(storage)
                 + capture_findings((run.get("captures") or [])
                                    + ([profile] if profile else []))
                 + fmlint_findings(fmlint_rep)):
        out.append(f"  - {line}")
    return "\n".join(out) + "\n"


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    opts = {}
    for flag in ("--ledger", "--profile"):
        if flag in args:
            i = args.index(flag)
            if i + 1 >= len(args):
                print(__doc__, file=sys.stderr)
                return 2
            opts[flag] = args[i + 1]
            del args[i:i + 2]
    ledger_path = opts.get("--ledger")
    profile = None
    if "--profile" in opts:
        profile = profile_bundle(opts["--profile"])
        if profile is None:
            print(f"no profiler trace at {opts['--profile']}",
                  file=sys.stderr)
            return 1
    # Shared --latest / --run-id / positional selection.
    obs_dir = obs_report.select_run_dir(
        args, os.path.join(_REPO, "artifacts", "obs"))
    if isinstance(obs_dir, int):
        if obs_dir == 2:
            print(__doc__, file=sys.stderr)
        return obs_dir
    if not os.path.isdir(obs_dir):
        print(f"not a directory: {obs_dir}", file=sys.stderr)
        return 1

    run = obs_report.load_run(obs_dir)
    flight_events = obs_report._read_jsonl(
        os.path.join(obs_dir, "flight.jsonl"))
    if ledger_path is None:
        ledger_path = os.path.join(
            os.path.dirname(os.path.normpath(obs_dir)), LEDGER_FILE)
    legs = _leg_rows(ledger_path, run["run_id"])
    serve_legs = _serve_rows(ledger_path, run["run_id"])
    diag = diagnose(run, legs, flight_events)
    serve = serve_diagnose(run, obs_report.serve_timeline(flight_events),
                           serve_legs)
    online = online_diagnose(run, obs_report.online_timeline(flight_events),
                             _quality_rows(ledger_path, run["run_id"]))
    embed = embed_diagnose(run, _embed_rows(ledger_path, run["run_id"]))
    fleet = fleet_diagnose(run, obs_report._read_jsonl(
        os.path.join(obs_dir, "fleet_health.jsonl")))
    sys.stdout.write(render(run, diag, legs,
                            chaos=load_chaos_verdict(obs_dir),
                            serve=serve, serve_legs=serve_legs,
                            online=online,
                            cost_rows=_cost_rows(ledger_path,
                                                 run["run_id"]),
                            fmlint_rep=load_fmlint_report(obs_dir),
                            embed=embed, fleet=fleet,
                            tracing=tracing_diagnose(obs_dir),
                            storage=storage_diagnose(run,
                                                     flight_events),
                            profile=profile))
    return 0


if __name__ == "__main__":
    sys.exit(main())
