"""Render one human-readable run report from a telemetry directory (the
port of ``tools/obs_report.py``, over the run dirs the port's obs plane
writes).

Given a per-run obs directory (``artifacts/obs/<run_id>/`` — span trace,
metrics snapshots, flight spool/dump, health journals, dead-letter
stream), print a single report answering "where did this run spend its
time, what faulted, and what did ingest/step-rate look like":

- **Phase breakdown** — spans aggregated by name (count, total time,
  mean, max, share of the run's observed wall-clock);
- **Percentile tables** — the last metrics snapshot's histograms
  (count/mean/p50/p95/p99) plus counters and gauges;
- **Fault / retry timeline** — fault-kind events from the flight
  window and every health journal, time-ordered with offsets relative
  to the first observed event;
- **Quarantine** — dead-letter reason counts, when ingest quarantined.

Pointed at a flat directory of health journals and a dead-letter file
(no ``trace.jsonl``), the report still renders the fault timeline and
quarantine sections.

Usage::

    python -m fm_spark_tpu_torch.tools.obs_report artifacts/obs/<run_id>/
    python -m fm_spark_tpu_torch.tools.obs_report --latest [obs_root]
    python -m fm_spark_tpu_torch.tools.obs_report --run-id <id> [obs_root]
                        # explicit run-id selector: the mtime-based
                        # --latest is wrong while a serve daemon keeps
                        # its run dir hot
"""

from __future__ import annotations

import json
import os
import sys
from collections import Counter

from fm_spark_tpu_torch.obs import FAULT_KINDS, TRACE_FILE
from fm_spark_tpu_torch.obs.introspect import list_captures

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _read_jsonl(path: str) -> list[dict]:
    """Best-effort JSONL parse: unparseable lines (the torn tail a kill
    can leave) are skipped, a missing file is an empty stream."""
    out = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(rec, dict):
                    out.append(rec)
    except OSError:
        pass
    return out


def load_run(obs_dir: str) -> dict:
    """Parse every stream in ``obs_dir`` into one report-ready dict.
    Works on both the per-run layout and the old flat artifacts layout
    (where only health/dead-letter journals exist)."""
    spans = [r for r in _read_jsonl(os.path.join(obs_dir, TRACE_FILE))
             if r.get("event") == "span"]
    snapshots = _read_jsonl(os.path.join(obs_dir, "metrics.jsonl"))

    flight_events = _read_jsonl(os.path.join(obs_dir, "flight.jsonl"))
    dump = None
    try:
        with open(os.path.join(obs_dir, "flight_dump.json")) as f:
            dump = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass

    health = []
    for fname in sorted(os.listdir(obs_dir)) if os.path.isdir(obs_dir) \
            else []:
        if fname.startswith("health") and fname.endswith(".jsonl"):
            health.extend(_read_jsonl(os.path.join(obs_dir, fname)))

    dead = _read_jsonl(os.path.join(obs_dir, "deadletter.jsonl"))

    # Kernel-pricing report (kernel_pricing.json, the reference's
    # bench_kernels.py format): surfaced when a run dir holds one.
    pricing = None
    try:
        with open(os.path.join(obs_dir, "kernel_pricing.json")) as f:
            pricing = json.load(f)
    except (OSError, json.JSONDecodeError):
        pass

    # Fault timeline: flight window + health journals, de-duplicated —
    # the health journal is MIRRORED into the flight ring, so the same
    # transition usually exists in both streams. The key is the FULL
    # payload (minus the ring's own seq/kind bookkeeping), not just
    # (ts, kind): a quarantine burst can emit many distinct bad_record
    # events inside one rounded millisecond, and each must keep its
    # own timeline row.
    seen, timeline = set(), []
    for rec in flight_events + health:
        kind = rec.get("kind") or rec.get("event")
        if kind not in FAULT_KINDS:
            continue
        key = (kind, json.dumps(
            {k: v for k, v in rec.items() if k not in ("seq", "kind",
                                                       "event")},
            sort_keys=True, default=str))
        if key in seen:
            continue
        seen.add(key)
        timeline.append(dict(rec, kind=kind))
    timeline.sort(key=lambda r: r.get("ts") or 0.0)

    return {
        "dir": os.path.abspath(obs_dir),
        "run_id": (dump or {}).get("run_id") or next(
            (e.get("run_id") for e in flight_events
             if e.get("kind") == "run_start" and e.get("run_id")),
            os.path.basename(os.path.normpath(obs_dir))),
        "spans": spans,
        "snapshot": snapshots[-1] if snapshots else
        (dump or {}).get("metrics"),
        "dump": dump,
        "timeline": timeline,
        "flight_events": flight_events,
        "dead": dead,
        "kernel_pricing": pricing,
        # Deep-capture bundles: every valid manifest under
        # <run>/captures/ — trigger, context, profiler status.
        "captures": list_captures(obs_dir),
    }


def serve_timeline(flight_events: list[dict]) -> list[dict]:
    """The serving reload/swap timeline from a flight window:
    ``serve_*``/``reload_*`` events, payload-deduped — a journaled event
    and its flight-ring mirror are the same transition. Shared by this
    report and :mod:`.run_doctor`."""
    return _dedup_timeline(flight_events, ("serve_", "reload_"))


def online_timeline(flight_events: list[dict]) -> list[dict]:
    """The continuous-learning timeline: eval verdicts,
    drift alarms, demotions, rollbacks, pointer republishes — same
    dedup contract as :func:`serve_timeline`."""
    return _dedup_timeline(
        flight_events,
        ("quality_eval", "online_", "divergence_",
         "generation_demoted", "last_good_republished"))


def render_captures(captures: list[dict]) -> list[str]:
    """The 'Deep captures' section body — trigger, profiler
    status, context, bundle path per valid manifest. Shared by this
    report and :mod:`.run_doctor` (same sharing contract as
    :func:`serve_timeline`), so the format can never drift between the
    two tools."""
    out = [f"## Deep captures ({len(captures)} bundle(s))"]
    for m in captures:
        ctx = " ".join(f"{k}={v}" for k, v in sorted(
            (m.get("context") or {}).items()))
        prof = (m.get("profiler") or {}).get("status", "?")
        out.append(f"  {m.get('trigger', '?'):22} "
                   f"#{m.get('seq', '?')}  profiler={prof}  "
                   f"{ctx}"[:200])
        out.append(f"    -> {m.get('dir')}")
    out.append("")
    return out


def _dedup_timeline(flight_events: list[dict], prefixes) -> list[dict]:
    seen, out = set(), []
    for e in flight_events:
        if not str(e.get("kind", "")).startswith(tuple(prefixes)):
            continue
        key = json.dumps({k: v for k, v in e.items()
                          if k not in ("seq", "ts")},
                         sort_keys=True, default=str)
        if key in seen:
            continue
        seen.add(key)
        out.append(e)
    return out


def _fmt_ms(v) -> str:
    return "-" if v is None else f"{v:,.2f}"


def _phase_rows(spans: list[dict]) -> list[tuple]:
    agg: dict[str, list[float]] = {}
    for s in spans:
        agg.setdefault(s.get("name", "?"), []).append(
            float(s.get("dur_ms") or 0.0))
    rows = []
    for name, durs in agg.items():
        rows.append((sum(durs), name, len(durs),
                     sum(durs) / len(durs), max(durs)))
    rows.sort(reverse=True)
    return rows


def render(run: dict) -> str:
    """The report text (also what ``main`` prints)."""
    out = [f"# fm_spark_tpu_torch run report — {run['run_id']}",
           f"obs dir: {run['dir']}", ""]

    spans = run["spans"]
    out.append(f"## Phase breakdown ({len(spans)} spans)")
    if spans:
        starts = [s.get("t_start") for s in spans
                  if s.get("t_start") is not None]
        ends = [s["t_start"] + s.get("dur_ms", 0.0) / 1e3 for s in spans
                if s.get("t_start") is not None]
        wall_s = (max(ends) - min(starts)) if starts else 0.0
        out.append(f"observed wall-clock: {wall_s:,.3f} s")
        out.append(f"{'name':32} {'count':>6} {'total_s':>10} "
                   f"{'mean_ms':>10} {'max_ms':>10} {'share':>7}")
        for total_ms, name, n, mean_ms, max_ms in _phase_rows(spans):
            share = (total_ms / 1e3 / wall_s) if wall_s > 0 else 0.0
            out.append(f"{name:32} {n:>6} {total_ms / 1e3:>10,.3f} "
                       f"{mean_ms:>10,.2f} {max_ms:>10,.2f} "
                       f"{share:>6.1%}")
    else:
        out.append("(no span trace — pre-obs layout or tracing disabled)")
    traced = {str(s.get("trace")) for s in spans if s.get("trace")}
    if traced:
        # Request-scoped spans: this run dir holds one
        # process's slice — cross-process stitching lives elsewhere.
        out.append(
            f"{len(traced)} distinct request trace id(s) in this "
            "process's spans — merge the fleet's view with "
            "python -m fm_spark_tpu_torch.tools.trace_report <obs root>")
    out.append("")

    snap = run["snapshot"]
    out.append("## Metrics")
    if snap:
        hists = snap.get("histograms") or {}
        if hists:
            out.append(f"{'histogram':32} {'count':>8} {'mean':>10} "
                       f"{'p50':>10} {'p95':>10} {'p99':>10}")
            for name in sorted(hists):
                s = hists[name]
                out.append(
                    f"{name:32} {s.get('count', 0):>8} "
                    f"{_fmt_ms(s.get('mean')):>10} "
                    f"{_fmt_ms(s.get('p50')):>10} "
                    f"{_fmt_ms(s.get('p95')):>10} "
                    f"{_fmt_ms(s.get('p99')):>10}")
        for kind in ("counters", "gauges"):
            vals = {k: v for k, v in (snap.get(kind) or {}).items()
                    if v is not None}
            if vals:
                out.append(f"{kind}:")
                for name in sorted(vals):
                    out.append(f"  {name:40} {vals[name]:,.6g}")
    else:
        out.append("(no metrics snapshot)")
    out.append("")

    timeline = run["timeline"]
    out.append(f"## Fault / retry timeline ({len(timeline)} events)")
    if timeline:
        t0 = timeline[0].get("ts") or 0.0
        for rec in timeline:
            extras = {k: v for k, v in rec.items()
                      if k not in ("ts", "kind", "event", "seq")}
            detail = " ".join(f"{k}={v}" for k, v in sorted(
                extras.items()))
            out.append(f"  +{(rec.get('ts') or t0) - t0:>9.3f}s "
                       f"{rec['kind']:28} {detail}"[:200])
    else:
        out.append("(clean run: no fault events)")
    out.append("")

    # Serving reload timeline: swaps, reload failures, and
    # warmup events from the flight window — the hot-reload story the
    # fault timeline's FAULT_KINDS filter only partially covers.
    serve_events = serve_timeline(run.get("flight_events", []))
    if serve_events:
        out.append(f"## Serving reload timeline "
                   f"({len(serve_events)} events)")
        t0 = serve_events[0].get("ts") or 0.0
        for rec in serve_events:
            extras = {k: v for k, v in rec.items()
                      if k not in ("ts", "kind", "seq")}
            detail = " ".join(f"{k}={v}" for k, v in sorted(
                extras.items()))
            out.append(f"  +{(rec.get('ts') or t0) - t0:>9.3f}s "
                       f"{rec['kind']:24} {detail}"[:200])
        out.append("")

    # Continuous-learning timeline: the drift story — eval
    # verdicts, alarms, demotions, rollbacks — in stream order.
    drift_events = online_timeline(run.get("flight_events", []))
    if drift_events:
        out.append(f"## Continuous-learning timeline "
                   f"({len(drift_events)} events)")
        t0 = drift_events[0].get("ts") or 0.0
        for rec in drift_events:
            extras = {k: v for k, v in rec.items()
                      if k not in ("ts", "kind", "seq")}
            detail = " ".join(f"{k}={v}" for k, v in sorted(
                extras.items()))
            out.append(f"  +{(rec.get('ts') or t0) - t0:>9.3f}s "
                       f"{rec['kind']:24} {detail}"[:200])
        out.append("")

    dead = run["dead"]
    if dead:
        out.append(f"## Quarantine ({len(dead)} dead-letter records)")
        reasons = Counter(r.get("reason", "?") for r in dead
                          if r.get("event") == "bad_record")
        for reason, n in reasons.most_common():
            out.append(f"  {n:>6}  {reason}")
        out.append("")

    pricing = run.get("kernel_pricing")
    if pricing:
        kernels = pricing.get("kernels") or []
        out.append(f"## Kernel pricing ({len(kernels)} row(s), "
                   f"backend={pricing.get('backend')}"
                   + (", INTERPRET — timings are emulation overhead"
                      if pricing.get("interpret") else "") + ")")
        out.append(f"{'kernel':28} {'family':10} {'ms':>10} "
                   f"{'model GB/s':>11}  note")
        for row in kernels:
            if row.get("skipped"):
                out.append(f"{row.get('kernel', '?'):28} "
                           f"{row.get('family', '?'):10} "
                           f"{'-':>10} {'-':>11}  "
                           f"skipped: {row['skipped']}"[:120])
                continue
            out.append(
                f"{row.get('kernel', '?'):28} "
                f"{row.get('family', '?'):10} "
                f"{_fmt_ms(row.get('ms')):>10} "
                f"{_fmt_ms(row.get('model_gbps')):>11}  "
                f"{row.get('note', '')}"[:120])
        out.append("")

    captures = run.get("captures") or []
    if captures:
        out.extend(render_captures(captures))

    dump = run["dump"]
    if dump:
        out.append(f"last flight dump: reason={dump.get('reason')!r} "
                   f"events={len(dump.get('events') or [])}")
    return "\n".join(out) + "\n"


def _latest_run_dir(root: str) -> str | None:
    try:
        runs = [os.path.join(root, d) for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d))]
    except OSError:
        return None
    return max(runs, key=os.path.getmtime) if runs else None


def _run_dir_by_id(root: str, run_id: str) -> str | None:
    """Explicit run-id selection: `--latest`'s
    mtime pick is wrong when a serve daemon keeps its run dir hot —
    the run you want to inspect is named, not newest."""
    path = os.path.join(root, run_id)
    return path if os.path.isdir(path) else None


def select_run_dir(args: list, default_root: str) -> "str | int":
    """Shared --latest / --run-id / positional-dir selection for this
    report and :mod:`.run_doctor`. Returns the run dir, or an int
    exit code: not-found complaints are printed here (tool-agnostic),
    but a USAGE error (2) returns silently — each caller prints its
    OWN usage doc, never this module's."""
    if args and args[0] == "--run-id":
        if len(args) < 2:
            return 2
        root = args[2] if len(args) > 2 else default_root
        obs_dir = _run_dir_by_id(root, args[1])
        if obs_dir is None:
            print(f"no run directory {args[1]!r} under {root}",
                  file=sys.stderr)
            return 1
        return obs_dir
    if args and args[0] == "--latest":
        root = args[1] if len(args) > 1 else default_root
        obs_dir = _latest_run_dir(root)
        if obs_dir is None:
            print(f"no run directories under {root}", file=sys.stderr)
            return 1
        return obs_dir
    if len(args) == 1:
        return args[0]
    return 2


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    obs_dir = select_run_dir(args, os.path.join(_REPO, "artifacts",
                                                "obs"))
    if isinstance(obs_dir, int):
        if obs_dir == 2:
            print(__doc__, file=sys.stderr)
        return obs_dir
    if not os.path.isdir(obs_dir):
        print(f"not a directory: {obs_dir}", file=sys.stderr)
        return 1
    sys.stdout.write(render(load_run(obs_dir)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
