"""Merge per-process span files into per-request distributed traces (the
port of ``tools/trace_report.py``, over the span files the port's
:mod:`fm_spark_tpu_torch.obs.trace` writes).

The reader half of request tracing. A traced request crosses at least three
processes — loadgen/client, the front-door+fleet parent, a replica —
and each writes its own ``trace.jsonl`` under its own obs run dir
(all under ONE obs root). This tool stitches them back into one
timeline per ``trace`` id and decomposes the request's latency into a
hop table:

======================  =============================================
``client``              the client's full round trip (loadgen span)
``admission``           front-door admission decision
``frontdoor``           admitted request end-to-end at the door
``dispatch``            fleet parent's dispatch attempt (incl. wire)
``transport``           dispatch minus the replica's server-side time
``replica``             replica request handling (submit + wait)
``coalesce wait``       time queued in the micro-batcher
``execute``             the shared padded-batch device dispatch
``split``               result split/fan-out back to the request
======================  =============================================

Cross-process clocks disagree (span ``t_start`` is wall-clock); the
dispatch hop's send/receive pair gives an NTP-style offset estimate —
``offset = ((t1-t0) + (t2-t3)) / 2`` with t0/t3 the parent's dispatch
span bounds and t1/t2 the replica's handle span bounds — averaged per
(parent pid, replica pid) and applied when laying spans on one
timeline. PIDs are recovered from span ids (``<pid hex>-<seq hex>``).

Torn input is expected, not fatal: junk/truncated JSONL lines are
skipped (the ledger discipline), and a trace whose dispatch span
carries an ``error`` attribute — or that is missing an expected hop
(replica SIGKILL'd mid-request) — renders with the hole flagged.

Usage::

    python -m fm_spark_tpu_torch.tools.trace_report artifacts/obs
                                                  # top-k table
    python -m fm_spark_tpu_torch.tools.trace_report artifacts/obs --trace ID
                                                  # one trace
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from fm_spark_tpu_torch.obs import METRICS_FILE, TRACE_FILE

#: Hops every fleet-path trace should have (the client hop is optional
#: — the loadgen may run without an obs plane).
EXPECTED_HOPS = ("frontdoor/admit", "frontdoor/request",
                 "fleet/dispatch", "replica/handle", "serve/coalesce")


def _read_jsonl(path: str) -> list[dict]:
    """Best-effort JSONL reader: junk/truncated lines are skipped —
    a SIGKILL'd writer leaves a torn tail, never a broken report."""
    out = []
    try:
        with open(path, errors="replace") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    doc = json.loads(line)
                except ValueError:
                    continue
                if isinstance(doc, dict):
                    out.append(doc)
    except OSError:
        pass
    return out


def span_pid(span_id) -> "int | None":
    """The emitting process, recovered from ``<pid hex>-<seq hex>``."""
    try:
        return int(str(span_id).split("-", 1)[0], 16)
    except (ValueError, AttributeError):
        return None


def collect(root: str) -> list[dict]:
    """Every traced span (records carrying a ``trace`` attribute) from
    every ``trace.jsonl`` under ``root``, recursively."""
    spans = []
    for dirpath, _dirnames, filenames in os.walk(root):
        if TRACE_FILE not in filenames:
            continue
        for doc in _read_jsonl(os.path.join(dirpath, TRACE_FILE)):
            if doc.get("event") == "span" and doc.get("trace"):
                spans.append(doc)
    return spans


def estimate_skew(spans: list[dict]) -> dict:
    """Per (parent pid, replica pid) clock-offset estimates, seconds.

    For every (``fleet/dispatch``, ``replica/handle``) pair stitched
    by ``remote_parent``: the handle interval sits inside the dispatch
    interval on the true timeline, so the midpoint difference is the
    replica-minus-parent clock offset (symmetric-transport assumption
    — the classic NTP estimator). Averaged over all pairs of a pid
    pair."""
    dispatch = {s.get("span_id"): s for s in spans
                if s.get("name") == "fleet/dispatch"}
    sums: dict[tuple, list] = {}
    for s in spans:
        if s.get("name") != "replica/handle":
            continue
        d = dispatch.get(s.get("remote_parent"))
        if d is None:
            continue
        try:
            t0 = float(d["t_start"])
            t3 = t0 + float(d.get("dur_ms") or 0.0) / 1e3
            t1 = float(s["t_start"])
            t2 = t1 + float(s.get("dur_ms") or 0.0) / 1e3
        except (KeyError, TypeError, ValueError):
            continue
        off = ((t1 - t0) + (t2 - t3)) / 2.0
        key = (span_pid(d.get("span_id")), span_pid(s.get("span_id")))
        sums.setdefault(key, []).append(off)
    return {k: sum(v) / len(v) for k, v in sums.items() if v}


def _hop_ms(spans_by_name: dict, name: str) -> "float | None":
    s = spans_by_name.get(name)
    if s is None:
        return None
    try:
        return float(s.get("dur_ms"))
    except (TypeError, ValueError):
        return None


def breakdown(trace: dict) -> dict:
    """Exclusive per-hop milliseconds for one merged trace (None =
    that hop's span is missing). ``dominant`` names the biggest."""
    by = trace["by_name"]
    d_ms = _hop_ms(by, "fleet/dispatch")
    h_ms = _hop_ms(by, "replica/handle")
    f_ms = _hop_ms(by, "frontdoor/request")
    co = by.get("serve/coalesce") or {}

    def attr(k):
        try:
            return float(co[k])
        except (KeyError, TypeError, ValueError):
            return None

    co_ms = _hop_ms(by, "serve/coalesce")
    out = {
        "client": _hop_ms(by, "client/request"),
        "admission": _hop_ms(by, "frontdoor/admit"),
        "frontdoor": (f_ms - d_ms
                      if f_ms is not None and d_ms is not None
                      else f_ms),
        "dispatch": d_ms,
        "transport": (d_ms - h_ms
                      if d_ms is not None and h_ms is not None
                      else None),
        "replica": (h_ms - co_ms
                    if h_ms is not None and co_ms is not None
                    else h_ms),
        "coalesce_wait": attr("queue_ms"),
        "execute": attr("exec_ms"),
        "split": attr("split_ms"),
    }
    ranked = [(v, k) for k, v in out.items()
              if v is not None and k not in ("client", "dispatch")]
    out["dominant"] = max(ranked)[1] if ranked else None
    return out


def merge(root: str) -> dict:
    """All spans under ``root`` merged per trace id. Returns
    ``{trace_id: {"spans", "by_name", "pids", "total_ms", "hops",
    "missing", "error_hops", "incomplete"}}``, skew-corrected onto the
    front-door process's clock."""
    spans = collect(root)
    skew = estimate_skew(spans)
    by_trace: dict[str, list] = {}
    for s in spans:
        by_trace.setdefault(str(s["trace"]), []).append(s)

    out = {}
    for tid, group in by_trace.items():
        group.sort(key=lambda s: float(s.get("t_start") or 0.0))
        pids = sorted({p for p in (span_pid(s.get("span_id"))
                                   for s in group) if p is not None})
        # Skew-correct replica spans onto the dispatching parent's
        # clock where an estimate exists.
        offsets = {rep: off for (_par, rep), off in skew.items()}
        t_bounds = []
        for s in group:
            try:
                t0 = float(s["t_start"])
            except (KeyError, TypeError, ValueError):
                continue
            t0 -= offsets.get(span_pid(s.get("span_id")), 0.0)
            t_bounds.append(t0)
            t_bounds.append(t0 + float(s.get("dur_ms") or 0.0) / 1e3)
        # Last span per name wins (a retried dispatch's second attempt
        # is the one the answer rode).
        by_name = {}
        for s in group:
            by_name[str(s.get("name"))] = s
        error_hops = sorted(s.get("name") for s in group
                            if s.get("error"))
        missing = [h for h in EXPECTED_HOPS if h not in by_name]
        out[tid] = {
            "trace_id": tid,
            "spans": group,
            "by_name": by_name,
            "pids": pids,
            "hops": len(by_name),
            "total_ms": (round((max(t_bounds) - min(t_bounds)) * 1e3,
                               3) if t_bounds else 0.0),
            "missing": missing,
            "error_hops": error_hops,
            "incomplete": bool(missing or error_hops),
        }
    return out


def tail_exemplar(root: str,
                  metric: str = "frontdoor/request_ms"
                  ) -> "dict | None":
    """The slowest recorded exemplar of ``metric`` across every run
    dir under ``root``: ``{"trace_id", "value", "le"}`` from the
    highest populated bucket of the LAST metrics snapshot — the
    concrete request behind the p99 figure."""
    best = None
    for dirpath, _dirnames, filenames in os.walk(root):
        if METRICS_FILE not in filenames:
            continue
        snaps = _read_jsonl(os.path.join(dirpath, METRICS_FILE))
        if not snaps:
            continue
        hist = (snaps[-1].get("histograms") or {}).get(metric) or {}
        for le, ex in (hist.get("exemplars") or {}).items():
            try:
                v = float(ex["value"])
                tid = str(ex["trace_id"])
            except (KeyError, TypeError, ValueError):
                continue
            if best is None or v > best["value"]:
                best = {"trace_id": tid, "value": v, "le": le}
    return best


# ----------------------------------------------------------- rendering


def _fmt_ms(v) -> str:
    return f"{v:9.2f}" if isinstance(v, float) else "(missing)"


def render_trace(trace: dict) -> str:
    bd = breakdown(trace)
    lines = [f"trace {trace['trace_id']}  "
             f"total {trace['total_ms']:.2f} ms  "
             f"{trace['hops']} hops  pids {trace['pids']}"]
    if trace["incomplete"]:
        what = ", ".join(trace["missing"]
                         + [f"{h} (error)" for h in
                            trace["error_hops"]])
        lines.append(f"  INCOMPLETE: {what}")
    for key, label in (("client", "client round trip"),
                       ("admission", "admission"),
                       ("frontdoor", "front door (excl. dispatch)"),
                       ("transport", "dispatch transport"),
                       ("replica", "replica (excl. coalesce)"),
                       ("coalesce_wait", "coalesce wait"),
                       ("execute", "execute"),
                       ("split", "split")):
        mark = " <-- dominant" if key == bd["dominant"] else ""
        lines.append(f"  {label:<28}{_fmt_ms(bd[key])} ms{mark}")
    return "\n".join(lines)


def render(merged: dict, top: int = 5, root: "str | None" = None
           ) -> str:
    if not merged:
        return "no traced requests found\n"
    ranked = sorted(merged.values(), key=lambda t: -t["total_ms"])
    lines = [f"# Request traces ({len(merged)} merged)", ""]
    for tr in ranked[:max(int(top), 1)]:
        lines.append(render_trace(tr))
        lines.append("")
    incomplete = sum(t["incomplete"] for t in merged.values())
    if incomplete:
        lines.append(f"{incomplete} trace(s) incomplete "
                     "(torn/missing hops flagged above)")
    if root:
        ex = tail_exemplar(root)
        if ex:
            resolved = ("resolves to a merged trace"
                        if ex["trace_id"] in merged
                        else "NOT in the merged set")
            lines.append(
                f"tail exemplar: trace {ex['trace_id']} at "
                f"{ex['value']:.2f} ms (le={ex['le']}) — {resolved}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="merge per-process span JSONL into per-request "
                    "distributed traces")
    ap.add_argument("root", help="obs ROOT holding every process's "
                                 "run dir (e.g. artifacts/obs)")
    ap.add_argument("--top", type=int, default=5,
                    help="show the K slowest traces (default 5)")
    ap.add_argument("--trace", default=None,
                    help="render exactly this trace id")
    args = ap.parse_args(argv)
    if not os.path.isdir(args.root):
        print(f"not a directory: {args.root}", file=sys.stderr)
        return 2
    merged = merge(args.root)
    if args.trace:
        tr = merged.get(args.trace)
        if tr is None:
            print(f"trace {args.trace!r} not found "
                  f"({len(merged)} merged)", file=sys.stderr)
            return 1
        print(render_trace(tr))
        return 0
    sys.stdout.write(render(merged, top=args.top, root=args.root))
    return 0


if __name__ == "__main__":
    sys.exit(main())
