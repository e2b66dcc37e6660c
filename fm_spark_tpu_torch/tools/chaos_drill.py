"""Chaos drill runner: seeded multi-fault campaigns with one verdict
(the port of the reference's ``tools/chaos_drill.py``).

The operational front-end of :mod:`fm_spark_tpu_torch.resilience.chaos`.
Runs N seeded schedules through the invariant auditor, delta-debugs any
failure down to a minimal reproducible plan string, and writes the
machine-readable verdict to ``artifacts/obs/<run_id>/chaos_verdict.json``.
Exit code 0 iff every schedule was green.

Modes::

    python -m fm_spark_tpu_torch.tools.chaos_drill        # bounded: 25
                                                          # seeds
    python -m fm_spark_tpu_torch.tools.chaos_drill --seeds 3,17,42
                                                          # replay seeds
    python -m fm_spark_tpu_torch.tools.chaos_drill --soak # long mode: 200
                                                          # seeds +
                                                          # subprocess
                                                          # kill/hang
                                                          # drills
    python -m fm_spark_tpu_torch.tools.chaos_drill --canary
                                                          # prove the
                                                          # auditor catches
                                                          # a broken
                                                          # recovery path
                                                          # (exit 0 iff
                                                          # caught AND
                                                          # minimized)

The drills run on the card; ``--device cpu`` runs them on the host's
plain PyTorch path. The bounded default is the campaign the tier-1 soak
runs, so a green test round certifies the same invariants this tool
checks interactively. Every schedule is a pure function of its seed —
``--seeds <failing-seed>`` replays a verdict's repro, and the verdict's
``minimized_plan`` can be run directly via ``FM_SPARK_FAULTS``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

VERDICT_FILE = "chaos_verdict.json"

#: The tier-1 bounded campaign: fixed seed list + time budget. Fixed —
#: not configurable per run — so every CI round drills the SAME plans
#: and a regression bisects cleanly.
TIER1_SEEDS = tuple(range(25))
TIER1_BUDGET_S = 300.0
TIER1_PER_SCHEDULE_S = 30.0


def _atomic_write_json(path: str, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def write_verdict(verdict: dict, obs_root: str,
                  run_id: str | None = None) -> str:
    """Persist one campaign verdict under ``<obs_root>/<run_id>/`` —
    the per-run obs directory convention, so run_doctor/obs_report
    find it next to any telemetry the drills produced."""
    from fm_spark_tpu_torch import obs

    run_id = run_id or obs.new_run_id()
    run_dir = os.path.join(obs_root, run_id)
    os.makedirs(run_dir, exist_ok=True)
    verdict["run_id"] = run_id  # in place: callers render the id too
    path = os.path.join(run_dir, VERDICT_FILE)
    _atomic_write_json(path, verdict)
    return path


def render(verdict: dict) -> str:
    out = [f"# chaos campaign — {verdict.get('run_id', '?')}",
           f"schedules: {verdict['n_schedules']}  "
           f"green: {verdict['n_green']}  failed: {verdict['n_failed']}"
           f"  skipped: {verdict.get('n_skipped', 0)}  "
           f"({verdict['total_s']:.1f}s"
           + (f" of {verdict['budget_s']:.0f}s budget"
              if verdict.get("budget_s") else "") + ")", ""]
    for e in verdict["schedules"]:
        mark = {"green": "ok ", "failed": "FAIL",
                "skipped_budget": "skip"}.get(e["verdict"], "?   ")
        out.append(f"  [{mark}] seed {str(e.get('seed', '-')):>4} "
                   f"{(e.get('scenario') or '-'):14} "
                   f"{(e.get('outcome') or '-'):16} {e.get('plan') or ''}")
        for viol in e.get("violations", []):
            out.append(f"         - {viol['invariant']}: "
                       f"{viol['detail']}")
        if e.get("minimized_plan"):
            out.append(f"         minimized repro: "
                       f"FM_SPARK_FAULTS='{e['minimized_plan']}' "
                       f"(seed {e['seed']})")
    out.append("")
    out.append("ALL GREEN" if verdict["all_green"]
               else f"{verdict['n_failed']} FAILING SCHEDULE(S)")
    return "\n".join(out) + "\n"


def _soak_subprocess_drills(cfg, base_dir: str, device) -> list[dict]:
    """The process-fatal scenarios the in-process campaign cannot
    express: SIGKILL mid-run (spool-compaction pressure via a small
    flight ring), a watchdog-bounded real hang, and an injected init
    exit — each respawned to completion and held to the exactly-once
    + rc-discipline invariants."""
    import dataclasses

    from fm_spark_tpu_torch.resilience import chaos

    sub_cfg = dataclasses.replace(cfg, flight_capacity=4)
    golden = chaos.golden_run(sub_cfg, os.path.join(base_dir, "golden"),
                              device=device)
    drills = [
        ("sigkill_midrun", dict(plan="", kill_at_step=9),
         dict()),
        ("hang_ingest_watchdog",
         dict(plan="ingest_truncate@2=hang:300",
              watchdog_spec="ingest_chunk=1.5"), dict()),
        ("init_exit_respawn", dict(plan="backend_init@1=exit:3"),
         dict(expected_rcs=(0, 3))),
    ]
    entries = []
    for name, kw, extra in drills:
        t0 = time.perf_counter()
        plan = kw.pop("plan")
        r = chaos.run_schedule_subproc(
            plan, sub_cfg,
            os.path.join(base_dir, f"sub_{name}"), **kw, **extra,
            device=device)
        violations = []
        if r.outcome != "completed":
            violations.append({"invariant": "completion",
                               "detail": f"{r.outcome}: {r.error}"})
        else:
            try:
                if chaos.stitch_taps(r) != golden.tap:
                    violations.append({
                        "invariant": "exactly_once_stream",
                        "detail": "stitched stream != clean run"})
            except ValueError as e:
                violations.append({"invariant": "exactly_once_stream",
                                   "detail": str(e)})
            if r.loss_history != golden.loss_history:
                violations.append({"invariant": "loss_continuity",
                                   "detail": "loss curve diverged"})
        entries.append({
            "seed": None, "scenario": f"subprocess:{name}",
            "plan": plan, "expects": "completed",
            "outcome": r.outcome, "rcs": list(r.rcs),
            "verdict": "green" if not violations else "failed",
            "violations": violations,
            "duration_s": round(time.perf_counter() - t0, 3),
        })
    return entries


def _drift_entries(base_dir: str, soak: bool, device) -> list[dict]:
    """The continuous-learning half of the campaign: five
    seeded drift/rollback schedules drilled against the production
    online loop (planted label-flip drift, demotion tombstones,
    coordinated rollback), plus — in soak mode — the subprocess
    SIGKILL-mid-demotion drill."""
    from fm_spark_tpu_torch.resilience import chaos

    entries = chaos.run_drift_campaign(
        base_dir=os.path.join(base_dir, "drift"), device=device)
    if soak:
        t0 = time.perf_counter()
        r = chaos.run_demote_kill_drill(
            os.path.join(base_dir, "demote_kill"))
        entries.append({
            "seed": None, "scenario": "subprocess:demote_kill",
            "plan": "ckpt_demote@1=exit:23", "expects": "recovered",
            "outcome": ("recovered" if not r["violations"]
                        else "violated"),
            "rcs": r["rcs"],
            "verdict": "green" if not r["violations"] else "failed",
            "violations": r["violations"],
            "duration_s": round(time.perf_counter() - t0, 3),
        })
    return entries


def _fleet_entries(base_dir: str, soak: bool, device) -> list[dict]:
    """The serving-fleet half of the campaign: seeded
    traffic-replay schedules (flash crowds, retry storms, slow
    clients) against a REAL two-replica fleet behind the front door,
    with mid-burst replica SIGKILLs, injected dispatch faults, and
    publish+demote races — audited from artifacts alone
    (:func:`chaos_audit.audit_fleet`)."""
    from fm_spark_tpu_torch.resilience import chaos

    seeds = chaos.FLEET_SOAK_SEEDS if soak else chaos.FLEET_TIER1_SEEDS
    return chaos.run_fleet_campaign(
        seeds, base_dir=os.path.join(base_dir, "fleet"), device=device)


def _partition_entries(base_dir: str, soak: bool, device) -> list[dict]:
    """The partition half of the fleet campaign: seeded
    network-fault schedules (peer-scoped connect/send windows, slow
    links, response truncations) against a shared fleet with the
    autoscaler armed — graded by ``audit_fleet``'s partition
    extensions (partition_not_a_crash, autoscale_converged) on top of
    exactly-once and closed books."""
    from fm_spark_tpu_torch.resilience import chaos

    seeds = (chaos.PARTITION_TIER1_SEEDS if not soak
             else tuple(range(4)))  # soak adds the 4th scenario class
    return chaos.run_partition_campaign(
        seeds, base_dir=os.path.join(base_dir, "partition"),
        device=device)


def _disk_entries(base_dir: str, soak: bool, device) -> list[dict]:
    """The storage half of the campaign: seeded disk-fault
    schedules (ENOSPC at a checkpoint commit over demoted
    generations, torn tombstone renames racing a serve reload, fsync
    stalls on the day-boundary save, EIO bursts on flight-spool
    compaction, a read-only obs plane) through the durable-write
    seam, graded by :func:`chaos_audit.audit_disk` — golden run first
    for the byte-identity baseline. Soak adds the subprocess
    SIGKILL-during-emergency-GC drill."""
    from fm_spark_tpu_torch.resilience import chaos

    return chaos.run_disk_campaign(
        chaos.DISK_TIER1_SEEDS,
        base_dir=os.path.join(base_dir, "disk"),
        include_kill_drill=soak, device=device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="seeded chaos campaigns over the resilience stack")
    ap.add_argument("--seeds", default=None,
                    help="comma-separated seed list (default: the "
                         "fixed tier-1 list)")
    ap.add_argument("--schedules", type=int, default=None,
                    help="run seeds 0..N-1 instead of the fixed list")
    ap.add_argument("--soak", action="store_true",
                    help="long mode (nightly): 200 seeds + "
                         "the subprocess kill/hang/init-exit drills")
    ap.add_argument("--canary", action="store_true",
                    help="deliberately break the recovery path "
                         "(restore stops rewinding the cursor) and "
                         "exit 0 iff the auditor catches it and the "
                         "minimizer reduces it to <= 2 rules")
    ap.add_argument("--budget", type=float, default=None,
                    help="campaign wall-clock budget in seconds "
                         f"(default {TIER1_BUDGET_S:.0f}, soak: none)")
    ap.add_argument("--per-schedule-timeout", type=float,
                    default=TIER1_PER_SCHEDULE_S,
                    dest="per_schedule",
                    help="flag any single drill exceeding this many "
                         "seconds")
    ap.add_argument("--no-minimize", action="store_true",
                    help="skip delta-debugging failing schedules")
    ap.add_argument("--out", default=os.path.join(_REPO, "artifacts",
                                                  "obs"),
                    help="obs root for <run_id>/chaos_verdict.json")
    ap.add_argument("--work-dir", default=None,
                    help="drill scratch dir (default: a tempdir)")
    ap.add_argument("--device", default=None,
                    help="the device every drill trains and serves on "
                         "(default: the card; 'cpu' for the plain "
                         "PyTorch path on the host)")
    args = ap.parse_args(argv)

    import dataclasses

    from fm_spark_tpu_torch import resolve_device
    from fm_spark_tpu_torch.resilience import chaos

    device = resolve_device(args.device)

    if args.seeds:
        seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
    elif args.schedules is not None:
        seeds = list(range(args.schedules))
    elif args.soak:
        seeds = list(range(200))
    else:
        seeds = list(TIER1_SEEDS)
    budget = args.budget
    if budget is None and not args.soak:
        budget = TIER1_BUDGET_S

    cfg = chaos.DrillConfig(break_restore=args.canary)
    base_dir = args.work_dir or tempfile.mkdtemp(prefix="chaos_drill_")
    # The canary's success criterion IS a minimized repro, so canary
    # mode always minimizes (--no-minimize would otherwise turn a
    # caught canary into a false "auditor is blind" verdict).
    verdict = chaos.run_campaign(
        seeds, cfg=cfg, base_dir=base_dir, time_budget_s=budget,
        per_schedule_timeout_s=args.per_schedule,
        minimize_failures=args.canary or not args.no_minimize,
        device=device)
    extra = []
    if not args.canary and args.seeds is None and args.schedules is None:
        # Drift/rollback schedules ride every default bounded and soak
        # campaign; an explicit --seeds/--schedules run is a targeted
        # replay and drills exactly what it names, and the canary's
        # broken-restore hook has no business in the online loop.
        # Fleet, partition and disk schedules ride along under the same
        # rule.
        extra.extend(_drift_entries(base_dir, args.soak, device))
        extra.extend(_fleet_entries(base_dir, args.soak, device))
        extra.extend(_partition_entries(base_dir, args.soak, device))
        extra.extend(_disk_entries(base_dir, args.soak, device))
    if args.soak:
        extra.extend(_soak_subprocess_drills(
            dataclasses.replace(cfg, break_restore=False), base_dir,
            device))
    if extra:
        verdict["schedules"].extend(extra)
        verdict["n_schedules"] += len(extra)
        verdict["n_green"] += sum(e["verdict"] == "green"
                                  for e in extra)
        fails = [e for e in extra if e["verdict"] != "green"]
        verdict["failures"].extend(fails)
        verdict["n_failed"] += len(fails)
        verdict["all_green"] = (verdict["all_green"] and not fails)
    verdict["mode"] = ("canary" if args.canary
                       else "soak" if args.soak else "bounded")

    path = write_verdict(verdict, args.out)
    sys.stdout.write(render(verdict))
    print(f"verdict: {path}")

    if args.canary:
        # Success = the broken recovery path was CAUGHT and minimized
        # to a <=2-rule reproducible plan; an all-green canary run
        # means the auditor is blind and must fail loudly.
        caught = [f for f in verdict["failures"]
                  if f.get("minimized_plan")
                  and f.get("minimized_rules", 99) <= 2]
        if caught:
            print("canary CAUGHT and minimized: "
                  f"{caught[0]['minimized_plan']!r}")
            return 0
        print("canary NOT caught — the auditor missed a broken "
              "recovery path", file=sys.stderr)
        return 1
    return 0 if verdict["all_green"] else 1


if __name__ == "__main__":
    sys.exit(main())
