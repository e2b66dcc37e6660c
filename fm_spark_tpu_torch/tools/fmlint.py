"""fmlint CLI over the port: run the pluggable static-analysis pass of
:mod:`fm_spark_tpu_torch.analysis` (the port of ``tools/fmlint.py``).

Usage::

    python -m fm_spark_tpu_torch.tools.fmlint            # full run, exit 1
                                                         # on NEW findings
    python -m fm_spark_tpu_torch.tools.fmlint --list-rules
    python -m fm_spark_tpu_torch.tools.fmlint --rules torch-host-sync,thread-lock-discipline
    python -m fm_spark_tpu_torch.tools.fmlint --write-baseline
    python -m fm_spark_tpu_torch.tools.fmlint --out DIR  # report dir
                                                         # override

Exit status: 0 when every (rule, file) finding count is at or under the
committed baseline (``fmlint_baseline_torch.json``; an empty/missing baseline
means any finding fails), 1 otherwise, 2 on usage errors. Every run
writes a JSON report — by default into ``artifacts/obs/<run_id>/
fmlint.json`` (run id minted here, or ``--run-id`` to join an existing
run directory) so ``run_doctor``/``obs_report`` render analysis
regressions next to perf ones.

The port's analysis package is loaded BY PATH (stdlib-only), so the
pass itself needs no torch.
"""

from __future__ import annotations

import argparse
import importlib.util
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: The port's analysis package (``fm_spark_tpu_torch/analysis``).
ANALYSIS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "analysis")


def load_analysis():
    """Import the port's ``analysis`` package WITHOUT importing the
    top-level package (and torch): the package is loaded by file path
    under an alias, with submodule search enabled so its relative
    imports work. Loaded once per process."""
    name = "fm_spark_tpu_torch_analysis"
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ANALYSIS_DIR, "__init__.py"),
        submodule_search_locations=[ANALYSIS_DIR])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def mint_run_id() -> str:
    """Sortable fmlint-prefixed run id (the obs convention, without
    importing the obs plane)."""
    return ("fmlint-" + time.strftime("%Y%m%d-%H%M%S", time.gmtime())
            + f"-p{os.getpid()}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fmlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--repo", default=REPO,
                    help="repo root to analyze (default: this checkout)")
    ap.add_argument("--rules", default=None,
                    help="comma-separated rule ids (default: all)")
    ap.add_argument("--baseline", default=None,
                    help="baseline path (default: <repo>/fmlint_baseline"
                         "_torch.json; missing file = empty baseline)")
    ap.add_argument("--write-baseline", action="store_true",
                    help="absorb the current findings into the baseline "
                         "and exit 0")
    ap.add_argument("--run-id", default=None,
                    help="write the report into artifacts/obs/<run-id>/ "
                         "(default: a fresh fmlint-… id)")
    ap.add_argument("--out", default=None,
                    help="report directory override (bypasses "
                         "artifacts/obs/)")
    ap.add_argument("--no-report", action="store_true",
                    help="skip writing the JSON report")
    ap.add_argument("--list-rules", action="store_true",
                    help="print the rule glossary and exit")
    ap.add_argument("--quiet", action="store_true",
                    help="suppress per-finding stderr lines")
    args = ap.parse_args(argv)

    # Rules always come from THIS checkout's analysis package — --repo
    # only changes what gets scanned (synthetic fixture repos in tests).
    analysis = load_analysis()

    if args.list_rules:
        for r in analysis.all_rules():
            print(f"{r.id:24s} {r.doc}")
        return 0

    rules = None
    if args.rules:
        rules = [r.strip() for r in args.rules.split(",") if r.strip()]
        unknown = [r for r in rules if r not in analysis.RULES]
        if unknown:
            print(f"unknown rule id(s): {unknown} "
                  "(see --list-rules)", file=sys.stderr)
            return 2

    baseline_path = args.baseline or os.path.join(
        args.repo, analysis.BASELINE_FILE)
    run_id = args.run_id or mint_run_id()
    report = analysis.analyze(repo=args.repo,
                              baseline_path=baseline_path,
                              rules=rules, run_id=run_id)

    if args.write_baseline:
        # A --rules subset only rewrites the SELECTED rules' cells —
        # every other rule's baselined debt survives untouched (a
        # targeted run must never erase another rule's ledger).
        merged = {r: files for r, files
                  in analysis.load_baseline(baseline_path).items()
                  if rules is not None and r not in rules}
        merged.update(report["counts"])
        analysis.write_baseline_counts(baseline_path, merged)
        print(f"baseline written: {baseline_path} "
              f"({report['total_findings']} finding(s) absorbed"
              + (f" for rules {rules}" if rules is not None else "")
              + ")")
        return 0

    if not args.no_report:
        out_dir = args.out or os.path.join(
            args.repo, "artifacts", "obs", run_id)
        path = analysis.write_report(report, out_dir)
        if path:
            print(f"report: {os.path.relpath(path, args.repo)}",
                  file=sys.stderr)

    if not args.quiet:
        for f in report["new"]:
            ctx_name = f["func"] or "<module>"
            print(f"{f['path']}:{f['line']} [{ctx_name}] "
                  f"{f['rule']}: {f['message']}", file=sys.stderr)
    n_new = len(report["new"])
    n_sup = len(report["suppressed"])
    n_base = report["baselined_total"]
    burn = len(report["burned_down"])
    print(f"fmlint: {report['total_findings']} finding(s) — "
          f"{n_new} new, {n_base} baselined, {n_sup} suppressed"
          + (f", {burn} baseline cell(s) burned down "
             "(run --write-baseline)" if burn else ""),
          file=sys.stderr)
    return 1 if n_new else 0


if __name__ == "__main__":
    sys.exit(main())
