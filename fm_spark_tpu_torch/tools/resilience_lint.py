"""Compatibility shim over the port's fmlint registry (the port of
``tools/resilience_lint.py``).

The six historical AST checks — the EventLog-only scope, the
library-wide bare-print ban, the kernel structured-fallback rule, the
wall-clock-duration ban, the bench leg-record provenance keys, and the
fault/phase/trigger coverage rules — are REGISTERED RULES in
:mod:`fm_spark_tpu_torch.analysis`; see
``python -m fm_spark_tpu_torch.tools.fmlint`` for the CLI, inline
suppressions, and the committed baseline. This module keeps the old
entry points; each delegates to the registry and renders findings in
the historical ``path:line [func] message`` string form.

Usage::

    python -m fm_spark_tpu_torch.tools.resilience_lint   # exit 1 on
                                                         # violations
"""

from __future__ import annotations

import os
import sys

from fm_spark_tpu_torch.tools.fmlint import REPO, load_analysis

_analysis = load_analysis()

#: Historical names, re-exported for old callers.
RESILIENCE_DIR = os.path.join(REPO, "fm_spark_tpu_torch", "resilience")
SERVE_DIR = os.path.join(REPO, "fm_spark_tpu_torch", "serve")
LIBRARY_DIR = os.path.join(REPO, "fm_spark_tpu_torch")
EXTRA_FILES = tuple(
    os.path.join(REPO, *rel.split("/"))
    for rel in _analysis.rules_obs.STRICT_EXTRA_FILES)


def _render(findings) -> list[str]:
    return [f"{f.path}:{f.line} [{f.func or '<module>'}] {f.message}"
            for f in findings]


def _reject_overrides(**kw) -> None:
    """The shim scans THE SHIPPED REPO through the registry's own
    scope. The old per-call root/path overrides cannot be honored here
    — silently returning whole-repo results to a caller who passed a
    fixture dir would make their check vacuously pass/fail — so a
    non-None override is a loud error pointing at the replacement
    (``analysis.Context(repo)`` + ``run_rules``)."""
    bad = {k: v for k, v in kw.items() if v is not None}
    if bad:
        raise TypeError(
            f"resilience_lint is a shim over the fmlint registry and "
            f"no longer honors {sorted(bad)} — scan a custom root via "
            "fm_spark_tpu_torch.analysis: run_rules(Context(repo), "
            "rules=[...]) (see tests/test_torch_fmlint.py)")


def _run(rule_id: str) -> list[str]:
    found, _suppressed = _analysis.run_rules(
        _analysis.Context(REPO), rules=[rule_id])
    return _render(found)


def violations(root=None) -> list[str]:
    """The strict EventLog-only scope over the shipped tree."""
    _reject_overrides(root=root)
    return _run("eventlog-only")


def library_print_violations(root=None) -> list[str]:
    _reject_overrides(root=root)
    return _run("bare-print")


def kernel_fallback_violations(root=None) -> list[str]:
    _reject_overrides(root=root)
    return _run("kernel-fallback")


def duration_time_violations(root=None) -> list[str]:
    _reject_overrides(root=root)
    return _run("wallclock-duration")


def bench_leg_record_violations(path=None) -> list[str]:
    _reject_overrides(path=path)
    return _run("leg-provenance")


def _coverage(kind_prefix: str) -> list[str]:
    found, _ = _analysis.run_rules(_analysis.Context(REPO),
                                   rules=["registry-coverage"])
    return _render([f for f in found
                    if kind_prefix in f.message])


def fault_point_coverage_violations(tests_dir=None,
                                    faults_path=None) -> list[str]:
    _reject_overrides(tests_dir=tests_dir, faults_path=faults_path)
    return _coverage("fault point")


def watchdog_phase_coverage_violations(tests_dir=None,
                                       watchdog_path=None) -> list[str]:
    _reject_overrides(tests_dir=tests_dir, watchdog_path=watchdog_path)
    return _coverage("watchdog phase")


def introspect_trigger_coverage_violations(tests_dir=None,
                                           introspect_path=None
                                           ) -> list[str]:
    _reject_overrides(tests_dir=tests_dir,
                      introspect_path=introspect_path)
    return _coverage("introspection trigger")


def main() -> int:
    """Full fmlint run (all rules, baseline applied) — the historical
    exit-status contract: 0 clean, 1 on violations."""
    from fm_spark_tpu_torch.tools import fmlint

    return fmlint.main(["--no-report", "--quiet"])


if __name__ == "__main__":
    sys.exit(main())
