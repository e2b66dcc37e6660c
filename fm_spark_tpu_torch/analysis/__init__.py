"""fmlint — the port's pluggable static-analysis pass (the port of
``fm_spark_tpu/analysis``).

Importing this package registers every shipped rule; see
:mod:`fm_spark_tpu_torch.analysis.core` for the framework (rule
registry, findings, inline suppressions with required reasons, the
committed baseline ``fmlint_baseline_torch.json``, JSON reports into
``artifacts/obs/<run_id>/``), :mod:`.rules_obs` for the observability,
fault-plane and kernel-fallback rules, :mod:`.rules_threads` for the
thread-safety / lock-discipline pass, and :mod:`.rules_torch` for the
PyTorch host-sync / capture-hazard pass (the counterpart of the
reference's JAX pass). ``python -m fm_spark_tpu_torch.tools.fmlint`` is
the CLI; ``tools.resilience_lint`` is the compatibility shim.

Stdlib-only on purpose: the CLI loads this package by file path so the
lint runs where torch does not import.
"""

from .core import (  # noqa: F401
    BASELINE_FILE,
    Context,
    Finding,
    RULES,
    Rule,
    SUPPRESSION_RULE,
    all_rules,
    analyze,
    compare_to_baseline,
    counts_of,
    load_baseline,
    rule,
    run_rules,
    write_baseline,
    write_baseline_counts,
    write_report,
)
from . import rules_obs, rules_threads, rules_torch  # noqa: F401

__all__ = [
    "BASELINE_FILE",
    "Context",
    "Finding",
    "RULES",
    "Rule",
    "SUPPRESSION_RULE",
    "all_rules",
    "analyze",
    "compare_to_baseline",
    "counts_of",
    "load_baseline",
    "rule",
    "run_rules",
    "write_baseline",
    "write_baseline_counts",
    "write_report",
]
