"""Operational tools of the port, run as modules (``python -m
fm_spark_tpu_torch.tools.<name>``, each with a ``main(argv)``):
:mod:`.chaos_drill`, the chaos campaign's runner; :mod:`.fmlint`, the
static-analysis pass (and :mod:`.resilience_lint`, its compatibility
shim); :mod:`.run_doctor`, :mod:`.obs_report` and :mod:`.trace_report`,
the readers of a run's telemetry; :mod:`.hash_audit`, the bucket hash's
collision audit; :mod:`.build_native`, the host libraries' build and
symbol check."""
