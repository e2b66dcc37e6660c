"""Resilience planes of the port: the fault plans and their points
(:mod:`.faults`), the storage and network fault planes (:mod:`.iofaults`,
:mod:`.netfaults`), the divergence and drift guard (:mod:`.divergence`),
the per-phase deadline watchdog (:mod:`.watchdog`), the retry, backoff
and circuit-breaker supervisor (:mod:`.supervisor`), the elastic
degraded mode on top of it (:mod:`.elastic`), and the chaos campaign that
drives them all under seeded multi-fault schedules (:mod:`.chaos`, run by
``python -m fm_spark_tpu_torch.tools.chaos_drill``) with its standalone
auditors (:mod:`.chaos_audit`)."""

from fm_spark_tpu_torch.resilience import faults, watchdog
from fm_spark_tpu_torch.resilience.elastic import (
    ElasticController,
    ElasticExhausted,
    classify_failures,
    normalize_failure,
)
from fm_spark_tpu_torch.resilience.faults import (
    FaultInjected,
    FaultPlan,
    InjectedDeviceLoss,
    inject,
    is_device_loss,
)
from fm_spark_tpu_torch.resilience.supervisor import (
    BackoffPolicy,
    CircuitOpen,
    RetriesExhausted,
    Supervisor,
    device_probe,
)
from fm_spark_tpu_torch.resilience.watchdog import HangDetected

__all__ = [
    "BackoffPolicy",
    "CircuitOpen",
    "ElasticController",
    "ElasticExhausted",
    "FaultInjected",
    "FaultPlan",
    "HangDetected",
    "InjectedDeviceLoss",
    "RetriesExhausted",
    "Supervisor",
    "classify_failures",
    "device_probe",
    "faults",
    "inject",
    "is_device_loss",
    "normalize_failure",
    "watchdog",
]
