"""The fault points of the port: the names of
``fm_spark_tpu/resilience/faults.py``, each a call to :func:`inject` where
the reference injects its faults, without the reference's fault plans.

:func:`inject` is a no-op here: the reference's fault plans, actions
and cross-process occurrence counters are not ported yet (ROADMAP Queue 1
item 13). Tests patch it to raise (or stall) at one point and so drive
the same recovery paths a planned fault would:

- ``ckpt_demote``: a demotion's tombstone is durable and the
  ``last_good`` pointer is not yet republished
  (:meth:`~fm_spark_tpu_torch.checkpoint.Checkpointer.demote`,
  ``demote_newer_than``);
- ``ckpt_gc``: the emergency GC's intent is journaled and nothing is
  deleted yet (``Checkpointer._emergency_gc``);
- ``serve_reload``: inside a reload attempt, before the chain is read
  (:meth:`~fm_spark_tpu_torch.serve.reload.ReloadFollower.poll_once`);
- ``ingest_truncate``: once per chunk a raw-text reader reads
  (``data/stream.ShardReader``, ``data/native_stream``);
- ``ingest_corrupt``: once per record before its parse on the Python
  path (``data/stream.StreamBatches``), once per parsed chunk on the
  native path. A :class:`FaultInjected` there is a corrupt record and
  takes the data policy's path; an :class:`InjectedDeviceLoss`
  propagates;
- ``embed_prefetch``: once per bucket the tiered store stages, on the
  prefetch thread, before its cold read
  (``embed/store.TieredStore.stage``): a device loss mid-prefetch
  surfaces at the consumer's next batch;
- ``embed_evict``: once per eviction, before its dirty write-back
  (``TieredStore._flush_slot``): the kill-mid-eviction window;
- ``online_eval``: once per eval day of the continuous-learning loop,
  inside its ``online_eval`` watchdog phase (``online.run_online``).

The two exception classes are the reference's: what a planned ``error``
and ``device_loss`` action raise.
"""

from __future__ import annotations

__all__ = ["KNOWN_POINTS", "FaultInjected", "InjectedDeviceLoss", "inject"]

#: The fault points this package calls.
KNOWN_POINTS = ("ckpt_demote", "ckpt_gc", "serve_reload", "ingest_truncate",
                "ingest_corrupt", "embed_prefetch", "embed_evict",
                "online_eval")


class FaultInjected(RuntimeError):
    """An injected generic failure (action ``error``)."""


class InjectedDeviceLoss(FaultInjected):
    """An injected mid-step device loss, with the text a real detachment
    produces."""

    def __init__(self, point: str, occurrence: int):
        super().__init__(
            f"INTERNAL: device lost / attachment detached "
            f"(injected fault at {point}#{occurrence})"
        )


def inject(point: str) -> None:
    """The fault point ``point``: nothing happens (no plan can be active)."""
    if point not in KNOWN_POINTS:
        raise ValueError(f"unknown fault point {point!r}; known: "
                         f"{', '.join(KNOWN_POINTS)}")
