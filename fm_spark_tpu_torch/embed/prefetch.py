"""Async batch-keyed bucket prefetcher for the tiered embedding store
(the port of ``fm_spark_tpu/embed/prefetch.py``, as it is).

The double-buffer idiom of ``data/pipeline.py``'s ``Prefetcher`` applied
to RESIDENCY instead of batch assembly: a producer thread pulls batches
from the upstream source ahead of the consumer, inspects each batch's
hashed ids, and stages on the card every bucket the hot tier neither
holds nor has staged (``TieredStore.stage``: pinned buffer, copy on a
side stream, an event) — so by the time the step loop reaches batch
N+1, its cold buckets are (usually) already device buffers waiting in
:class:`~fm_spark_tpu_torch.embed.store.TieredStore`'s staging table. A bucket the producer did not win is a counted, timed miss in
``TieredStore.begin_batch`` — the pipeline hides latency, never
accounting.

Correctness leans entirely on the store's locking and versioning: the
producer thread calls only :meth:`TieredStore.stage`, which takes the
store lock around every shared read/write and discards any staged
buffer whose bucket was evicted-and-flushed after the cold read
(version mismatch). This class's OWN shared state (queue handoff,
stored exception, shutdown flag) follows the data-pipeline prefetcher's
discipline exactly: the queue is the synchronization point, and the
flag/exception slots are written by one side and read after a queue
rendezvous by the other.
"""

from __future__ import annotations

import queue
import threading

from fm_spark_tpu_torch.embed.store import TieredStore

__all__ = ["BucketPrefetcher"]

_STOP = object()


class BucketPrefetcher:
    """Iterate ``batches`` while staging each batch's cold buckets ahead.

    ``batches`` yields ``(ids, vals, labels, weights)`` tuples (the
    training-loop contract); ``depth`` bounds how many batches the
    producer may run ahead of the consumer (2 = classic double
    buffering: while the step chews batch N, batch N+1's buckets are in
    flight). The producer stages a batch's buckets BEFORE handing the
    batch over, so with ``depth >= 2`` the consumer's ``begin_batch``
    for batch N overlaps the staging of batch N+1.

    Exceptions on the producer (including injected chaos from the
    ``embed_prefetch`` fault point) are re-raised at the consumer's next
    ``next()`` — same contract as ``data.Prefetcher``.

    Checkpoint semantics follow ``data.Prefetcher`` exactly: the
    producer runs AHEAD of the training loop, so the upstream source's
    live cursor must never be saved. The producer snapshots
    ``batches.state()`` alongside each batch; :meth:`state` returns the
    snapshot of the LAST CONSUMED batch — resuming from it replays
    exactly the batches the training loop never saw
    (tests/test_torch_embed_tier.py's chaos drill asserts the resumed run
    is bitwise the uninterrupted one).
    """

    def __init__(self, batches, store: TieredStore, depth: int = 2):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._store = store
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._lock = threading.Lock()
        # Guarded by _lock: the producer writes, the consumer reads.
        self._error: BaseException | None = None
        self._closed = False
        self._has_state = hasattr(batches, "state")
        self._last_state = batches.state() if self._has_state else None
        self._thread = threading.Thread(
            target=self._produce, args=(batches,),
            name="embed-bucket-prefetch", daemon=True)
        self._thread.start()

    def _produce(self, batches) -> None:
        try:
            for batch in iter(batches):
                with self._lock:
                    if self._closed:
                        return
                # Stage batch's buckets first, then hand the batch over:
                # the consumer only sees a batch whose staging attempt
                # already ran (hit or counted-miss, never in-limbo).
                self._store.stage(batch[0])
                cursor = batches.state() if self._has_state else None
                self._queue.put((batch, cursor))
        except BaseException as e:  # noqa: BLE001 — re-raised at next()
            with self._lock:
                self._error = e
        finally:
            self._queue.put(_STOP)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is _STOP:
            with self._lock:
                err = self._error
            if err is not None:
                raise err
            raise StopIteration
        batch, cursor = item
        with self._lock:
            self._last_state = cursor
        return batch

    def state(self):
        """The upstream cursor as of the last CONSUMED batch (never the
        producer's read-ahead cursor) — the checkpointable one."""
        with self._lock:
            return self._last_state

    def close(self) -> None:
        """Stop the producer and drain the handoff queue."""
        with self._lock:
            self._closed = True
        # Drain to unblock a producer parked on a full queue; the
        # producer observes the flag before its next batch and exits.
        while self._thread.is_alive():
            try:
                self._queue.get(timeout=0.05)
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
