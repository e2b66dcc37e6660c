"""Host batching (the port of ``fm_spark_tpu/data/pipeline.py``):
deterministic epoch-shuffled batches, the compact-aux wrapper, a
prefetcher that moves batches to the card off the critical path, and the
ordered pass used by evaluation and predict."""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch


def train_test_split(ids, vals, labels, test_fraction=0.2, seed=0):
    """Deterministic shuffled split (the same permutation as the JAX
    package's from the same seed)."""
    n = ids.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    cut = int(n * (1.0 - test_fraction))
    tr, te = perm[:cut], perm[cut:]
    return (ids[tr], vals[tr], labels[tr]), (ids[te], vals[te], labels[te])


class Batches:
    """Epoch-shuffling minibatch iterator over fixed-nnz arrays, in the JAX
    package's order: epoch ``e`` visits
    ``default_rng((seed, e)).permutation(n)``. The final partial batch of
    an epoch is padded to full size with ``weight=0`` examples."""

    def __init__(self, ids, vals, labels, batch_size: int, seed: int = 0):
        self.ids = np.ascontiguousarray(ids)
        self.vals = np.ascontiguousarray(vals)
        self.labels = np.ascontiguousarray(labels)
        self.batch_size = int(batch_size)
        if self.ids.shape[0] == 0:
            raise ValueError("empty dataset")
        self.seed = int(seed)
        self.epoch = 0
        self.index = 0
        self._perm = None

    @property
    def num_examples(self):
        return self.ids.shape[0]

    def _epoch_perm(self):
        if self._perm is None:
            rng = np.random.default_rng((self.seed, self.epoch))
            self._perm = rng.permutation(self.num_examples)
        return self._perm

    def state(self) -> dict:
        return {"epoch": self.epoch, "index": self.index, "seed": self.seed}

    def next_batch(self):
        """Return ``(ids, vals, labels, weights)``, advancing the cursor."""
        n, b = self.num_examples, self.batch_size
        perm = self._epoch_perm()
        start = self.index
        end = start + b
        if end <= n:
            sel = perm[start:end]
            weights = np.ones((b,), np.float32)
            self.index = end
        elif start >= n:
            self.epoch += 1
            self.index = 0
            self._perm = None
            return self.next_batch()
        else:
            sel = perm[start:n]
            pad = b - sel.shape[0]
            weights = np.concatenate(
                [np.ones(sel.shape[0], np.float32), np.zeros(pad, np.float32)]
            )
            sel = np.concatenate([sel, np.zeros(pad, np.int64)])
            self.epoch += 1
            self.index = 0
            self._perm = None
        return self.ids[sel], self.vals[sel], self.labels[sel], weights

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


class DedupAuxBatches:
    """Wraps a batch source and appends the COMPACT aux
    (:func:`~fm_spark_tpu_torch.ops.scatter.compact_aux` at ``cap``) to each
    batch: ``(ids, vals, labels, weights, aux)``. Wrap it BEFORE
    :class:`Prefetcher`, so the sorts run in the producer thread.

    ``overflow='error'`` propagates
    :class:`~fm_spark_tpu_torch.ops.scatter.CompactCapOverflow`; the
    reference's ``'split'`` policy is not ported yet (ROADMAP Queue 1), nor
    is the non-compact aux (``cap=0``). ``aux_ms`` holds the host time of
    each aux build, in milliseconds.
    """

    def __init__(self, source, cap: int, overflow: str = "error"):
        if overflow == "split":
            raise ValueError("compact_overflow='split' is not ported yet "
                             "(ROADMAP Queue 1)")
        if overflow != "error":
            raise ValueError(
                f"DedupAuxBatches overflow must be 'error' or 'split', "
                f"got {overflow!r}")
        if cap <= 0:
            raise ValueError("the non-compact dedup aux (cap=0) is not "
                             "ported yet (ROADMAP Queue 1)")
        self._source = source
        self._cap = int(cap)
        self.aux_ms: list[float] = []

    def next_batch(self):
        from fm_spark_tpu_torch.ops.scatter import compact_aux

        ids, vals, labels, weights = (np.asarray(a)
                                      for a in self._source.next_batch())
        t0 = time.perf_counter()
        aux = compact_aux(ids, self._cap)
        self.aux_ms.append((time.perf_counter() - t0) * 1e3)
        return ids, vals, labels, weights, aux

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()

    def state(self):
        return self._source.state()


def _tree_map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return tuple(_tree_map(fn, b) for b in batch)
    return fn(batch)


class Prefetcher:
    """Background-thread batch prefetch with a bounded queue, moving each
    batch (a tuple of numpy arrays, nested tuples allowed) onto ``device``
    as tensors off the critical path.

    On CUDA the producer copies each array into pinned host memory and
    from there to the card with a ``non_blocking`` copy on a side stream,
    then records an event on that stream. The consumer makes its current
    stream wait for that event before it returns the batch, and calls
    ``record_stream`` on each tensor, so the compute stream never reads a
    buffer before its copy lands and the allocator never hands the
    buffer's memory to the side stream while the compute stream may still
    read it. The pinned buffers come from PyTorch's caching host
    allocator, which records the copy on the side stream and reuses a
    buffer only once that copy has completed, so a pinned buffer is never
    refilled while its copy is in flight.

    ``state()`` is the wrapped source's cursor as of the last consumed
    batch.
    """

    def __init__(self, source, depth: int = 2, device="cpu"):
        self._source = source
        self._device = torch.device(device)
        self._has_state = hasattr(source, "state")
        self._last_state = source.state() if self._has_state else None
        self._q = queue.Queue(maxsize=max(1, int(depth)))
        self._stop = threading.Event()
        self._terminal = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _to_device(self, batch, side):
        if side is None:
            return _tree_map(
                lambda a: torch.from_numpy(np.ascontiguousarray(a)), batch), None
        with torch.cuda.stream(side):
            out = _tree_map(
                lambda a: torch.from_numpy(np.ascontiguousarray(a))
                .pin_memory().to(self._device, non_blocking=True), batch)
            ready = torch.cuda.Event()
            ready.record(side)
        return out, ready

    def _produce(self):
        try:
            side = None
            if self._device.type == "cuda":
                torch.cuda.set_device(self._device)
                side = torch.cuda.Stream(self._device)
            while not self._stop.is_set():
                batch = self._source.next_batch()
                state = self._source.state() if self._has_state else None
                item = (*self._to_device(batch, side), state, None)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except StopIteration:
            self._q.put((None, None, None, StopIteration()))
        except BaseException as e:  # noqa: BLE001 — surfaced to the consumer
            self._q.put((None, None, None, e))

    def next_batch(self):
        if self._terminal is not None:
            if isinstance(self._terminal, StopIteration):
                raise StopIteration
            raise self._terminal
        batch, ready, state, err = self._q.get()
        if err is not None:
            self._terminal = err
            if isinstance(err, StopIteration):
                raise StopIteration
            raise err
        if ready is not None:
            cur = torch.cuda.current_stream(self._device)
            cur.wait_event(ready)
            _tree_map(lambda t: t.record_stream(cur), batch)
        self._last_state = state
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()

    def state(self) -> dict:
        if not self._has_state:
            raise AttributeError("wrapped source has no state()")
        return self._last_state

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._terminal is None:
            self._terminal = RuntimeError("Prefetcher is closed")
        try:
            self._q.put_nowait((None, None, None, self._terminal))
        except queue.Full:
            pass
        self._thread.join(timeout=5)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iterate_once(ids, vals, labels, batch_size: int):
    """One ordered, finite pass over the data — for evaluation/predict.

    Yields ``(ids, vals, labels, weight)``; the final partial batch is
    zero-padded with ``weight=0`` so every batch has one shape.
    """
    n = ids.shape[0]
    for start in range(0, n, batch_size):
        end = min(start + batch_size, n)
        b = end - start
        if b == batch_size:
            yield ids[start:end], vals[start:end], labels[start:end], np.ones(
                (batch_size,), np.float32
            )
        else:
            pad = batch_size - b
            yield (
                np.concatenate([ids[start:end], np.zeros((pad,) + ids.shape[1:], ids.dtype)]),
                np.concatenate([vals[start:end], np.zeros((pad,) + vals.shape[1:], vals.dtype)]),
                np.concatenate([labels[start:end], np.zeros((pad,), labels.dtype)]),
                np.concatenate([np.ones((b,), np.float32), np.zeros((pad,), np.float32)]),
            )
