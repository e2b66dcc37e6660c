"""Host batching (the port of ``fm_spark_tpu/data/pipeline.py``):
deterministic epoch-shuffled batches, the reference's per-iteration
Bernoulli sample, the compact-aux wrapper, the producer-side wrappers
(:class:`MappedBatches`, :class:`StackedBatches`), a prefetcher that
moves batches to the card off the critical path (:func:`wrap_prefetch`),
and the ordered pass used by evaluation and predict.

Every wrapper passes ``state()``/``restore()`` and the raw-text stream's
``guard`` (``data/stream.RecordGuard``) through to its source."""

from __future__ import annotations

import collections
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

    def restore(self, state: dict) -> None:
        if int(state["seed"]) != self.seed:
            raise ValueError("restoring pipeline state with a different seed")
        self.epoch = int(state["epoch"])
        self.index = int(state["index"])
        self._perm = None

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


class BernoulliBatches:
    """Per-iteration Bernoulli sampling, the reference's minibatch
    semantics (``data.sample(withReplacement=false, miniBatchFraction,
    seed+i)`` per SGD iteration): every step yields the FULL dataset with a
    fresh Bernoulli(``fraction``) weight mask, so the step sees one shape
    and the weighted-mean loss averages over exactly the sampled examples.
    The mask of step ``i`` is ``default_rng((seed, 0xB3A2, i))``'s, the JAX
    package's bit for bit, so a resumed run replays the same masks."""

    def __init__(self, ids, vals, labels, fraction: float, seed: int = 0):
        if not (0.0 < fraction <= 1.0):
            raise ValueError(f"fraction must be in (0, 1], got {fraction}")
        self.ids = np.ascontiguousarray(ids)
        self.vals = np.ascontiguousarray(vals)
        self.labels = np.ascontiguousarray(labels)
        if self.ids.shape[0] == 0:
            raise ValueError("empty dataset")
        self.fraction = float(fraction)
        self.seed = int(seed)
        self.step = 0

    @property
    def num_examples(self):
        return self.ids.shape[0]

    def state(self) -> dict:
        return {"step": self.step, "seed": self.seed,
                "fraction": self.fraction}

    def restore(self, state: dict) -> None:
        for key, have in [("seed", self.seed), ("fraction", self.fraction)]:
            if key in state and state[key] != have:
                raise ValueError(
                    f"restoring sampler state with a different {key}")
        self.step = int(state["step"])

    def next_batch(self):
        rng = np.random.default_rng((self.seed, 0xB3A2, self.step))
        weights = (rng.random(self.num_examples)
                   < self.fraction).astype(np.float32)
        self.step += 1
        return self.ids, self.vals, self.labels, weights

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()


class DedupAuxBatches:
    """Wraps a batch source and appends the host-built dedup aux to each
    batch: ``(ids, vals, labels, weights, aux)`` —
    :func:`~fm_spark_tpu_torch.ops.scatter.dedup_aux` with ``cap=0``, the
    COMPACT aux (:func:`~fm_spark_tpu_torch.ops.scatter.compact_aux`) at
    ``cap > 0``. Wrap it BEFORE :class:`Prefetcher`, so the sorts run in
    the producer thread.

    ``overflow`` (compact only) picks what happens when a field's unique
    count exceeds ``cap``:

    - ``'error'`` (default): propagate
      :class:`~fm_spark_tpu_torch.ops.scatter.CompactCapOverflow`;
    - ``'split'``: halve the offending batch recursively until every
      field fits, padding each half back to the full batch with inert
      lanes (val, label and weight 0, ids copied from the half's first
      row, so padding adds no unique id), so the step's static shapes do
      not change. Each half is an exact smaller SGD step, at the cost of
      extra step indices for that batch. While halves are pending,
      ``state()`` reports the cursor from BEFORE the split batch, so a
      resume replays the whole source batch (halves already trained
      repeat; no data is skipped).

    ``aux_ms`` holds the host time of each aux build, in milliseconds.
    """

    def __init__(self, source, cap: int = 0, overflow: str = "error"):
        if overflow not in ("error", "split"):
            raise ValueError(
                f"DedupAuxBatches overflow must be 'error' or 'split', "
                f"got {overflow!r}")
        self._source = source
        self._cap = int(cap)
        self._overflow = overflow
        self._pending = collections.deque()
        self._pre_split_state = None
        self.aux_ms: list[float] = []

    def _aux(self, ids):
        from fm_spark_tpu_torch.ops.scatter import compact_aux, dedup_aux

        t0 = time.perf_counter()
        try:
            return compact_aux(ids, self._cap) if self._cap else dedup_aux(ids)
        finally:
            self.aux_ms.append((time.perf_counter() - t0) * 1e3)

    def _expand(self, batch, b_full: int):
        """``batch`` holds the real rows only (fewer than ``b_full`` after
        a split); each attempt pads to ``b_full``, and the recursion
        halves the real rows, so it ends."""
        from fm_spark_tpu_torch.ops.scatter import CompactCapOverflow

        ids, vals, labels, weights = batch
        r = ids.shape[0]
        pad = b_full - r
        if pad:
            ids = np.concatenate(
                [ids, np.broadcast_to(ids[:1], (pad,) + ids.shape[1:])])

            def zero(a):
                return np.concatenate([a, np.zeros((pad,) + a.shape[1:],
                                                   a.dtype)])
            vals, labels, weights = zero(vals), zero(labels), zero(weights)
        try:
            return [(ids, vals, labels, weights, self._aux(ids))]
        except CompactCapOverflow:
            if self._overflow != "split" or r < 2:
                raise
        h = r // 2
        return (self._expand(tuple(a[:h] for a in batch), b_full)
                + self._expand(tuple(a[h:r] for a in batch), b_full))

    def next_batch(self):
        if not self._pending:
            pre = (self._source.state() if self._overflow == "split"
                   else None)
            batch = tuple(np.asarray(a) for a in self._source.next_batch())
            parts = self._expand(batch, batch[0].shape[0])
            self._pending.extend(parts)
            self._pre_split_state = pre if len(parts) > 1 else None
        out = self._pending.popleft()
        if not self._pending:
            self._pre_split_state = None     # the split batch is consumed
        return out

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()

    def state(self):
        if self._pre_split_state is not None:
            return self._pre_split_state
        return self._source.state()

    def restore(self, state) -> None:
        self._pending.clear()
        self._pre_split_state = None
        self._source.restore(state)

    @property
    def guard(self):
        return getattr(self._source, "guard", None)


class MappedBatches:
    """A batch source with ``fn`` applied to each batch in the PRODUCER
    thread (wrap it before :class:`Prefetcher`): per-batch host transforms
    off the step's critical path, such as the field-local id conversion
    of a raw-text stream."""

    def __init__(self, source, fn):
        self._source = source
        self._fn = fn

    def next_batch(self):
        return self._fn(self._source.next_batch())

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()

    def state(self):
        return self._source.state()

    def restore(self, state) -> None:
        self._source.restore(state)

    @property
    def guard(self):
        return getattr(self._source, "guard", None)


def _stack_tree(batches):
    """Batches (tuples of numpy arrays, nested tuples allowed) stacked on a
    new leading axis, leaf by leaf."""
    first = batches[0]
    if isinstance(first, (tuple, list)):
        return tuple(_stack_tree([b[i] for b in batches])
                     for i in range(len(first)))
    return np.stack([np.asarray(b) for b in batches], axis=0)


class StackedBatches:
    """A batch source that stacks ``n`` consecutive batches on a leading
    axis, the input of the rolled steps
    (:func:`~fm_spark_tpu_torch.sparse.make_field_sparse_multistep`); the
    aux of :class:`DedupAuxBatches` stacks leaf by leaf. Wrap it BEFORE
    :class:`Prefetcher` so the copies run in the producer thread.

    ``state()`` is the source's cursor after the last stack's batches.
    ``total`` bounds how many SOURCE batches are ever consumed: the last
    stack of a finite run takes only the remainder and pads with copies of
    its last real batch (which the consumer's step count never runs), so
    the checkpointed cursor stays exact.
    """

    def __init__(self, source, n: int, total: int | None = None):
        if n < 1:
            raise ValueError(f"stack size must be >= 1, got {n}")
        self._source = source
        self._n = n
        self._left = total  # None = unbounded

    def next_batch(self):
        take = self._n if self._left is None else min(self._n, self._left)
        if take <= 0:
            raise StopIteration
        batches = [tuple(self._source.next_batch()) for _ in range(take)]
        if self._left is not None:
            self._left -= take
        batches += [batches[-1]] * (self._n - take)
        return _stack_tree(batches)

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()

    def state(self):
        return self._source.state()

    def restore(self, state) -> None:
        self._source.restore(state)

    @property
    def guard(self):
        return getattr(self._source, "guard", None)


def _tree_map(fn, batch):
    if isinstance(batch, (tuple, list)):
        return tuple(_tree_map(fn, b) for b in batch)
    return fn(batch)


def host_tensor(a, pin: bool = False) -> torch.Tensor:
    """A numpy array as a CPU tensor: shared with the array where it is
    writable and contiguous, else a copy (a read-only array, such as the
    packed reader's shared all-ones vals, is never handed out writable);
    ``pin`` copies it into pinned memory for an asynchronous copy to the
    card."""
    a = np.asarray(a)
    if pin:
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        t = torch.empty(a.shape, dtype=dtype, pin_memory=True)
        t.numpy()[...] = a
        return t
    if a.flags.writeable and a.flags.c_contiguous:
        return torch.from_numpy(a)
    return torch.from_numpy(np.array(a, order="C"))


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
            return _tree_map(host_tensor, batch), None
        with torch.cuda.stream(side):
            out = _tree_map(
                lambda a: host_tensor(a, pin=True).to(self._device,
                                                      non_blocking=True),
                batch)
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

    @property
    def guard(self):
        return getattr(self._source, "guard", None)

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


def wrap_prefetch(batches, depth: int, device="cpu"):
    """``(source, close)``: ``batches`` in a :class:`Prefetcher` of
    ``depth`` moving batches onto ``device``, or, at ``depth <= 0`` or for
    a source without ``next_batch``, ``batches`` itself and a no-op close.
    Call it after any checkpoint restore: the producer starts reading
    ahead at once. The one definition the CLI's loops and
    ``FMTrainer.fit`` share."""
    if depth <= 0 or not hasattr(batches, "next_batch"):
        return batches, lambda: None
    pf = Prefetcher(batches, depth=depth, device=device)
    return pf, pf.close


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
