"""Micro-batched predict engine: the low-latency request path (the port
of ``fm_spark_tpu/serve/engine.py``).

Shape discipline as in the reference: a request of ``n`` rows is padded
(id 0, value 0) to the smallest configured **batch bucket** ``>= n`` and
the padded rows are sliced off before any caller sees them; per-row
scores are row-independent, so padding never changes an answer. Each
bucket owns a host staging buffer — page-locked on CUDA, so the copy to
the device is asynchronous — and :meth:`PredictEngine.warmup` builds
the kernels and launches every bucket once before serving.

Request path: callers :meth:`~PredictEngine.submit` requests of
1..bucket-max rows; a worker thread takes the first queued request and
accumulates more until the **latency budget** (or the earliest request
deadline) expires or the largest bucket fills, then runs ONE padded
batch and splits the results back per request. Every request is
answered exactly once — failures included — and each from exactly one
model :class:`Generation`: the worker reads the generation reference
once per batch, and :meth:`~PredictEngine.swap_generation` replaces it
with a single reference store.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from fm_spark_tpu_torch import obs, resolve_device

__all__ = ["DEFAULT_BUCKETS", "Generation", "PredictEngine", "ServeFuture"]

#: Default padded-batch buckets: batch-1 for pure-latency traffic up
#: through 512 rows per dispatch.
DEFAULT_BUCKETS = (1, 8, 64, 512)


def _to_device(params, device):
    if isinstance(params, torch.Tensor):
        return params.to(device)
    if isinstance(params, dict):
        return {k: _to_device(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [_to_device(v, device) for v in params]
    raise TypeError(f"unsupported parameter leaf {type(params).__name__}")


class Generation:
    """One immutable served model generation. The engine holds exactly
    one reference; a swap replaces the reference, never the contents."""

    __slots__ = ("params", "step", "gen_id")

    def __init__(self, params, step: int, gen_id: int):
        self.params = params
        self.step = int(step)
        self.gen_id = int(gen_id)


class ServeFuture:
    """Exactly-once result slot for one submitted request."""

    __slots__ = ("_event", "_value", "_exc")

    def __init__(self):
        self._event = threading.Event()
        self._value = None
        self._exc = None

    def _set(self, value) -> None:
        self._value = value
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: float | None = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("serve request not answered in time")
        if self._exc is not None:
            raise self._exc
        return self._value


class _Request:
    __slots__ = ("ids", "vals", "n", "future", "t_submit", "deadline")

    def __init__(self, ids, vals, deadline=None):
        self.ids = ids
        self.vals = vals
        self.n = int(ids.shape[0])
        self.future = ServeFuture()
        self.t_submit = time.perf_counter()
        #: Absolute ``time.monotonic()`` deadline (None = unbounded): the
        #: coalescer never holds a request past it waiting for
        #: batch-mates, and never scores one that expired in the queue.
        self.deadline = deadline


_STOP = object()


class PredictEngine:
    """Bucketed scoring over an atomically swappable generation.

    ``nnz`` pins the per-row feature width; every request must match it.
    ``device`` is where the model runs (default: the current CUDA
    device; ``"cpu"`` runs the kernels' plain versions). Call
    :meth:`warmup` once before serving; then :meth:`submit` /
    :meth:`predict` for coalesced serving or :meth:`score` for direct
    offline batches.
    """

    def __init__(self, spec, params, *, nnz: int | None = None,
                 step: int = 0, buckets=DEFAULT_BUCKETS,
                 latency_budget_ms: float = 2.0, device=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.buckets = tuple(sorted({int(b) for b in buckets}))
        if not self.buckets or self.buckets[0] < 1:
            raise ValueError(f"need >= 1 positive bucket, got {buckets}")
        self.nnz = int(nnz if nnz is not None
                       else getattr(spec, "num_fields", 0))
        if self.nnz < 1:
            raise ValueError(
                "engine needs the per-row feature width: pass nnz= "
                "(specs without num_fields cannot imply it)")
        self.latency_budget_s = max(float(latency_budget_ms), 0.0) / 1e3
        self._gen = Generation(_to_device(params, self.device), step,
                               gen_id=0)
        obs.gauge("serve/generation_step").set(self._gen.step)
        # bucket -> (ids, vals) host staging buffers, made by warmup().
        self._staging: dict[int, tuple[torch.Tensor, torch.Tensor]] = {}
        # One dispatch at a time: it owns the staging buffer it fills.
        self._dispatch_lock = threading.Lock()
        self._queue: queue.Queue = queue.Queue()
        self._carry: _Request | None = None
        self._worker: threading.Thread | None = None
        self._worker_lock = threading.Lock()
        self._closed = False

    # -------------------------------------------------------- generations

    def generation(self) -> Generation:
        """The CURRENT generation reference."""
        return self._gen

    def swap_generation(self, params, step: int) -> Generation:
        """Install a new generation via a single reference assignment.
        The new params are fully on the device before the store, so a
        concurrent batch sees either the old reference or the new one;
        batches already running on the old generation finish on it."""
        old = self._gen
        gen = Generation(_to_device(params, self.device), step,
                         gen_id=old.gen_id + 1)
        self._gen = gen
        obs.counter("serve.swaps_total").add(1)
        obs.gauge("serve/generation_step").set(gen.step)
        return gen

    # ------------------------------------------------------------- warmup

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(
            f"request of {n} rows exceeds the largest bucket "
            f"{self.buckets[-1]} (predict() chunks; submit() callers "
            "must pre-chunk)")

    def _device_ctx(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def warmup(self) -> dict:
        """Build the kernels, make each bucket's staging buffers and
        launch every bucket once. Returns ``{"seconds", "buckets"}``."""
        t0 = time.perf_counter()
        pin = self.device.type == "cuda"
        if pin:
            from fm_spark_tpu_torch.kernels import build

            build.build_all()
        for b in self.buckets:
            if b not in self._staging:
                self._staging[b] = (
                    torch.zeros((b, self.nnz), dtype=torch.int32,
                                pin_memory=pin),
                    torch.zeros((b, self.nnz), dtype=torch.float32,
                                pin_memory=pin))
            zeros_i = np.zeros((b, self.nnz), np.int32)
            self._dispatch(self._gen, zeros_i, zeros_i.astype(np.float32))
        return {"seconds": time.perf_counter() - t0,
                "buckets": list(self.buckets)}

    # ------------------------------------------------------------ execute

    def _coerce(self, ids, vals) -> tuple[np.ndarray, np.ndarray]:
        ids = np.asarray(ids)
        vals = np.asarray(vals)
        if ids.ndim != 2 or ids.shape != vals.shape:
            raise ValueError(
                f"want matching (n, {self.nnz}) ids/vals, got "
                f"{ids.shape} / {vals.shape}")
        if ids.shape[1] != self.nnz:
            raise ValueError(
                f"request width {ids.shape[1]} != engine nnz {self.nnz}; "
                "build the engine with the request width")
        if ids.shape[0] < 1:
            raise ValueError("empty request")
        return (ids.astype(np.int32, copy=False),
                vals.astype(np.float32, copy=False))

    def _dispatch(self, gen: Generation, ids: np.ndarray,
                  vals: np.ndarray) -> np.ndarray:
        """Stage ``ids``/``vals`` into their bucket's buffers (padding
        with id 0, value 0), run the model, return the first ``n``
        predictions as host floats."""
        n = ids.shape[0]
        bucket = self._bucket_for(n)
        staged = self._staging.get(bucket)
        if staged is None:
            raise RuntimeError(
                f"bucket {bucket} not warmed — call warmup() before serving")
        ids_h, vals_h = staged
        with self._dispatch_lock, self._device_ctx():
            ids_np, vals_np = ids_h.numpy(), vals_h.numpy()
            ids_np[:n] = ids
            ids_np[n:] = 0
            vals_np[:n] = vals
            vals_np[n:] = 0.0
            # The staging buffers are reused only after .cpu() below has
            # waited for this dispatch, so the async copies are safe.
            # Predictions in a bf16 compute dtype widen to float32: numpy
            # has no bf16.
            out = self.spec.predict(
                gen.params,
                ids_h.to(self.device, non_blocking=True),
                vals_h.to(self.device, non_blocking=True)).float().cpu()
        return out.numpy()[:n]

    def _execute(self, gen: Generation, ids: np.ndarray,
                 vals: np.ndarray) -> np.ndarray:
        """One padded-bucket dispatch on ``gen`` with its metrics."""
        n = ids.shape[0]
        t0 = time.perf_counter()
        out = self._dispatch(gen, ids, vals)
        obs.histogram("serve/batch_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        obs.counter("serve.batches_total").add(1)
        obs.counter("serve.rows_total").add(n)
        pad = self._bucket_for(n) - n
        if pad:
            obs.counter("serve.padded_rows_total").add(pad)
        return out

    def score(self, ids, vals) -> np.ndarray:
        """Direct (non-coalesced) bucketed scoring — the offline batch
        path ``cli predict`` uses. Chunks inputs wider than the largest
        bucket; output order matches input order."""
        ids, vals = self._coerce(ids, vals)
        gen = self._gen
        cap = self.buckets[-1]
        return np.concatenate([
            self._execute(gen, ids[lo:lo + cap], vals[lo:lo + cap])
            for lo in range(0, ids.shape[0], cap)
        ])

    # ---------------------------------------------------------- coalescer

    def _ensure_worker(self) -> None:
        with self._worker_lock:
            if self._closed:
                raise RuntimeError("engine is closed")
            if self._worker is None or not self._worker.is_alive():
                self._worker = threading.Thread(
                    target=self._run, name="fm-spark-torch-serve-batcher",
                    daemon=True)
                self._worker.start()

    def submit(self, ids, vals, deadline: float | None = None) -> ServeFuture:
        """Enqueue one request (<= bucket-max rows) for coalescing;
        returns its :class:`ServeFuture`. ``deadline`` is an absolute
        ``time.monotonic()`` timestamp: a request that expires while
        still queued is answered with :class:`TimeoutError`."""
        ids, vals = self._coerce(ids, vals)
        if ids.shape[0] > self.buckets[-1]:
            raise ValueError(
                f"submit() takes at most bucket-max ({self.buckets[-1]}) "
                "rows per request; use predict() to auto-chunk")
        self._ensure_worker()
        req = _Request(ids, vals, deadline=deadline)
        obs.counter("serve.requests_total").add(1)
        self._queue.put(req)
        return req.future

    def predict(self, ids, vals, timeout: float | None = 60.0) -> np.ndarray:
        """Submit-and-wait; wide inputs are chunked to bucket-max and
        reassembled in order."""
        ids, vals = self._coerce(ids, vals)
        cap = self.buckets[-1]
        futures = [self.submit(ids[lo:lo + cap], vals[lo:lo + cap])
                   for lo in range(0, ids.shape[0], cap)]
        return np.concatenate([f.result(timeout) for f in futures])

    def _gather(self) -> list[_Request] | None:
        """Block for the first request, then accumulate under the
        latency budget / until bucket-max; ``None`` = stop."""
        first = self._carry
        self._carry = None
        if first is None:
            first = self._queue.get()
        if first is _STOP:
            return None
        batch = [first]
        rows = first.n
        cap = self.buckets[-1]
        deadline = time.monotonic() + self.latency_budget_s
        if first.deadline is not None:
            deadline = min(deadline, first.deadline)
        while rows < cap:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _STOP:
                # Finish this batch, then stop: queued requests are
                # answered, never dropped.
                self._queue.put(_STOP)
                break
            if rows + nxt.n > cap:
                self._carry = nxt
                break
            batch.append(nxt)
            rows += nxt.n
            if nxt.deadline is not None:
                deadline = min(deadline, nxt.deadline)
        return batch

    def _run(self) -> None:
        while True:
            batch = self._gather()
            if batch is None:
                return
            now = time.monotonic()
            expired = [r for r in batch
                       if r.deadline is not None and r.deadline < now]
            if expired:
                obs.counter("serve.deadline_expired_total").add(len(expired))
                for r in expired:
                    r.future._set_exception(TimeoutError(
                        "request deadline expired before dispatch"))
                batch = [r for r in batch if r not in expired]
                if not batch:
                    continue
            # ONE generation read per micro-batch (the no-torn-swap contract).
            gen = self._gen
            ids = np.concatenate([r.ids for r in batch])
            vals = np.concatenate([r.vals for r in batch])
            try:
                out = self._execute(gen, ids, vals)
            except BaseException as e:  # noqa: BLE001 — every queued
                # caller must be answered (exactly once), even by the failure.
                obs.counter("serve.batch_failures_total").add(1)
                for r in batch:
                    r.future._set_exception(e)
                if not isinstance(e, Exception):
                    raise
                continue
            t_done = time.perf_counter()
            hist = obs.histogram("serve/request_ms")
            off = 0
            for r in batch:
                r.future._set(out[off:off + r.n])
                off += r.n
                hist.observe((t_done - r.t_submit) * 1e3)

    def close(self) -> None:
        """Stop the coalescer after answering everything queued."""
        with self._worker_lock:
            self._closed = True
            worker = self._worker
        if worker is not None and worker.is_alive():
            self._queue.put(_STOP)
            worker.join(timeout=30.0)
