"""Micro-batched predict engine: the low-latency request path (the port
of ``fm_spark_tpu/serve/engine.py``).

Shape discipline as in the reference: a request of ``n`` rows is padded
(id 0, value 0) to the smallest configured **batch bucket** ``>= n`` and
the padded rows are sliced off before any caller sees them; per-row
scores are row-independent (FieldDeepFM's head by its fixed row tiles,
``models/field_deepfm.py``), so padding never changes an answer. Each
bucket owns host staging buffers, page-locked on CUDA.

**A CUDA graph per bucket**, the counterpart of the reference's AOT
executables: on the card :meth:`PredictEngine.warmup` builds the kernels
and captures, for each bucket, ``spec.predict`` over static device
buffers (ids ``[b, nnz]`` int32 and vals ``[b, nnz]`` float32 in,
float32 predictions out). A dispatch copies the staged rows into the
graph's inputs, replays it and copies the output back, under one lock.
The engine always serves through its graphs on the card: a capture that
fails raises and names the bucket, and nothing falls back to eager
dispatch. On the CPU (``device="cpu"``) it dispatches eagerly through the
kernels' plain versions.

A graph binds the storage of the params it was captured on, so the
graphs belong to the :class:`Generation`, each generation with its own
memory pool. :meth:`~PredictEngine.swap_generation` moves the new params
to the card, captures the new generation's graphs on a side stream (off
the request path: the worker goes on replaying the old generation's
graphs meanwhile), and only then stores the new reference. The worker
reads the reference once per batch and replays THAT generation's graph,
so no request replays a graph bound to another generation's tensors; the
old generation's graphs and tensors are freed when the last batch holding
it ends.

Request path: callers :meth:`~PredictEngine.submit` requests of
1..bucket-max rows; a worker thread takes the first queued request and
accumulates more until the **latency budget** (or the earliest request
deadline) expires or the largest bucket fills, then runs ONE padded
batch and splits the results back per request. Every request is
answered exactly once — failures included — and each from exactly one
generation.

Planes: the warm-up runs in the ``serve/warmup`` span and each batch in
``serve/batch`` (host-clock spans: no device synchronisation is added to
the replay path), its dispatch under the ``serve_request`` watchdog
phase. ``fmtorch serve --slo-ms`` arms that phase's deadline: an
overrun fails the batch with :class:`~fm_spark_tpu_torch.resilience
.watchdog.HangDetected`, counts ``serve.slo_overruns_total`` and fires
the ``serve_slo_overrun`` deep capture, with its event and flight dump
rate-limited.

The kernel wrappers count eager launches only; a replay runs the kernels
its capture recorded past them. :meth:`PredictEngine.kernel_runs` counts
those runs by wrapper name (each graph's recorded calls times its
replays).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time

import numpy as np
import torch

from fm_spark_tpu_torch import graphs, obs, ops, resolve_device
from fm_spark_tpu_torch.obs import introspect
from fm_spark_tpu_torch.resilience import watchdog

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
    one reference; a swap replaces the reference, never the contents.
    On the card it owns one CUDA graph per bucket (``graphs``) in its own
    memory pool, and ``h2d_s``/``capture_s`` time its install."""

    __slots__ = ("params", "step", "gen_id", "graphs", "pool", "h2d_s",
                 "capture_s")

    def __init__(self, params, step: int, gen_id: int):
        self.params = params
        self.step = int(step)
        self.gen_id = int(gen_id)
        self.graphs: dict[int, _BucketGraph] = {}
        self.pool = None
        self.h2d_s = 0.0
        self.capture_s = 0.0


class _BucketGraph:
    """``predict(params, ids, vals)`` of one bucket captured over static
    device buffers. ``kernels`` counts, by wrapper name, the kernel calls
    the capture recorded (what each replay runs)."""

    def __init__(self, predict, params, bucket: int, nnz: int, device,
                 pool, stream):
        self.ids = torch.zeros((bucket, nnz), dtype=torch.int32,
                               device=device)
        self.vals = torch.zeros((bucket, nnz), dtype=torch.float32,
                                device=device)
        stream.wait_stream(torch.cuda.current_stream(device))
        # The warm-up call builds the kernels and sets their opt-ins; it
        # runs on the real params, which predict only reads.
        with torch.cuda.stream(stream):
            predict(params, self.ids, self.vals)
        stream.synchronize()
        before = ops.kernel_recordings()
        self.graph = torch.cuda.CUDAGraph()
        # thread_local: the worker goes on replaying the old generation's
        # graphs and synchronising its stream while this thread captures.
        with graphs.capturing(), torch.cuda.graph(
                self.graph, pool=pool, stream=stream,
                capture_error_mode="thread_local"):
            self.out = predict(params, self.ids, self.vals).float()
        after = ops.kernel_recordings()
        self.kernels = {k: after[k] - before[k] for k in after
                        if after[k] > before[k]}


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
    __slots__ = ("ids", "vals", "n", "future", "t_submit", "t_wall",
                 "deadline", "trace")

    def __init__(self, ids, vals, deadline=None, trace=None):
        self.ids = ids
        self.vals = vals
        self.n = int(ids.shape[0])
        self.future = ServeFuture()
        self.t_submit = time.perf_counter()
        #: Wall-clock submit time: the start of the request's retroactive
        #: ``serve/coalesce`` link span.
        self.t_wall = time.time()
        #: Absolute ``time.monotonic()`` deadline (None = unbounded): the
        #: coalescer never holds a request past it waiting for
        #: batch-mates, and never scores one that expired in the queue.
        self.deadline = deadline
        #: Distributed-trace context (a ``obs.TraceContext``) or None:
        #: tags the request's link span and its latency exemplar.
        self.trace = trace


_STOP = object()


class PredictEngine:
    """Bucketed scoring over an atomically swappable generation.

    ``nnz`` pins the per-row feature width; every request must match it.
    ``device`` is where the model runs (default: the current CUDA
    device; ``"cpu"`` runs the kernels' plain versions). ``journal`` (an
    object with ``emit(event, **fields)``) receives ``serve_swap``. Call
    :meth:`warmup` once before serving; then :meth:`submit` /
    :meth:`predict` for coalesced serving or :meth:`score` for direct
    offline batches.
    """

    def __init__(self, spec, params, *, nnz: int | None = None,
                 step: int = 0, buckets=DEFAULT_BUCKETS,
                 latency_budget_ms: float = 2.0, device=None, journal=None):
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
        self.journal = journal
        self._graphed = self.device.type == "cuda"
        self._gen = Generation(_to_device(params, self.device), step,
                               gen_id=0)
        obs.gauge("serve/generation_step").set(self._gen.step)
        # bucket -> (ids, vals, out) host staging buffers, made by warmup().
        self._staging: dict[int, tuple[torch.Tensor, ...]] = {}
        self._side: torch.cuda.Stream | None = None
        self._warm = False
        # Swaps (captures) one at a time.
        self._swap_lock = threading.Lock()
        # One dispatch at a time: it owns the staging buffer it fills.
        self._dispatch_lock = threading.Lock()
        self._runs: dict[str, int] = {}
        self.graph_replays = 0
        self._queue: queue.Queue = queue.Queue()
        self._carry: _Request | None = None
        self._worker: threading.Thread | None = None
        self._worker_lock = threading.Lock()
        self._closed = False
        self._last_slo_dump: float | None = None

    # -------------------------------------------------------- generations

    def generation(self) -> Generation:
        """The CURRENT generation reference."""
        return self._gen

    def swap_generation(self, params, step: int) -> Generation:
        """Install a new generation via a single reference store, after
        its params are on the device and, on the card once warmed, its
        graphs are captured (on a side stream, while batches go on being
        served by the old generation). A capture that fails raises, and
        the old generation keeps serving. Batches already running on the
        old generation finish on it."""
        with self._swap_lock:
            old = self._gen
            t0 = time.perf_counter()
            gen = Generation(self._place(params), step,
                             gen_id=old.gen_id + 1)
            t1 = time.perf_counter()
            if self._graphed and self._warm:
                self._capture(gen)
            gen.h2d_s, gen.capture_s = t1 - t0, time.perf_counter() - t1
            self._gen = gen
        obs.counter("serve.swaps_total").add(1)
        obs.gauge("serve/generation_step").set(gen.step)
        if self.journal is not None:
            self.journal.emit("serve_swap", step=gen.step, gen_id=gen.gen_id,
                              from_step=old.step, h2d_s=gen.h2d_s,
                              capture_s=gen.capture_s)
        return gen

    def _side_stream(self) -> torch.cuda.Stream:
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        return self._side

    def _place(self, params):
        """``params`` on the device; on the card copied on the side
        stream, so the worker's replays do not wait behind the copy."""
        if not self._graphed:
            return _to_device(params, self.device)
        side = self._side_stream()
        # Not while another thread captures (graphs.side_stream_work).
        with graphs.side_stream_work():
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                params = _to_device(params, self.device)
        side.synchronize()
        return params

    def _capture(self, gen: Generation) -> None:
        """Capture ``gen``'s graph of every bucket into its own pool."""
        gen.pool = torch.cuda.graph_pool_handle()
        side = self._side_stream()
        with self._device_ctx():
            for b in self.buckets:
                try:
                    gen.graphs[b] = _BucketGraph(
                        self.spec.predict, gen.params, b, self.nnz,
                        self.device, gen.pool, side)
                except Exception as e:
                    raise RuntimeError(
                        f"capture of bucket {b} failed ({type(e).__name__}: "
                        f"{e}); the engine serves only through its graphs "
                        "on the card") from e

    def kernel_runs(self) -> dict:
        """Kernel runs of the graphs' replays so far, by wrapper name."""
        with self._dispatch_lock:
            return dict(self._runs)

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
        """Make each bucket's staging buffers and, on the card, build the
        kernels and capture the current generation's graph of every
        bucket; on the CPU launch every bucket once. Returns
        ``{"seconds", "buckets", "captures", "capture_s",
        "fresh_compiles"}``: the kernel libraries the warm-up built
        (``utils.compile_cache``; 0 on a warm cache, and on the CPU). A
        CUDA graph cannot be cached across processes, so every process
        captures its ``captures`` anew."""
        from fm_spark_tpu_torch.utils import compile_cache

        misses0 = compile_cache.cache_stats()["misses"]
        with obs.span("serve/warmup", buckets=list(self.buckets),
                      nnz=self.nnz):
            out = self._warmup()
        out["fresh_compiles"] = (compile_cache.cache_stats()["misses"]
                                 - misses0)
        obs.event("serve_warmup", seconds=round(out["seconds"], 4),
                  captures=out["captures"],
                  fresh_compiles=out["fresh_compiles"])
        return out

    def _warmup(self) -> dict:
        t0 = time.perf_counter()
        pin = self._graphed
        if pin:
            from fm_spark_tpu_torch.kernels import build

            build.build_all()
        for b in self.buckets:
            if b not in self._staging:
                self._staging[b] = (  # fmlint: disable=thread-lock-discipline -- warmup() runs before serving starts; staging entries are add-only and never replaced after
                    torch.zeros((b, self.nnz), dtype=torch.int32,
                                pin_memory=pin),
                    torch.zeros((b, self.nnz), dtype=torch.float32,
                                pin_memory=pin),
                    torch.zeros((b,), dtype=torch.float32, pin_memory=pin))
        captures, capture_s = 0, 0.0
        with self._swap_lock:
            gen = self._gen
            if pin and not gen.graphs:
                t1 = time.perf_counter()
                self._capture(gen)
                capture_s = time.perf_counter() - t1
                gen.capture_s = capture_s
                captures = len(gen.graphs)
            self._warm = True
        if not pin:
            zeros_i = np.zeros((1, self.nnz), np.int32)
            for b in self.buckets:
                self._dispatch(gen, np.repeat(zeros_i, b, axis=0),
                               np.zeros((b, self.nnz), np.float32))
        return {"seconds": time.perf_counter() - t0,
                "buckets": list(self.buckets), "captures": captures,
                "capture_s": capture_s}

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
        with id 0, value 0), run the model (on the card: replay ``gen``'s
        graph of the bucket), return the first ``n`` predictions as host
        floats."""
        n = ids.shape[0]
        bucket = self._bucket_for(n)
        staged = self._staging.get(bucket)
        graph = gen.graphs.get(bucket) if self._graphed else None
        if staged is None or (self._graphed and graph is None):
            raise RuntimeError(
                f"bucket {bucket} not warmed — call warmup() before serving")
        ids_h, vals_h, out_h = staged
        with self._dispatch_lock, self._device_ctx():
            ids_np, vals_np = ids_h.numpy(), vals_h.numpy()
            ids_np[:n] = ids
            ids_np[n:] = 0
            vals_np[:n] = vals
            vals_np[n:] = 0.0
            if graph is None:
                # Predictions in a bf16 compute dtype widen to float32:
                # numpy has no bf16.
                return self.spec.predict(
                    gen.params, ids_h.to(self.device),
                    vals_h.to(self.device)).float().numpy()[:n]
            # The staging buffers are reused only after the synchronise
            # below, so the asynchronous copies are safe.
            graph.ids.copy_(ids_h, non_blocking=True)
            graph.vals.copy_(vals_h, non_blocking=True)
            graph.graph.replay()
            out_h.copy_(graph.out, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            self.graph_replays += 1
            for k, c in graph.kernels.items():
                self._runs[k] = self._runs.get(k, 0) + c
            return out_h.numpy()[:n].copy()

    def _execute(self, gen: Generation, ids: np.ndarray,
                 vals: np.ndarray, exec_info: dict | None = None
                 ) -> np.ndarray:
        """One padded-bucket dispatch on ``gen`` with its metrics;
        ``exec_info`` receives the ``serve/batch`` span's id and its
        perf-clock bounds (the coalescer's link spans point at them)."""
        n = ids.shape[0]
        bucket = self._bucket_for(n)
        t0 = time.perf_counter()
        with obs.span("serve/batch", rows=n, bucket=bucket,
                      gen_step=gen.step) as sp:
            with watchdog.phase("serve_request"):
                out = self._dispatch(gen, ids, vals)
        if exec_info is not None:
            exec_info.update(span_id=getattr(sp, "span_id", None), t0=t0,
                             t1=time.perf_counter())
        obs.histogram("serve/batch_ms").observe(
            (time.perf_counter() - t0) * 1e3)
        obs.counter("serve.batches_total").add(1)
        obs.counter("serve.rows_total").add(n)
        pad = bucket - n
        if pad:
            obs.counter("serve.padded_rows_total").add(pad)
        introspect.tick()
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

    def submit(self, ids, vals, deadline: float | None = None,
               trace=None) -> ServeFuture:
        """Enqueue one request (<= bucket-max rows) for coalescing;
        returns its :class:`ServeFuture`. ``deadline`` is an absolute
        ``time.monotonic()`` timestamp: a request that expires while
        still queued is answered with :class:`TimeoutError`. ``trace``
        (an ``obs.TraceContext``) yields one ``serve/coalesce`` link span
        joining this request to the shared ``serve/batch`` span, and
        tags its latency observation as the bucket's exemplar."""
        ids, vals = self._coerce(ids, vals)
        if ids.shape[0] > self.buckets[-1]:
            raise ValueError(
                f"submit() takes at most bucket-max ({self.buckets[-1]}) "
                "rows per request; use predict() to auto-chunk")
        self._ensure_worker()
        req = _Request(ids, vals, deadline=deadline, trace=trace)
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
        self._carry = None  # fmlint: disable=thread-lock-discipline -- batcher-thread-local carry: only the single worker thread (_run/_gather) ever touches it
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
                self._carry = nxt  # fmlint: disable=thread-lock-discipline -- heads the next batch; batcher-thread-local (single worker thread)
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
            gen = self._gen  # fmlint: disable=thread-lock-discipline -- single atomic reference read per micro-batch IS the protocol (no-torn-swap contract)
            ids = np.concatenate([r.ids for r in batch])
            vals = np.concatenate([r.vals for r in batch])
            exec_info: dict = {}
            try:
                out = self._execute(gen, ids, vals, exec_info=exec_info)
            except BaseException as e:  # noqa: BLE001 — every queued
                # caller must be answered (exactly once), even by the failure.
                obs.counter("serve.batch_failures_total").add(1)
                if isinstance(e, watchdog.HangDetected):
                    self._note_slo_overrun(e, ids.shape[0], gen)
                obs.event("serve_batch_failed",
                          error=f"{type(e).__name__}: "
                                f"{(str(e).splitlines() or [''])[0][:200]}",
                          rows=ids.shape[0], gen_step=gen.step)
                if self.journal is not None:
                    self.journal.emit("serve_batch_failed",
                                      error=type(e).__name__,
                                      gen_step=gen.step)
                for r in batch:
                    r.future._set_exception(e)
                if not isinstance(e, Exception):
                    raise
                continue
            t_done = time.perf_counter()
            hist = obs.histogram("serve/request_ms")
            t_exec0 = exec_info.get("t0", t_done)
            t_exec1 = exec_info.get("t1", t_done)
            off = 0
            for r in batch:
                r.future._set(out[off:off + r.n])
                off += r.n
                hist.observe((t_done - r.t_submit) * 1e3,
                             exemplar=(r.trace.trace_id
                                       if r.trace is not None else None))
                if r.trace is not None:
                    # One link span per coalesced request: its
                    # queue-to-split window, joined to the SHARED
                    # serve/batch span (N requests, one execute).
                    obs.emit_span(
                        "serve/coalesce", r.t_wall, t_done - r.t_submit,
                        trace=r.trace.trace_id,
                        remote_parent=r.trace.parent_span_id,
                        exec_span=exec_info.get("span_id"),
                        queue_ms=round((t_exec0 - r.t_submit) * 1e3, 3),
                        exec_ms=round((t_exec1 - t_exec0) * 1e3, 3),
                        split_ms=round((t_done - t_exec1) * 1e3, 3),
                        rows=r.n)

    def _note_slo_overrun(self, e, rows: int, gen: Generation) -> None:
        """The ``serve_request`` phase blew its deadline (the SLO): count
        it and fire a rate-limited deep capture while the slow program is
        resident; the event and flight dump are rate-limited like the
        watchdog's near miss (by the capture engine when armed, else once
        per ``NEAR_MISS_DUMP_INTERVAL_S``), because a sustained breach
        overruns every batch and the worker must answer callers, not
        fsync per batch."""
        overrun = dict(phase=e.phase, deadline_s=round(e.deadline_s, 3),
                       elapsed_s=round(e.elapsed_s, 3), rows=rows,
                       gen_step=gen.step)
        obs.counter("serve.slo_overruns_total").add(1)
        armed = introspect.active()
        bundle = (introspect.fire("serve_slo_overrun", **overrun)
                  if armed else None)
        now = time.monotonic()
        throttled = (self._last_slo_dump is not None
                     and now - self._last_slo_dump
                     < watchdog.NEAR_MISS_DUMP_INTERVAL_S)
        if (armed and bundle is not None) or (not armed and not throttled):
            self._last_slo_dump = now  # fmlint: disable=thread-lock-discipline -- _note_slo_overrun runs only on the batcher thread (called from _run alone); the throttle stamp is that thread's
            obs.event("serve_slo_overrun", **overrun)
            obs.flight_dump("serve_slo_overrun", **overrun)

    def close(self) -> None:
        """Stop the coalescer after answering everything queued."""
        with self._worker_lock:
            self._closed = True
            worker = self._worker
        if worker is not None and worker.is_alive():
            self._queue.put(_STOP)
            worker.join(timeout=30.0)
