"""Two-tier parameter store: a card-resident hot-bucket cache over host
cold rows (the port of ``fm_spark_tpu/embed/store.py``).

A table that outgrows the card's memory (config 2's rank 32 at 1B rows
is 132 GB of ``v`` + ``w`` in fp32) keeps a fixed-capacity HOT tier on
the card — ``hot_rows`` rows, managed as buckets of ``bucket_rows``
contiguous rows, evicted LRU-by-batch — in front of a host-memory COLD
tier holding the full feature axis.

Layout contract (the reference's, so the device step is UNCHANGED):

- A *bucket* is the residency unit: global rows ``[b·R, (b+1)·R)`` for
  bucket ``b`` and ``R = bucket_rows``. Global id ``g`` lives in bucket
  ``g // R`` at offset ``g % R``.
- The hot tier is an ordinary ``[hot_rows, ...]`` tensor per plane
  (``v``, ``w``, the FTRL/AdaGrad slot tables — ALL planes share ONE
  residency map). Bucket-in-slot ``s`` occupies hot rows
  ``[s·R, (s+1)·R)``.
- :meth:`TieredStore.begin_batch` translates a batch's global ids to
  hot-local ids; the train step runs the stock flat-FM body
  (``sparse.make_sparse_sgd_step`` / ``optim.make_sparse_adaptive_step``)
  against the hot tables with the local ids, its dedup keyed by the
  global ids (``ops.scatter._dedup_by``).

Consistency protocol (the reference's, host logic copied as it is):

- Updates write through to the hot tier only; a resident bucket touched
  by a batch is DIRTY. Eviction flushes dirty hot rows back to their
  cold block (the ``embed_evict`` fault point fires per eviction) and
  bumps the bucket's VERSION.
- The prefetcher (prefetch.py) stages batch N+1's missing buckets on
  the card, recording the version it read. A staged buffer whose
  version is stale by install time is discarded and re-read — a stale
  install would silently resurrect pre-flush values.
- :meth:`TieredStore.merged_planes` materialises the cold view with
  every dirty resident bucket overlaid, WITHOUT touching the live cold
  arrays or versions: the checkpointable merged view is a pure function
  of (cold, hot, dirty mask).

What the card changes (the device side is the port's own):

- **The hot tables keep their storage.** :meth:`TieredStore.init_hot`
  allocates each plane once; an install is a ``copy_`` into the slot's
  rows, :meth:`restore_cold` zeroes the planes in place. A captured step
  is bound to the planes' storage (``graphs.CapturedStep``), so it is
  never recaptured by residency changes.
- **Staging runs on the producer thread**, on its own CUDA stream: each
  bucket's rows go into a pinned host buffer from a small ring, then to
  a fresh device buffer by a ``non_blocking`` copy, and an event is
  recorded per bucket. :meth:`_install` makes the current stream wait on
  that event before its copy into the hot rows, and ``record_stream``
  keeps the staged buffer's memory from being reused before that copy
  has run. A ring slot is refilled only after its previous copy's event
  has completed. Only staging buffers are pinned: the cold planes stay
  numpy (a pinned 10M-row plane would be 1.3 GB of locked host memory).
- **Flushes are synchronous**, as the reference's ``np.asarray`` is: the
  slot's rows come down into a pinned buffer, the current stream is
  synchronised, and only then is the cold bucket written and its version
  bumped under the lock — a flush still in flight when the producer
  reads that cold bucket would stage pre-flush values.
- **No fallback.** A staging or install that fails on the card raises;
  a blocking miss is the reference's counted, timed miss and nothing
  else.

Misses that do block are COUNTED and timed: ``embed/hit_rate``,
``embed/evictions`` and ``embed/stall_ms`` land in the metrics registry.
"""

from __future__ import annotations

import io
import os
import threading
import time

import numpy as np
import torch

from fm_spark_tpu_torch import graphs, obs, resolve_device
from fm_spark_tpu_torch.resilience import faults
from fm_spark_tpu_torch.utils import durable

__all__ = ["ColdStore", "TieredStore"]

#: write_back()'s commit marker: the manifest is published LAST, so a
#: directory with plane files but no manifest is an uncommitted (torn)
#: write-back and read_back refuses it.
COLD_MANIFEST = "cold_manifest.json"

#: Pinned host buffers per plane in the staging ring: the producer may
#: have this many bucket copies in flight before it waits on the oldest.
STAGE_RING = 8


#: The cold tier's numpy dtype of a bf16 plane: its 16-bit patterns, as
#: the checkpoint chain stores bf16 (numpy has no bf16). No plane holds
#: real uint16 values.
BF16_BITS = np.dtype(np.uint16)


def host_dtype(dtype: torch.dtype) -> np.dtype:
    """The cold tier's numpy dtype of a plane of torch ``dtype``."""
    if dtype == torch.bfloat16:
        return BF16_BITS
    return torch.empty(0, dtype=dtype).numpy().dtype


def torch_dtype_of(dtype) -> torch.dtype:
    """The torch dtype of a cold plane of numpy ``dtype``."""
    if np.dtype(dtype) == BF16_BITS:
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype)).dtype


def from_host(a: np.ndarray) -> torch.Tensor:
    """A cold-tier array as a tensor sharing its memory (bf16 bits as
    bf16)."""
    t = torch.from_numpy(a)
    return t.view(torch.bfloat16) if a.dtype == BF16_BITS else t


def to_host(t: torch.Tensor) -> np.ndarray:
    """A host tensor as the cold tier's numpy array, sharing its memory
    (bf16 as its bits)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


class ColdStore:
    """Host-memory cold tier: named row-planes over one global row axis.

    Two materialisation modes share the bucket read/write API:

    - :meth:`dense` wraps fully materialised ndarrays (the differential
      / checkpoint mode — ``merged`` views and bitwise parity against
      an untiered run need the whole axis on the host);
    - :meth:`lazy` materialises a bucket only on first touch via a
      deterministic ``init_fn(plane, bucket, shape, dtype)`` — the
      100M/1B rungs, where host RSS must track the TOUCHED row set, not
      the feature axis.
    """

    def __init__(self, planes: dict, bucket_rows: int, n_rows: int,
                 init_fn=None):
        if bucket_rows <= 0:
            raise ValueError(f"bucket_rows must be > 0, got {bucket_rows}")
        if n_rows % bucket_rows:
            raise ValueError(
                f"n_rows={n_rows} must divide by bucket_rows="
                f"{bucket_rows} (bucket = contiguous row block)")
        self.bucket_rows = int(bucket_rows)
        self.n_rows = int(n_rows)
        self.n_buckets = self.n_rows // self.bucket_rows
        self._init_fn = init_fn
        # plane -> full ndarray (dense) | plane -> {bucket: ndarray} (lazy)
        self._planes = planes
        self._lazy = init_fn is not None
        if self._lazy:
            self._meta = dict(planes)  # {plane: (row_shape, dtype)}
            self._planes = {p: {} for p in planes}
        else:
            self._meta = {
                p: (tuple(a.shape[1:]), a.dtype)
                for p, a in planes.items()
            }
            for p, a in planes.items():
                if a.shape[0] != self.n_rows:
                    raise ValueError(
                        f"plane {p!r} has {a.shape[0]} rows, store has "
                        f"{self.n_rows}")

    @classmethod
    def dense(cls, planes: dict, bucket_rows: int) -> "ColdStore":
        """Materialised cold tier from full host arrays (one per plane,
        identical leading row count)."""
        n_rows = next(iter(planes.values())).shape[0]
        return cls(dict(planes), bucket_rows, n_rows)

    @classmethod
    def lazy(cls, meta: dict, bucket_rows: int, n_rows: int,
             init_fn) -> "ColdStore":
        """Demand-materialised cold tier. ``meta`` maps plane name →
        ``(row_shape, dtype)``; ``init_fn(plane, bucket, shape, dtype)``
        must be DETERMINISTIC per (plane, bucket)."""
        return cls(dict(meta), bucket_rows, n_rows, init_fn=init_fn)

    @property
    def is_lazy(self) -> bool:
        return self._lazy

    @property
    def plane_names(self) -> tuple:
        return tuple(sorted(self._meta))

    def row_shape(self, plane: str) -> tuple:
        return self._meta[plane][0]

    def dtype(self, plane: str):
        return self._meta[plane][1]

    def _slice(self, b: int) -> slice:
        return slice(b * self.bucket_rows, (b + 1) * self.bucket_rows)

    def read_bucket(self, plane: str, b: int) -> np.ndarray:
        """A COPY of bucket ``b``'s rows (the store's own bytes never
        alias out)."""
        if self._lazy:
            blocks = self._planes[plane]
            if b not in blocks:
                shape, dtype = self._meta[plane]
                blocks[b] = np.ascontiguousarray(
                    self._init_fn(plane, int(b),
                                  (self.bucket_rows, *shape), dtype))
            return blocks[b].copy()
        return self._planes[plane][self._slice(b)].copy()

    def write_bucket(self, plane: str, b: int, values: np.ndarray) -> None:
        """Install an eviction flush (or restore) into bucket ``b``."""
        values = np.asarray(values)
        if self._lazy:
            self._planes[plane][int(b)] = values.copy()
        else:
            self._planes[plane][self._slice(b)] = values

    def dense_plane(self, plane: str) -> np.ndarray:
        """The full materialised plane (dense mode only — the merged
        checkpoint view; a lazy 1B-row plane must never materialise)."""
        if self._lazy:
            raise ValueError(
                "dense_plane() is the checkpoint/merged view of a DENSE "
                "cold store; lazy stores bound host RSS by never "
                "materializing the full axis")
        return self._planes[plane]

    def host_bytes(self) -> int:
        """Materialised cold bytes (lazy mode: only touched buckets)."""
        if self._lazy:
            return sum(a.nbytes for blocks in self._planes.values()
                       for a in blocks.values())
        return sum(a.nbytes for a in self._planes.values())

    def touched_buckets(self) -> int:
        if self._lazy:
            return max((len(b) for b in self._planes.values()), default=0)
        return self.n_buckets

    # ------------------------------------------------- durable write-back

    @staticmethod
    def _npy_bytes(a: np.ndarray) -> bytes:
        buf = io.BytesIO()
        np.save(buf, np.ascontiguousarray(a), allow_pickle=False)
        return buf.getvalue()

    def write_back(self, directory: str) -> dict:
        """Persist the cold tier to ``directory`` through the durable
        seam: one ``<plane>.npy`` per plane (dense), one
        ``<plane>.<bucket>.npy`` per MATERIALISED bucket (lazy). The
        manifest is published last and returned. Fail-loud: the caller
        owns retry and walk-back."""
        os.makedirs(directory, exist_ok=True)
        files: dict[str, list] = {}
        for p in self.plane_names:
            if self._lazy:
                buckets = sorted(self._planes[p])
                for b in buckets:
                    durable.atomic_write_bytes(
                        os.path.join(directory, f"{p}.{b}.npy"),
                        self._npy_bytes(self._planes[p][b]),
                        path_class="embed")
                files[p] = [int(b) for b in buckets]
            else:
                durable.atomic_write_bytes(
                    os.path.join(directory, f"{p}.npy"),
                    self._npy_bytes(self._planes[p]),
                    path_class="embed")
                files[p] = []
        manifest = {
            "lazy": self._lazy,
            "bucket_rows": self.bucket_rows,
            "n_rows": self.n_rows,
            "planes": {
                p: {"row_shape": list(self.row_shape(p)),
                    "dtype": np.dtype(self.dtype(p)).str,
                    "buckets": files[p]}
                for p in self.plane_names
            },
        }
        durable.atomic_write_json(
            os.path.join(directory, COLD_MANIFEST), manifest,
            path_class="embed", sync_dir=True)
        return manifest

    @staticmethod
    def _load_npy(path: str) -> np.ndarray:
        return np.load(io.BytesIO(durable.read_bytes(path,
                                                     path_class="embed")),
                       allow_pickle=False)

    @classmethod
    def read_back(cls, directory: str) -> "ColdStore | None":
        """Rebuild a cold store from a :meth:`write_back` directory, or
        None when the directory holds no COMMITTED write-back (missing or
        unreadable manifest, torn plane file, short read): the caller
        walks back to the previous generation. Lazy stores come back lazy
        (re-attach the run's ``init_fn`` with :meth:`reattach_init`)."""
        try:
            man = durable.read_json(os.path.join(directory, COLD_MANIFEST),
                                    path_class="embed")
            bucket_rows = int(man["bucket_rows"])
            n_rows = int(man["n_rows"])
            if man["lazy"]:
                meta = {p: (tuple(d["row_shape"]), np.dtype(d["dtype"]))
                        for p, d in man["planes"].items()}
                store = cls.lazy(meta, bucket_rows, n_rows,
                                 init_fn=_unattached_init)
                for p, d in man["planes"].items():
                    for b in d["buckets"]:
                        a = cls._load_npy(
                            os.path.join(directory, f"{p}.{int(b)}.npy"))
                        if a.shape[0] != bucket_rows:
                            raise ValueError(
                                f"short bucket {p}.{b}: {a.shape}")
                        store.write_bucket(p, int(b), a)
                return store
            planes = {}
            for p, d in man["planes"].items():
                a = cls._load_npy(os.path.join(directory, f"{p}.npy"))
                if (a.shape[0] != n_rows
                        or tuple(a.shape[1:]) != tuple(d["row_shape"])):
                    raise ValueError(f"short plane {p}: {a.shape}")
                planes[p] = a
            return cls.dense(planes, bucket_rows)
        except (OSError, ValueError, KeyError, TypeError):
            return None

    def reattach_init(self, init_fn) -> None:
        """Re-attach the deterministic ``init_fn`` to a lazy store that
        came back from :meth:`read_back`."""
        if not self._lazy:
            raise ValueError("reattach_init is for lazy stores")
        self._init_fn = init_fn


def _unattached_init(plane, bucket, shape, dtype):
    raise RuntimeError(
        "lazy ColdStore restored by read_back() has no init_fn — call "
        "reattach_init(init_fn) with the run's deterministic "
        "initializer before touching unmaterialized buckets")


class TieredStore:
    """Residency and staging manager for the hot tier over a
    :class:`ColdStore`, on ``device`` (the card unless ``device="cpu"``).

    The store owns the hot planes (:meth:`init_hot`) and the metadata —
    bucket→slot map, dirty mask, LRU stamps, staged buffers, per-bucket
    versions — every piece of it touched under ONE lock, because the
    prefetch producer thread stages concurrently with the consumer's
    install/evict path.
    """

    def __init__(self, cold: ColdStore, hot_buckets: int, device=None):
        if hot_buckets <= 0:
            raise ValueError(f"hot_buckets must be > 0, got {hot_buckets}")
        self.cold = cold
        self.hot_buckets = int(hot_buckets)
        self.hot_rows = self.hot_buckets * cold.bucket_rows
        self.device = resolve_device(device)
        self._cuda = self.device.type == "cuda"
        self._lock = threading.Lock()
        # All shared mutable state below is read/written under _lock.
        self._slot_of: dict[int, int] = {}      # bucket -> slot
        self._bucket_in: list = [None] * self.hot_buckets
        self._dirty = [False] * self.hot_buckets
        self._stamp = [-1] * self.hot_buckets   # last-used batch index
        self._free = list(range(self.hot_buckets - 1, -1, -1))
        # bucket -> (version, device buffers, ready event or None)
        self._staged: dict[int, tuple] = {}
        self._version: dict[int, int] = {}      # bumped per cold flush
        self._batch = 0
        self._stats = {"lookups": 0, "hot_hits": 0, "staged_hits": 0,
                       "misses": 0, "evictions": 0, "stall_ms": 0.0,
                       "prefetch_issued": 0, "prefetch_stale": 0,
                       "bytes_h2d": 0, "bytes_d2h": 0}
        self._hot: dict | None = None
        # The card's side: one stream for staging and one for blocking
        # misses (made at first use, on the thread that stages), the
        # staging ring of pinned buffers and their copies' events, and
        # one pinned buffer per plane for flushes (the consumer's).
        self._streams: dict[str, torch.cuda.Stream] = {}
        self._ring: list = []
        self._ring_next = 0
        self._flush_buf: dict = {}

    # ------------------------------------------------------------ hot init

    def _torch_dtype(self, plane: str) -> torch.dtype:
        return torch_dtype_of(self.cold.dtype(plane))

    def init_hot(self) -> dict:
        """The hot planes, one per cold plane: ``[hot_rows, ...]`` on the
        store's device, allocated at the first call and zeroed in place by
        a later one (the same tensors every time: a captured step bound to
        them stays valid). Content is irrelevant until a bucket installs
        over it — no id ever maps into a non-resident slot."""
        with self._lock:
            if self._hot is None:
                self._hot = {
                    p: torch.zeros((self.hot_rows, *self.cold.row_shape(p)),
                                   dtype=self._torch_dtype(p),
                                   device=self.device)
                    for p in self.cold.plane_names}
            else:
                for t in self._hot.values():
                    t.zero_()
            return self._hot

    # --------------------------------------------------------- device side

    def _stream(self, name: str) -> torch.cuda.Stream:
        with self._lock:
            s = self._streams.get(name)
            if s is None:
                s = self._streams[name] = torch.cuda.Stream(self.device)
            return s

    def _ring_slot(self) -> dict:
        """The next staging ring slot (pinned buffers, one per plane),
        once the copy that last read it has completed. Producer-side:
        one staging thread at a time."""
        if not self._ring:
            self._ring = [{"bufs": {p: torch.empty(
                (self.cold.bucket_rows, *self.cold.row_shape(p)),
                dtype=self._torch_dtype(p), pin_memory=True)
                for p in self.cold.plane_names}, "done": None}
                for _ in range(STAGE_RING)]
        slot = self._ring[self._ring_next]
        self._ring_next = (self._ring_next + 1) % len(self._ring)
        if slot["done"] is not None:
            slot["done"].synchronize()
        return slot

    def _to_device(self, src: dict, stream: str, pinned: bool):
        """``src`` (numpy bucket rows by plane) as device buffers on the
        side stream ``stream``, with the event that marks their copies
        done: ``(bufs, ready)``. On the CPU the buffers are the arrays
        themselves (each a fresh copy) and ``ready`` None. ``pinned``
        goes through the staging ring (non-blocking copies); otherwise
        the copies are synchronous and timed by their caller."""
        if not self._cuda:
            return {p: from_host(a) for p, a in src.items()}, None
        torch.cuda.set_device(self.device)
        side = self._stream(stream)
        ready = torch.cuda.Event()
        # Never while another thread captures: the pool may hand this
        # side stream out as the capturing one (graphs.side_stream_work).
        with graphs.side_stream_work(), torch.cuda.stream(side):
            if pinned:
                slot = self._ring_slot()
                bufs = {}
                for p, a in src.items():
                    host = slot["bufs"][p]
                    to_host(host)[...] = a
                    bufs[p] = torch.empty_like(host, device=self.device)
                    bufs[p].copy_(host, non_blocking=True)
                slot["done"] = ready
            else:
                bufs = {p: from_host(a).to(self.device)
                        for p, a in src.items()}
            ready.record(side)
        return bufs, ready

    def _to_host(self, t: torch.Tensor, key: str) -> np.ndarray:
        """A host copy of device rows ``t`` (ordered after every step on
        the current stream; synchronous): on the card through a pinned
        buffer kept per ``key``."""
        if not self._cuda:
            return to_host(t).copy()
        buf = self._flush_buf.get(key)
        if buf is None or buf.shape != t.shape:
            buf = self._flush_buf[key] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        buf.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return to_host(buf).copy()

    # ------------------------------------------------------- prefetch side

    def stage(self, ids: np.ndarray) -> int:
        """PRODUCER-thread half of the pipeline: inspect a future
        batch's global ids and stage on the card every bucket that is
        neither resident nor already staged. Returns the number of
        buckets staged. The ``embed_prefetch`` fault point fires once
        per bucket staged."""
        buckets = np.unique(
            np.asarray(ids, np.int64).ravel() // self.cold.bucket_rows)
        todo = []
        with self._lock:
            for b in buckets.tolist():
                if b in self._slot_of or b in self._staged:
                    continue
                todo.append((b, self._version.get(b, 0)))
        staged = 0
        for b, ver in todo:
            faults.inject("embed_prefetch")
            with self._lock:
                src = {p: self.cold.read_bucket(p, b)
                       for p in self.cold.plane_names}
            bufs, ready = self._to_device(src, "stage", pinned=True)
            with self._lock:
                if b in self._slot_of or self._version.get(b, 0) != ver:
                    # Lost the race with an install or an eviction
                    # flush — a stale buffer must never land.
                    self._stats["prefetch_stale"] += 1
                    continue
                self._staged[b] = (ver, bufs, ready)
                self._stats["prefetch_issued"] += 1
                self._stats["bytes_h2d"] += sum(
                    a.nbytes for a in src.values())
                staged += 1
        return staged

    # ------------------------------------------------------- consumer side

    def begin_batch(self, ids: np.ndarray, hot: dict) -> tuple:
        """Make every bucket of ``ids`` resident; translate to hot-local
        ids. Returns ``(local_ids, hot)``, ``hot`` the same planes, their
        slots' rows updated in place. Evicts LRU-by-batch buckets when
        capacity forces it (flushing dirty rows to cold first); a needed
        bucket neither resident nor validly staged is a counted, timed
        MISS — loaded blocking, never hidden. An id outside the feature
        axis raises (it has no bucket)."""
        ids = np.asarray(ids)
        flat = ids.ravel().astype(np.int64)
        if flat.size and (flat.min() < 0 or flat.max() >= self.cold.n_rows):
            raise ValueError(
                f"ids must lie in [0, {self.cold.n_rows}) for the tiered "
                f"store (got [{flat.min()}, {flat.max()}])")
        buckets, inv = np.unique(flat // self.cold.bucket_rows,
                                 return_inverse=True)
        offsets = flat % self.cold.bucket_rows
        if buckets.size > self.hot_buckets:
            raise ValueError(
                f"batch touches {buckets.size} bucket(s) but the hot "
                f"tier holds {self.hot_buckets}; raise hot_rows (or "
                f"bucket_rows granularity) — hot capacity must cover "
                "one batch's working set")

        needed = set(buckets.tolist())
        evict: list[tuple[int, int, bool]] = []
        installs: list[tuple[int, int]] = []
        with self._lock:
            self._batch += 1
            stamp = self._batch
            self._stats["lookups"] += buckets.size
            missing = []
            for b in buckets.tolist():
                s = self._slot_of.get(b)
                if s is not None:
                    self._stats["hot_hits"] += 1
                    self._stamp[s] = stamp
                else:
                    missing.append(b)
            # Victim selection is deterministic: free slots first, then
            # lowest (stamp, bucket) among residents not needed by THIS
            # batch — LRU-by-batch with a stable tie-break, so a resumed
            # run replays the same residency sequence.
            victims = sorted(
                (self._stamp[s], self._bucket_in[s], s)
                for s in range(self.hot_buckets)
                if self._bucket_in[s] is not None
                and self._bucket_in[s] not in needed)
            vi = 0
            for b in missing:
                if self._free:
                    slot = self._free.pop()
                else:
                    if vi >= len(victims):
                        raise RuntimeError(
                            "no evictable slot (every resident bucket "
                            "is needed by this batch) — hot capacity "
                            "must exceed the batch working set")
                    _, old_b, slot = victims[vi]
                    vi += 1
                    evict.append((slot, old_b, self._dirty[slot]))
                    del self._slot_of[old_b]
                    self._bucket_in[slot] = None
                    self._dirty[slot] = False
                installs.append((slot, b))
                self._slot_of[b] = slot
                self._bucket_in[slot] = b
                self._stamp[slot] = stamp
                # The step will update every gathered bucket in place.
                self._dirty[slot] = True
            for b in buckets.tolist():
                s = self._slot_of[b]
                self._dirty[s] = True
            slot_arr = np.fromiter(
                (self._slot_of[b] for b in buckets.tolist()),
                np.int64, count=buckets.size)

        # Flush evicted dirty buckets to cold (D2H), then install the new
        # residents (staged buffers when the prefetcher won the race;
        # blocking loads otherwise).
        for slot, old_b, dirty in evict:
            self._flush_slot(hot, slot, old_b, dirty)
        for slot, b in installs:
            self._install(hot, slot, b)

        local = (slot_arr[inv] * self.cold.bucket_rows + offsets).astype(
            ids.dtype if ids.dtype.kind == "i" else np.int32)
        self._publish_gauges()
        return local.reshape(ids.shape), hot

    def _rows(self, slot: int) -> slice:
        return slice(slot * self.cold.bucket_rows,
                     (slot + 1) * self.cold.bucket_rows)

    def _flush_slot(self, hot: dict, slot: int, bucket: int,
                    dirty: bool) -> None:
        """Evict one bucket: fault point first (the mid-eviction crash
        window — cold still holds the PRE-update rows, the merged
        checkpoint view never depended on this flush), then the dirty
        write-back + version bump."""
        faults.inject("embed_evict")
        with self._lock:
            self._stats["evictions"] += 1
        if not dirty:
            return
        rows = {p: self._to_host(hot[p][self._rows(slot)], p)
                for p in self.cold.plane_names}
        with self._lock:
            for p, a in rows.items():
                self.cold.write_bucket(p, bucket, a)
            self._version[bucket] = self._version.get(bucket, 0) + 1
            self._staged.pop(bucket, None)  # now stale by construction
            self._stats["bytes_d2h"] += sum(a.nbytes for a in rows.values())

    def _install(self, hot: dict, slot: int, bucket: int) -> None:
        with self._lock:
            entry = self._staged.pop(bucket, None)
            ver = self._version.get(bucket, 0)
            if entry is not None and entry[0] == ver:
                self._stats["staged_hits"] += 1
        if entry is not None and entry[0] == ver:
            bufs, ready = entry[1], entry[2]
        else:
            # The miss the pipeline could not hide — count it, time it.
            t0 = time.perf_counter()
            with self._lock:
                if entry is not None:
                    self._stats["prefetch_stale"] += 1
                src = {p: self.cold.read_bucket(p, bucket)
                       for p in self.cold.plane_names}
            bufs, ready = self._to_device(src, "miss", pinned=False)
            if ready is not None:
                ready.synchronize()
            with self._lock:
                self._stats["misses"] += 1
                self._stats["stall_ms"] += (time.perf_counter() - t0) * 1e3
                self._stats["bytes_h2d"] += sum(
                    a.nbytes for a in src.values())
        cur = (torch.cuda.current_stream(self.device) if self._cuda
               else None)
        if ready is not None:
            cur.wait_event(ready)
        for p in self.cold.plane_names:
            hot[p][self._rows(slot)].copy_(bufs[p])
            if cur is not None:
                bufs[p].record_stream(cur)

    # ----------------------------------------------------- merged view etc

    def merged_planes(self, hot: dict, planes=None) -> dict:
        """The checkpointable MERGED view of ``planes`` (default: every
        plane): cold copied, every dirty resident bucket overwritten from
        hot. Pure — live cold arrays, versions and the dirty mask are
        untouched (dense cold mode only)."""
        names = self.cold.plane_names if planes is None else tuple(planes)
        with self._lock:
            resident = [(self._bucket_in[s], s) for s in
                        range(self.hot_buckets)
                        if self._bucket_in[s] is not None and
                        self._dirty[s]]
        out = {p: self.cold.dense_plane(p).copy() for p in names}
        if not resident:
            return out
        r = self.cold.bucket_rows
        for p in names:
            rows = self._to_host(hot[p], f"merged/{p}")
            for bucket, slot in resident:
                out[p][bucket * r:(bucket + 1) * r] = rows[self._rows(slot)]
        return out

    def restore_cold(self, planes: dict) -> None:
        """Load a restored merged view into the cold tier and reset every
        residency/staging structure; the hot planes are zeroed in place
        (never reallocated). The resumed run re-faults its working set
        from the restored rows."""
        with self._lock:
            for p, a in planes.items():
                if self.cold.is_lazy:
                    for b in range(self.cold.n_buckets):
                        self.cold.write_bucket(
                            p, b, a[b * self.cold.bucket_rows:
                                    (b + 1) * self.cold.bucket_rows])
                else:
                    self.cold.dense_plane(p)[...] = np.asarray(a)
            self._slot_of.clear()
            self._bucket_in = [None] * self.hot_buckets
            self._dirty = [False] * self.hot_buckets
            self._stamp = [-1] * self.hot_buckets
            self._free = list(range(self.hot_buckets - 1, -1, -1))
            self._staged.clear()
            self._version = {b: v + 1 for b, v in self._version.items()}
            if self._hot is not None:
                for t in self._hot.values():
                    t.zero_()

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._stats)
        hits = out["hot_hits"] + out["staged_hits"]
        out["hit_rate"] = hits / out["lookups"] if out["lookups"] else 1.0
        return out

    def _publish_gauges(self) -> None:
        st = self.stats()
        obs.gauge("embed/hit_rate").set(round(st["hit_rate"], 6))
        obs.gauge("embed/evictions").set(st["evictions"])
        obs.gauge("embed/stall_ms").set(round(st["stall_ms"], 3))
