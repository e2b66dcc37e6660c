"""Packed binary datasets: the on-disk format that training reads (the
port's copy of ``fm_spark_tpu/data/packed.py``, byte for byte the same
format, with ``iter_packed_once`` of ``fm_spark_tpu/cli.py``).

Preprocessing (``data/criteo.py``, ``data/avazu.py``) parses and hashes
raw text once and writes a directory that training memory-maps with no
parsing:

    meta.json    {"num_examples", "num_fields", "store_vals", "version"}
    ids.bin      int32 [N, F]   hashed feature ids
    vals.bin     float32 [N, F] (absent when store_vals=false: one-hot
                 data reads 1.0s at batch time)
    labels.bin   int8 [N]

:class:`PackedBatches` is the training iterator: chunk-shuffled per
epoch and exactly resumable through
``state()``/``restore()``, keyed as the reference's, so a checkpoint
holds the cursor. A batch is assembled by the native row gather
(``native.gather_rows``); ``use_native=False`` takes the numpy version,
which gives the same arrays.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np

from fm_spark_tpu_torch.data.synthetic import field_local

__all__ = ["PackedBatches", "PackedDataset", "PackedWriter",
           "iter_packed_once", "shuffle_packed"]

_VERSION = 1


class PackedWriter:
    """Append-only writer for the packed format (one-time preprocessing)."""

    def __init__(self, path: str, num_fields: int, store_vals: bool = True):
        self.path = path
        self.num_fields = int(num_fields)
        self.store_vals = bool(store_vals)
        os.makedirs(path, exist_ok=True)
        self._ids = open(os.path.join(path, "ids.bin"), "wb")
        self._vals = (
            open(os.path.join(path, "vals.bin"), "wb") if store_vals else None
        )
        self._labels = open(os.path.join(path, "labels.bin"), "wb")
        self.num_examples = 0
        self._closed = False

    def append(self, ids: np.ndarray, labels: np.ndarray,
               vals: np.ndarray | None = None) -> None:
        ids = np.ascontiguousarray(ids, np.int32)
        labels = np.ascontiguousarray(labels, np.int8)
        if ids.ndim != 2 or ids.shape[1] != self.num_fields:
            raise ValueError(
                f"ids must be [N, {self.num_fields}], got {ids.shape}"
            )
        if labels.shape != (ids.shape[0],):
            raise ValueError("labels must be [N] matching ids")
        self._ids.write(ids.tobytes())
        self._labels.write(labels.tobytes())
        if self.store_vals:
            if vals is None:
                vals = np.ones(ids.shape, np.float32)
            vals = np.ascontiguousarray(vals, np.float32)
            if vals.shape != ids.shape:
                raise ValueError("vals must match ids shape")
            self._vals.write(vals.tobytes())
        elif vals is not None and not np.all(vals == 1.0):
            raise ValueError("store_vals=False but non-unit vals given")
        self.num_examples += ids.shape[0]

    def close(self) -> None:
        if self._closed:
            return
        self._ids.close()
        self._labels.close()
        if self._vals is not None:
            self._vals.close()
        with open(os.path.join(self.path, "meta.json"), "w") as f:
            json.dump(
                {
                    "num_examples": self.num_examples,
                    "num_fields": self.num_fields,
                    "store_vals": self.store_vals,
                    "version": _VERSION,
                },
                f,
            )
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class PackedDataset:
    """Memory-mapped view of a packed directory (zero-copy until sliced)."""

    def __init__(self, path: str):
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        if meta["version"] != _VERSION:
            raise ValueError(f"unknown packed version {meta['version']}")
        self.path = path
        self.num_examples = int(meta["num_examples"])
        self.num_fields = int(meta["num_fields"])
        self.store_vals = bool(meta["store_vals"])
        if self.num_examples == 0:
            raise ValueError(
                f"packed dataset at {path} is empty (preprocessing wrote "
                "zero examples)"
            )
        shape = (self.num_examples, self.num_fields)
        self.ids = np.memmap(os.path.join(path, "ids.bin"), np.int32,
                             "r", shape=shape)
        self.vals = (
            np.memmap(os.path.join(path, "vals.bin"), np.float32, "r",
                      shape=shape)
            if self.store_vals else None
        )
        self.labels = np.memmap(os.path.join(path, "labels.bin"), np.int8,
                                "r", shape=(self.num_examples,))
        self._ones = None  # cached all-ones vals, see assemble()

    def __len__(self):
        return self.num_examples

    def slice(self, sel) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Materialize (ids, vals, labels) for an index array/slice."""
        ids = np.asarray(self.ids[sel])
        vals = (
            np.asarray(self.vals[sel])
            if self.vals is not None
            else np.ones(ids.shape, np.float32)
        )
        return ids, vals, np.asarray(self.labels[sel], np.float32)

    def _ones_vals(self, shape) -> np.ndarray:
        """Shared all-ones vals for store_vals=False dirs (one-hot data).

        Refilling 4*B*F bytes per batch is pure feed-path waste when
        every batch's vals are identically 1.0; the returned array is
        CACHED AND SHARED across batches — treat it as read-only (every
        in-repo consumer only ships it to the device or concatenates)."""
        ones = self._ones  # local read: assemble() may race between the
        # prefetch producer thread and a concurrent eval pass; returning
        # the local keeps each caller's shape right even if another
        # thread swaps the cache underneath it.
        if ones is None or ones.shape != shape:
            ones = np.ones(shape, np.float32)
            # The array is shared across every batch (and escapes to
            # arbitrary consumers as the batch vals): enforce the
            # read-only contract so an accidental in-place scale/pad
            # raises ValueError instead of silently corrupting all
            # past and future batches.
            ones.setflags(write=False)
            self._ones = ones
        return ones

    def assemble(self, sel, bucket: int = 0, n_threads: int = 0,
                 use_native: bool = True) -> tuple[np.ndarray, np.ndarray,
                                                   np.ndarray]:
        """A batch: rows ``sel`` (an index array or a slice) as ``(ids,
        vals, labels)``, ids field-local (``ids[b, f] - f*bucket``) when
        ``bucket > 0``, labels float32.

        The native ``fm_gather_rows`` does the row gather, the id
        conversion and the label cast in one pass, threaded over rows
        (``n_threads``, 0 = by batch size); ``use_native=False`` runs the
        numpy version, which gives the same arrays. A dir without vals
        returns one cached all-ones array (read-only, see
        :meth:`_ones_vals`)."""
        if use_native:
            from fm_spark_tpu_torch import native

            if isinstance(sel, slice):
                start, stop, step = sel.indices(self.num_examples)
                idx = np.arange(start, stop, step, dtype=np.int64)
            else:
                idx = np.asarray(sel, np.int64)
            ids, vals, labels = native.gather_rows(
                self.ids, self.vals, self.labels, idx, bucket, n_threads)
            if vals is None:
                vals = self._ones_vals(ids.shape)
            return ids, vals, labels
        # A slice stays a contiguous memmap read.
        ids = np.asarray(self.ids[sel])
        if bucket:
            ids = field_local(ids, bucket)
        vals = (
            np.asarray(self.vals[sel])
            if self.vals is not None
            else self._ones_vals(ids.shape)
        )
        return ids, vals, np.asarray(self.labels[sel], np.float32)


def _row_bytes(ds: PackedDataset) -> int:
    return 4 * ds.num_fields + 1 + (4 * ds.num_fields if ds.store_vals else 0)


def _shuffle_into(ds: PackedDataset, out: PackedWriter,
                  rng: np.random.Generator, mem_budget_bytes: int,
                  chunk_rows: int, max_open: int, tmp_dir: str,
                  depth: int = 0, remove: str | None = None) -> None:
    """Append a uniform permutation of ``ds`` to ``out`` (recursive deal).

    Fits in memory → load, permute, append. Otherwise deal rows into at
    most ``max_open`` random groups (bounds simultaneously open file
    descriptors regardless of dataset size), then recurse per group in
    order. Random group assignment + uniform within-group permutation =
    a uniform global permutation. ``remove`` names a directory to delete
    as soon as ``ds``'s rows are safely elsewhere — each level's scratch
    is freed while the output grows, capping peak disk at ~2x.
    """
    n = len(ds)
    if n * _row_bytes(ds) <= mem_budget_bytes:
        perm = rng.permutation(n)
        # Direct memmap reads: labels stay int8 (PackedDataset.slice would
        # cast to f32 and, for store_vals=False dirs, allocate throwaway
        # ones arrays).
        out.append(np.asarray(ds.ids[:])[perm],
                   np.asarray(ds.labels[:])[perm],
                   np.asarray(ds.vals[:])[perm] if ds.store_vals else None)
        if remove:
            del ds
            shutil.rmtree(remove)
        return
    groups = min(
        max_open, int(-(-2 * n * _row_bytes(ds) // mem_budget_bytes))
    )
    writers = [
        PackedWriter(os.path.join(tmp_dir, f"d{depth}_g{i:04d}"),
                     ds.num_fields, store_vals=ds.store_vals)
        for i in range(groups)
    ]
    for start in range(0, n, chunk_rows):
        sel = np.s_[start:min(start + chunk_rows, n)]
        ids = np.asarray(ds.ids[sel])
        labels = np.asarray(ds.labels[sel])
        vals = np.asarray(ds.vals[sel]) if ds.store_vals else None
        assign = rng.integers(groups, size=ids.shape[0])
        for g in np.unique(assign):
            m = assign == g
            writers[g].append(ids[m], labels[m],
                              vals[m] if ds.store_vals else None)
    for w in writers:
        w.close()
    if remove:
        del ds
        shutil.rmtree(remove)
    for w in writers:
        if w.num_examples:
            _shuffle_into(PackedDataset(w.path), out, rng,
                          mem_budget_bytes, chunk_rows, max_open,
                          tmp_dir, depth + 1, remove=w.path)
        else:
            shutil.rmtree(w.path)


def shuffle_packed(src_path: str, out_path: str, seed: int = 0,
                   mem_budget_bytes: int = 1 << 29,
                   chunk_rows: int = 1 << 18, max_open: int = 128,
                   remove_src: bool = False) -> None:
    """Globally shuffle a packed dir into a new packed dir.

    External shuffle (the tf.data/beam idiom — sequential IO per pass,
    never materializes the dataset): deal rows into random groups small
    enough to permute in ``mem_budget_bytes``, recursing when one level
    of at most ``max_open`` groups is not enough (keeps open file
    descriptors bounded at TB scale). Deterministic in ``seed``.
    ``remove_src=True`` deletes the source dir as soon as its rows are
    dealt, capping peak scratch at ~2x the dataset.

    This is what makes the training-time tail holdout
    (``fmtorch train --test-fraction``) a random split: criteo/avazu source
    text streams in temporal order, and without a preprocess-time shuffle
    the tail is the last day, not a sample.
    """
    if os.path.realpath(src_path) == os.path.realpath(out_path):
        raise ValueError(
            "shuffle_packed cannot shuffle in place (the output writer "
            "would truncate the source files it is reading) — write to a "
            "new directory"
        )
    if os.path.isdir(out_path) and os.listdir(out_path):
        # Also makes the failure cleanup below safe: out_path is always a
        # directory THIS call created, never pre-existing data.
        raise ValueError(
            f"shuffle_packed output dir {out_path!r} exists and is not "
            "empty — refusing to overwrite"
        )
    ds = PackedDataset(src_path)
    rng = np.random.default_rng([seed, 0x50FF1E])  # domain-separated stream
    tmp_dir = out_path.rstrip("/") + ".shards.tmp"
    os.makedirs(tmp_dir, exist_ok=True)
    try:
        # The source is only removed after the WHOLE shuffle succeeds: a
        # mid-shuffle failure (ENOSPC...) must never leave the only copy
        # of undealt rows in scratch dirs. Peak disk is ~2x either way —
        # internal group dirs shrink as the output grows.
        with PackedWriter(out_path, ds.num_fields,
                          store_vals=ds.store_vals) as out:
            _shuffle_into(ds, out, rng, mem_budget_bytes, chunk_rows,
                          max_open, tmp_dir)
    except BaseException:
        # Never leave a valid-looking truncated output behind.
        shutil.rmtree(out_path, ignore_errors=True)
        raise
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    if remove_src:
        del ds
        shutil.rmtree(src_path)


class PackedBatches:
    """Chunk-shuffled, resumable batch iterator over a packed dataset (or
    its ``row_range``, for train/holdout splits) on one host.

    Yields ``(ids, vals, labels, weights)`` with fixed shapes; the final
    partial batch of an epoch is padded with weight-0 examples. The batch
    sequence is a pure function of (seed, epoch, index), so a resume
    replays it exactly. ``state()`` carries the reference's keys (its
    ``shuffle`` always True, ``lo``/``hi`` the range of its one host).
    """

    def __init__(self, dataset: PackedDataset, batch_size: int,
                 seed: int = 0, chunk_size: int = 1 << 18,
                 row_range: tuple[int, int] | None = None,
                 bucket: int = 0):
        self.ds = dataset
        self.bucket = int(bucket)  # >0: yield field-local ids (fused)
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.chunk_size = int(chunk_size)
        self.lo, self.hi = (0, dataset.num_examples) if row_range is None \
            else (int(row_range[0]), int(row_range[1]))
        if not (0 <= self.lo < self.hi <= dataset.num_examples):
            raise ValueError(
                f"row_range {row_range} out of [0, {dataset.num_examples}]"
            )
        self.epoch = 0
        self.index = 0  # examples consumed within the epoch
        self._order = None

    @property
    def num_examples(self):
        return self.hi - self.lo

    def _epoch_order(self) -> np.ndarray:
        """Permutation of the range for the current epoch."""
        if self._order is not None:
            return self._order
        n = self.num_examples
        rng = np.random.default_rng((self.seed, self.epoch, self.lo))
        n_chunks = max(1, (n + self.chunk_size - 1) // self.chunk_size)
        chunk_order = rng.permutation(n_chunks)
        parts = []
        for c in chunk_order:
            s = c * self.chunk_size
            e = min(s + self.chunk_size, n)
            parts.append(self.lo + s + rng.permutation(e - s))
        self._order = np.concatenate(parts)
        return self._order

    def state(self) -> dict:
        return {"epoch": self.epoch, "index": self.index, "seed": self.seed,
                "lo": self.lo, "hi": self.hi, "shuffle": True,
                "chunk_size": self.chunk_size, "bucket": self.bucket}

    def restore(self, state: dict) -> None:
        # Everything the epoch order is a function of must match, or the
        # resumed sequence silently diverges from the saved one.
        for key, have in [("seed", self.seed), ("lo", self.lo),
                          ("hi", self.hi), ("shuffle", True),
                          ("chunk_size", self.chunk_size),
                          ("bucket", self.bucket)]:
            if key in state and state[key] != have:
                raise ValueError(
                    f"restoring pipeline state with a different {key} "
                    f"(saved {state[key]!r}, current {have!r})"
                )
        self.epoch = int(state["epoch"])
        self.index = int(state["index"])
        self._order = None

    def __iter__(self):
        return self

    def next_batch(self):
        """The batch-source protocol (what the Prefetcher wraps)."""
        return self.__next__()

    def __next__(self):
        n, b = self.num_examples, self.batch_size
        order = self._epoch_order()
        start, end = self.index, self.index + b
        if end <= n:
            sel = order[start:end]
            weights = np.ones((b,), np.float32)
            self.index = end
        elif start >= n:
            self.epoch += 1
            self.index = 0
            self._order = None
            return self.__next__()
        else:
            sel = order[start:n]
            pad = b - sel.shape[0]
            weights = np.concatenate(
                [np.ones(sel.shape[0], np.float32), np.zeros(pad, np.float32)]
            )
            sel = np.concatenate([sel, np.full(pad, self.lo, np.int64)])
            self.epoch += 1
            self.index = 0
            self._order = None
        # memmap fancy-indexing wants sorted offsets for locality; sorting
        # would undo the shuffle, and chunk-local order is already close.
        ids, vals, labels = self.ds.assemble(sel, bucket=self.bucket)
        return ids, vals, labels, weights


def iter_packed_once(ds: PackedDataset, batch_size: int, bucket: int = 0,
                     row_range=None):
    """One ordered, finite, fixed-shape pass over a packed dataset (or
    its ``row_range``), for evaluation and prediction: the final partial
    batch is zero-padded with weight 0."""
    lo, hi = row_range if row_range is not None else (0, len(ds))
    for start in range(lo, hi, batch_size):
        end = min(start + batch_size, hi)
        ids, vals, labels = ds.assemble(np.s_[start:end], bucket=bucket)
        b = end - start
        pad = batch_size - b
        weights = np.ones((b,), np.float32)
        if pad:
            ids = np.concatenate([ids, np.zeros((pad,) + ids.shape[1:],
                                                ids.dtype)])
            vals = np.concatenate([vals, np.zeros((pad,) + vals.shape[1:],
                                                  vals.dtype)])
            labels = np.concatenate([labels, np.zeros((pad,), labels.dtype)])
            weights = np.concatenate([weights, np.zeros((pad,), np.float32)])
        yield ids, vals, labels, weights

