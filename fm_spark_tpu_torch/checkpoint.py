"""Mid-training checkpoints and resume: the port of
``fm_spark_tpu/checkpoint.py``'s crash-consistent chain, without orbax.

A save holds the full training state: the parameters, the dense
optimizer's state (FieldDeepFM's Adam moments and counts; empty for the
SGD families), the step and the data pipeline's cursor, so a resumed run
replays exactly the batches, step indices and learning rates the
uninterrupted run would have seen and ends with the same bits.

**Step data.** Each step is one directory, ``<dir>/<step>/``, written
under a temporary name, fsynced and renamed. It holds one ``.npy`` per
array under its canonical key (``w0.npy``, ``vw/0.npy``,
``mlp/0/kernel.npy`` … the names of ``models/io.py``; the optimizer's
under ``opt/``, as ``opt/count.npy`` and ``opt/mu/mlp/0/kernel.npy``) and
``state.json``: the step, the pipeline cursor,
``extra``, the layout (``"canonical"``: per-field tables, one card; or
``"sharded"``: each rank of a field-sharded run wrote the fields it
owns, a row shard of a 2-D mesh under ``vw/<field>@<row>``, and the
restore joins them into the canonical tables, see
``parallel.field_step.save_sharded``) and each array's dtype and shape. A bf16 array is stored bit for bit, as its
16-bit pattern (``uint16``) with ``"bfloat16"`` recorded.

**The chain** keeps the reference's files and fields. After a step's
directory is renamed into place its MANIFEST is written atomically,
``manifests/<step>.json``: a crc32 per array of the exact bytes saved
(the reference's ``verify="checksum"``), the crc of the JSON meta, and
the step. Then ``last_good.json`` advances to it.
:meth:`Checkpointer.restore` walks the chain newest-first and trusts
nothing it cannot verify: a step without a manifest newer than
``last_good`` (a torn save), one whose bytes miss their crc or cannot be
read (corrupt), and a tombstoned one are skipped, each with a journal
event, down to the newest verified step; the torn and corrupt steps it
passed are then removed (the resumed run writes them anew) and
``last_good`` points at the restored step. When steps exist and none
verifies it raises :class:`CheckpointChainBroken`; it never starts fresh
silently.

**Demotion.** ``tombstones/<step>.json`` and ``range_<floor>_<tip>.json``
veto a step on every restore and every follow, however well its bytes
verify. :meth:`Checkpointer.demote` and :meth:`~Checkpointer.
demote_newer_than` write them in the reference's crash order: first the
tombstone (one atomic file; a range vetoes every step in ``(floor,
tip]`` at once), then ``last_good`` republished at the newest verified
step no tombstone vetoes. A crash between the two leaves a pointer that
vouches for a vetoed step, which no reader trusts, and the next demotion
repairs it. A chain file write that fails with ENOSPC runs the emergency
GC once (:meth:`Checkpointer._emergency_gc`: tombstoned steps, manifests
of steps that are gone, ``.tmp`` leftovers; never ``last_good``'s step)
and retries once.

**Followers.** :class:`ChainFollower` is the serving side's reader: it
never writes, renames or removes anything in the chain, trusts only
manifest-verified steps, walks back past torn, unreadable and corrupt
ones and returns None when nothing verifies.

**Saves race the next step.** A captured training step updates the
parameters in place on the card. So :meth:`Checkpointer.save` copies
them to the host (into pinned buffers it keeps) and computes their crc32
on the calling thread, before it returns and before the caller issues
the next step; only the file write runs in the background, and
:meth:`wait`/:meth:`close` join it. A write that failed raises at the
next save, wait or close.

``max_to_keep`` keeps the newest steps (and ``last_good``'s) and removes
the rest with their manifests. :class:`PreemptionGuard` turns SIGTERM
into a flag the training loop polls to save and stop (and, where it
displaced the telemetry plane's SIGTERM handler, leaves its flight dump
too).

**Planes.** A save runs in the ``checkpoint/save`` span; its commit
window (the manifest's verification and publish) runs under the
``ckpt_commit`` watchdog phase with the ``ckpt_commit`` fault point and
the ``checkpoint/verify`` span; a restore runs in ``checkpoint/restore``
and a demotion in ``checkpoint/demote``. The fault points ``ckpt_demote``
and ``ckpt_gc`` sit in the demotion's and the emergency GC's windows.
Every chain file (manifests, tombstones, ``last_good``) is written and
read through :mod:`~fm_spark_tpu_torch.utils.durable` with path class
``ckpt``, so an ``io_*.ckpt`` fault plan reaches it.
"""

from __future__ import annotations

import errno
import json
import os
import shutil
import signal
import threading
import time
import zlib
from typing import Any

import numpy as np
import torch

from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.models.io import flatten, unflatten
from fm_spark_tpu_torch.resilience import faults, watchdog
from fm_spark_tpu_torch.utils import durable

__all__ = ["ChainFollower", "CheckpointChainBroken", "CheckpointIOError",
           "Checkpointer", "PreemptionGuard", "copy_into"]

#: The layout a save records: per-field tables in the canonical tree.
LAYOUT = "canonical"
#: Bounded retry of a chain-file write (the reference's backoff).
_IO_RETRY_BACKOFF_S = (0.05, 0.1, 0.2)


class CheckpointChainBroken(RuntimeError):
    """Checkpoints exist but none passed verification (every step torn
    or corrupt), or an explicit step is vetoed or corrupt. Restarting
    from scratch silently would discard the run's progress."""


class CheckpointIOError(RuntimeError):
    """A checkpoint write failed (after bounded retry for the chain
    files). The ``OSError`` rides as ``__cause__``; ``errno`` mirrors it."""

    def __init__(self, path: str, exc: BaseException):
        super().__init__(f"checkpoint durable write failed: {path} "
                         f"({type(exc).__name__}: {exc})")
        self.path = path
        self.errno = getattr(exc, "errno", None)


#: The key prefix of the optimizer state's arrays.
OPT = "opt"


def _flatten(params, opt_state=None) -> dict[str, torch.Tensor]:
    """The canonical keys of ``models/io.py`` (``w0``, ``vw/0``,
    ``mlp/0/kernel`` …), and the optimizer state's under ``opt/``."""
    flat = flatten(params)
    if opt_state:
        flat.update(flatten(opt_state, OPT))
    return flat


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _checksum(dtype: str, arr: np.ndarray) -> str:
    crc = zlib.crc32(memoryview(arr.reshape(-1)).cast("B"))
    return f"{dtype}:{tuple(arr.shape)}:{crc:08x}"


def _meta_crc(meta: dict) -> str:
    return f"{zlib.crc32(json.dumps(meta, sort_keys=True).encode()):08x}"


def _to_tensor(dtype: str, arr: np.ndarray) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    t = torch.from_numpy(arr)
    if _dtype_name(t.dtype) != dtype:
        raise ValueError(f"array stored as {arr.dtype}, recorded {dtype}")
    return t


def copy_into(params, restored) -> None:
    """Copy a restored tree (host tensors) into ``params`` (or an optimizer
    state) in place, so a captured step bound to its storage steps the
    restored values. Keys, shapes and dtypes must match."""
    want, got = flatten(params), flatten(restored)
    if sorted(want) != sorted(got):
        raise ValueError(f"checkpoint holds {sorted(got)}, the model "
                         f"{sorted(want)}")
    for key, t in want.items():
        src = got[key]
        if tuple(src.shape) != tuple(t.shape) or src.dtype != t.dtype:
            raise ValueError(
                f"checkpoint array {key} is {src.dtype} {tuple(src.shape)}, "
                f"the model's {t.dtype} {tuple(t.shape)}")
        t.copy_(src.reshape(t.shape))


def _step_json_names(directory: str) -> list[int]:
    steps = []
    try:
        names = os.listdir(directory)
    except OSError:
        return steps
    for fname in names:
        if fname.endswith(".json"):
            try:
                steps.append(int(fname[:-5]))
            except ValueError:
                continue
    return steps


class _Tombstones:
    """The vetoed steps: ``<step>.json`` singles and
    ``range_<floor>_<tip>.json`` stones (every step in ``(floor, tip]``),
    tested as intervals."""

    def __init__(self, directory: str):
        self.singles = set(_step_json_names(directory))
        self.ranges = []
        try:
            names = os.listdir(directory)
        except OSError:
            names = []
        for fname in names:
            if fname.startswith("range_") and fname.endswith(".json"):
                parts = fname[len("range_"):-len(".json")].split("_")
                try:
                    self.ranges.append((int(parts[0]), int(parts[1])))
                except (IndexError, ValueError):
                    continue

    def __contains__(self, step) -> bool:
        step = int(step)
        return step in self.singles or any(
            floor < step <= tip for floor, tip in self.ranges)

    def frontier(self) -> int:
        """The highest vetoed step, 0 when none."""
        tips = [max(self.singles)] if self.singles else []
        tips += [tip for _, tip in self.ranges]
        return max(tips) if tips else 0


class _Snapshot:
    """One save's host copy: ``arrays`` (numpy, bf16 as uint16) keyed
    canonically, with their dtype names."""

    def __init__(self, arrays: dict, dtypes: dict):
        self.arrays = arrays
        self.dtypes = dtypes

    @property
    def nbytes(self) -> int:
        return sum(a.nbytes for a in self.arrays.values())


def _read_tombstones(directory: str) -> _Tombstones:
    """The tombstones of the chain at ``directory``, read from disk now
    (a trainer demotes underneath a polling follower)."""
    return _Tombstones(os.path.join(directory, "tombstones"))


def _expanded(stones: _Tombstones) -> set[int]:
    out = set(stones.singles)
    for floor, tip in stones.ranges:
        out.update(range(floor + 1, tip + 1))
    return out


def _read_step(step_dir: str):
    """``(state, {key: (dtype, array)}, bytes, read_ms)`` of the step
    saved in ``step_dir``, in whatever layout it records."""
    t0 = time.perf_counter()
    with obs.span("checkpoint/restore",
                  step=int(os.path.basename(step_dir))):
        state = durable.read_json(os.path.join(step_dir, "state.json"),
                                  path_class="ckpt")
        arrays = {}
        for key, info in state["arrays"].items():
            arr = np.load(os.path.join(step_dir, info["file"]),
                          allow_pickle=False)
            if list(arr.shape) != list(info["shape"]):
                raise ValueError(f"{key}: shape {arr.shape} != recorded "
                                 f"{info['shape']}")
            arrays[key] = (info["dtype"], arr)
    nbytes = sum(a.nbytes for _, a in arrays.values())
    return state, arrays, nbytes, (time.perf_counter() - t0) * 1e3


def _matches(state, arrays, manifest: dict) -> bool:
    """Do a step's arrays and meta match its manifest's crc32s?"""
    got = {k: _checksum(dt, a) for k, (dt, a) in arrays.items()}
    meta = {"pipeline": state.get("pipeline"), "extra": state.get("extra")}
    return (got == manifest.get("checksums")
            and _meta_crc(meta) == manifest.get("meta_crc"))


def _result(step, state, arrays, params_example):
    """The restore dict of a read step (see :meth:`Checkpointer.restore`);
    ``layout`` is the layout the step records."""
    flat = _join_row_shards({k: _to_tensor(dt, a)
                             for k, (dt, a) in arrays.items()})
    opt = {k[len(OPT) + 1:]: v for k, v in flat.items()
           if k.startswith(OPT + "/")}
    params: Any = {k: v for k, v in flat.items()
                   if not k.startswith(OPT + "/")}
    if params_example is not None:
        names = list(flatten(params_example))
        missing = [n for n in names if n not in params]
        if missing:
            raise ValueError(f"checkpoint step {step} holds no arrays "
                             f"{missing} (it holds {sorted(params)})")
        params = unflatten(params, names)
    return {"params": params, "opt_state": opt, "step": int(step),
            "pipeline": state.get("pipeline"), "extra": state.get("extra"),
            "layout": state.get("layout", LAYOUT), "mesh": state.get("mesh")}


def _join_row_shards(flat: dict) -> dict:
    """A sharded step's row shards (``vw/3@0``, ``vw/3@1`` … of a 2-D
    mesh's field 3) joined into their canonical table, in row order."""
    parts: dict = {}
    out = {}
    for key, t in flat.items():
        base, at, row = key.partition("@")
        if at:
            parts.setdefault(base, {})[int(row)] = t
        else:
            out[key] = t
    for base, rows in parts.items():
        out[base] = torch.cat([rows[r] for r in sorted(rows)], dim=0)
    return out


class Checkpointer:
    """The crash-consistent checkpoint chain of a training run (see the
    module's docstring).

    ``save_every`` is the cadence :meth:`due`, :meth:`due_window` and
    :meth:`maybe_save` test; :meth:`save` writes now. ``journal`` (an
    object with ``emit(event, **fields)``, such as
    :class:`~fm_spark_tpu_torch.utils.logging.EventLog`) receives the
    chain's events: ``checkpoint_verified`` and ``checkpoint_save_skipped``,
    and on restore ``checkpoint_unverified_skipped``,
    ``checkpoint_corrupt``, ``checkpoint_unreadable``,
    ``checkpoint_demoted_skipped``, ``checkpoint_walked_back`` and
    ``checkpoint_stale_removed``. ``timings`` lists each save's
    ``snapshot_ms``, ``crc_ms``, ``write_ms`` and ``bytes``;
    ``restore_timing`` the last restore's ``read_ms``, ``verify_ms`` and
    ``bytes``.

    Usage::

        ckpt = Checkpointer(dir, save_every=1000)
        restored = ckpt.restore(params)          # None on a fresh dir
        ...
        ckpt.maybe_save(step, params, pipeline_state)
        ...
        ckpt.close()
    """

    def __init__(self, directory: str, save_every: int = 1000,
                 max_to_keep: int = 3, journal=None):
        if max_to_keep < 1:
            raise ValueError(f"max_to_keep must be >= 1, got {max_to_keep}")
        self.directory = os.path.abspath(str(directory))
        self.save_every = int(save_every)
        self._max_to_keep = int(max_to_keep)
        self.journal = journal
        self._writer: threading.Thread | None = None
        self._writer_error: BaseException | None = None
        self._pinned: dict[str, torch.Tensor] = {}
        self.timings: list[dict] = []
        self.restore_timing: dict | None = None
        os.makedirs(self.directory, exist_ok=True)
        # A step directory still under its temporary name was never
        # renamed into place: no reader can load it.
        for fname in os.listdir(self.directory):
            if ".tmp-" in fname:
                shutil.rmtree(os.path.join(self.directory, fname),
                              ignore_errors=True)

    # ------------------------------------------------------------ layout

    def _emit(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.emit(event, **fields)

    @property
    def _manifest_dir(self) -> str:
        return os.path.join(self.directory, "manifests")

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self._manifest_dir, f"{int(step)}.json")

    @property
    def _last_good_path(self) -> str:
        return os.path.join(self.directory, "last_good.json")

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def all_steps(self) -> list[int]:
        """The committed steps (directories renamed into place), oldest
        first."""
        steps = []
        for fname in os.listdir(self.directory):
            if fname.isdigit() and os.path.isdir(
                    os.path.join(self.directory, fname)):
                steps.append(int(fname))
        return sorted(steps)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def last_good_step(self) -> int | None:
        """The persisted last verified step."""
        try:
            step = durable.read_json(self._last_good_path,
                                     path_class="ckpt").get("step")
            return int(step) if step is not None else None
        except (OSError, ValueError, TypeError, AttributeError):
            return None

    def tombstoned_steps(self) -> set[int]:
        """The demoted steps, every step of a range stone listed."""
        return _expanded(_read_tombstones(self.directory))

    def is_tombstoned(self, step: int) -> bool:
        return int(step) in _read_tombstones(self.directory)

    def tombstone_frontier(self) -> int:
        """The highest demoted step (0 when none): the step axis must
        continue PAST it — a post-rollback save reusing a demoted step
        number would resurrect the vetoed generation's slot."""
        return _read_tombstones(self.directory).frontier()

    @property
    def _tombstone_dir(self) -> str:
        return os.path.join(self.directory, "tombstones")

    def _known_steps(self) -> set[int]:
        """The committed steps and the steps that have a manifest."""
        return set(self.all_steps()) | set(
            _step_json_names(self._manifest_dir))

    def _quarantined(self) -> int:
        """How many existing saves the tombstones veto (the gauge)."""
        stones = _read_tombstones(self.directory)
        return sum(1 for s in self._known_steps() if s in stones)

    # ----------------------------------------------------------- demotion

    def demote(self, step: int, reason: str = "") -> bool:
        """Demote one save: the coordinated-rollback primitive.

        Writes (1) the tombstone ``tombstones/<step>.json`` (one atomic
        JSON with the step and the verdict), then (2) ``last_good``
        republished at the newest verified step no tombstone vetoes. A
        crash between the two leaves the pointer vouching for the
        demoted step; every reader checks tombstones first, and the next
        demotion repairs the pointer. The ``ckpt_demote`` fault point
        sits in that window. Returns False (only the repair) when the
        step is already tombstoned."""
        step = int(step)
        self.wait()
        with obs.span("checkpoint/demote", step=step):
            stones = _read_tombstones(self.directory)
            if step in stones:
                self._repair_pointer(stones)
                return False
            os.makedirs(self._tombstone_dir, exist_ok=True)
            self._durable_json(
                os.path.join(self._tombstone_dir, f"{step}.json"),
                {"step": step, "reason": str(reason)[:500],
                 "ts": round(time.time(), 3)})
            self._emit("generation_demoted", step=step,
                       reason=str(reason)[:200])
            obs.counter("checkpoint.demotions_total").add(1)
            obs.gauge("checkpoint/quarantined_generations").set(
                self._quarantined())
            faults.inject("ckpt_demote")
            self._republish_last_good()
        return True

    def demote_newer_than(self, step: int, reason: str = "") -> list[int]:
        """Demote every committed or manifested step newer than ``step``
        (the pre-drift save) with ONE atomic range tombstone
        ``range_<step>_<tip>.json`` vetoing ``(step, tip]``, so a crash
        never leaves a partly demoted suffix; then republish the pointer
        (the ``ckpt_demote`` fault point between the two writes). Returns
        the newly demoted steps; ``[]`` (and only the pointer's repair)
        when none is left to demote."""
        floor = int(step)
        self.wait()
        stones = _read_tombstones(self.directory)
        demoted = sorted(s for s in self._known_steps()
                         if s > floor and s not in stones)
        if not demoted:
            self._repair_pointer(stones)
            return []
        tip = demoted[-1]
        with obs.span("checkpoint/demote", floor=floor, tip=tip):
            os.makedirs(self._tombstone_dir, exist_ok=True)
            self._durable_json(
                os.path.join(self._tombstone_dir,
                             f"range_{floor}_{tip}.json"),
                {"newer_than": floor, "through": tip, "steps": demoted,
                 "reason": str(reason)[:500], "ts": round(time.time(), 3)})
            self._emit("generation_demoted", steps=demoted,
                       newer_than=floor, reason=str(reason)[:200])
            obs.counter("checkpoint.demotions_total").add(len(demoted))
            obs.gauge("checkpoint/quarantined_generations").set(
                self._quarantined())
            faults.inject("ckpt_demote")
            self._republish_last_good()
        return demoted

    def _repair_pointer(self, stones: _Tombstones) -> None:
        """A re-run after a crash inside the demotion window: the
        tombstone is durable but the pointer may still vouch for a
        vetoed step."""
        lg = self.last_good_step()
        if lg is not None and lg in stones:
            self._republish_last_good()

    def _republish_last_good(self) -> None:
        """Point ``last_good`` atomically at the newest manifested,
        committed step no tombstone vetoes; ``{"step": null}`` when none
        qualifies (readers then find nothing published)."""
        stones = _read_tombstones(self.directory)
        committed = set(self.all_steps())
        good = sorted((s for s in _step_json_names(self._manifest_dir)
                       if s in committed and s not in stones), reverse=True)
        prev = self.last_good_step()
        new = good[0] if good else None
        self._durable_json(self._last_good_path,
                           {"step": new, "ts": round(time.time(), 3)})
        self._emit("last_good_republished", prev=prev, step=new)

    def _read_manifest(self, step: int) -> dict | None:
        try:
            return durable.read_json(self._manifest_path(step),
                                     path_class="ckpt")
        except (OSError, ValueError):
            return None

    def _chain_active(self) -> bool:
        """Has this directory ever had a manifest? Once it has, a step
        without one newer than ``last_good`` is a torn save."""
        try:
            return any(f.endswith(".json")
                       for f in os.listdir(self._manifest_dir))
        except OSError:
            return False

    # ------------------------------------------------------------ cadence

    def due(self, step: int) -> bool:
        """Is ``step`` on the save cadence?"""
        return self.save_every > 0 and step % self.save_every == 0

    def due_window(self, step: int, window: int) -> bool:
        """Does a multiple of ``save_every`` fall in ``(step - window,
        step]``? The cadence of a loop that advances ``window`` steps per
        call."""
        if self.save_every <= 0 or window <= 0:
            return False
        return (step // self.save_every) > ((step - window)
                                            // self.save_every)

    def maybe_save(self, step: int, params, pipeline_state=None,
                   extra=None, *, opt_state=None) -> bool:
        """Save iff ``step`` is on the cadence. Returns whether it saved."""
        if not self.due(step):
            return False
        return self.save(step, params, pipeline_state, extra,
                         opt_state=opt_state)

    # --------------------------------------------------------------- save

    def _snapshot(self, params, opt_state=None) -> _Snapshot:
        """The params and optimizer state on the host, copied before this
        returns: on the card into pinned buffers kept across saves (the
        writer of the previous save has been joined, so they are free)."""
        arrays, dtypes = {}, {}
        for key, t in _flatten(params, opt_state).items():
            t = t.detach()
            if t.device.type == "cuda":
                buf = self._pinned.get(key)
                if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    self._pinned[key] = buf
                buf.copy_(t)
            else:
                buf = t.clone()
            dtypes[key] = _dtype_name(t.dtype)
            if t.dtype == torch.bfloat16:
                arrays[key] = buf.view(torch.int16).numpy().view(np.uint16)
            else:
                arrays[key] = buf.numpy()
        return _Snapshot(arrays, dtypes)

    def save(self, step: int, params, pipeline_state: dict | None = None,
             extra: dict | None = None, force: bool = False, *,
             opt_state=None) -> bool:
        """Save ``params`` (the canonical tree of tensors) and
        ``opt_state`` (the dense optimizer's tree; None or empty for none)
        at ``step`` with the pipeline cursor and ``extra``. The host
        snapshot and its crc32 are taken before this returns; the file
        write runs in the background. Returns whether the chain holds the
        step afterwards:
        a step already in the chain is not written again (True; training
        state at a step is unique), unless a tombstone vetoes it (False).
        A step older than the newest step that no tombstone vetoes is not
        written (False) unless ``force``. Each refusal is journaled as
        ``checkpoint_save_skipped``."""
        step = int(step)
        self.wait()
        stones = _read_tombstones(self.directory)
        if os.path.isdir(self._step_dir(step)):
            if step not in stones:
                return True
            self._emit("checkpoint_save_skipped", step=step,
                       reason="tombstoned")
            return False
        live = [s for s in self.all_steps() if s not in stones]
        if not force and live and step < live[-1]:
            self._emit("checkpoint_save_skipped", step=step,
                       reason=f"older than step {live[-1]}")
            return False
        meta = {"pipeline": pipeline_state, "extra": extra}
        with obs.span("checkpoint/save", step=step, force=bool(force)):
            t0 = time.perf_counter()
            snap = self._snapshot(params, opt_state)
            t1 = time.perf_counter()
            checksums = {k: _checksum(snap.dtypes[k], a)
                         for k, a in snap.arrays.items()}
            t2 = time.perf_counter()
        manifest = {"step": step, "checksums": checksums,
                    "meta_crc": _meta_crc(meta), "ts": round(time.time(), 3)}
        timing = {"step": step, "snapshot_ms": (t1 - t0) * 1e3,
                  "crc_ms": (t2 - t1) * 1e3, "bytes": snap.nbytes,
                  "forced": bool(force)}
        self.timings.append(timing)
        self._writer = threading.Thread(
            target=self._write_guarded,
            args=(step, snap, meta, manifest, timing), daemon=True)
        self._writer.start()
        return True

    def _write_guarded(self, *args) -> None:
        try:
            self._commit(*args)
        except BaseException as e:  # noqa: BLE001 — raised at the next join
            self._writer_error = e

    def _commit(self, step, snap: _Snapshot, meta, manifest, timing) -> None:
        """Write the step under a temporary name, fsync, rename; then its
        manifest and ``last_good``; then collect old steps."""
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = f"{final}.tmp-{os.getpid()}"
        try:
            os.makedirs(tmp)
            arrays = {}
            for key, arr in snap.arrays.items():
                rel = key + ".npy"
                path = os.path.join(tmp, rel)
                os.makedirs(os.path.dirname(path), exist_ok=True)
                with open(path, "wb") as f:
                    np.lib.format.write_array(f, arr, allow_pickle=False)
                    f.flush()
                    os.fsync(f.fileno())
                arrays[key] = {"file": rel, "dtype": snap.dtypes[key],
                               "shape": list(arr.shape)}
            state = {"step": step, "layout": LAYOUT, "arrays": arrays,
                     **meta}
            with open(os.path.join(tmp, "state.json"), "w") as f:
                json.dump(state, f)
                f.flush()
                os.fsync(f.fileno())
            for sub in {os.path.dirname(a["file"]) for a in arrays.values()}:
                durable.fsync_dir(os.path.join(tmp, sub), "ckpt")
            durable.fsync_dir(tmp, "ckpt")
            os.rename(tmp, final)
            durable.fsync_dir(self.directory, "ckpt")
        except OSError as e:
            shutil.rmtree(tmp, ignore_errors=True)
            raise CheckpointIOError(final, e) from e
        timing["write_ms"] = (time.perf_counter() - t0) * 1e3
        # The commit window: the step's bytes are in place, its manifest
        # not yet written (a torn save no reader trusts). It runs under
        # the ckpt_commit deadline, so a hang here is a structured
        # HangDetected, and holds the ckpt_commit fault point.
        with watchdog.phase("ckpt_commit"):
            faults.inject("ckpt_commit")
            with obs.span("checkpoint/verify", step=int(step)):
                os.makedirs(self._manifest_dir, exist_ok=True)
                self._durable_json(self._manifest_path(step), manifest)
                prev = self.last_good_step()
                if self.is_tombstoned(step):
                    self._emit("checkpoint_verified_demoted", step=step)
                elif prev is None or step > prev:
                    self._durable_json(
                        self._last_good_path,
                        {"step": step, "ts": round(time.time(), 3)})
        self._emit("checkpoint_verified", step=step,
                   last_good=max(step, prev or step))
        self._collect()

    def _collect(self) -> None:
        """``max_to_keep``: remove all but the newest steps (never
        ``last_good``'s), and the manifests of steps that are gone."""
        steps = self.all_steps()
        keep = set(steps[-self._max_to_keep:])
        last_good = self.last_good_step()
        if last_good is not None:
            keep.add(last_good)
        for s in steps:
            if s not in keep:
                shutil.rmtree(self._step_dir(s), ignore_errors=True)
        live = set(self.all_steps())
        for s in _step_json_names(self._manifest_dir):
            if s not in live:
                try:
                    os.unlink(self._manifest_path(s))
                except OSError:
                    pass

    def _durable_json(self, path: str, obj: dict) -> None:
        """One fail-loud chain-file write: transient errors retry with
        bounded backoff; ENOSPC runs the emergency GC and then exactly one
        more attempt; what still fails raises :class:`CheckpointIOError`."""
        for attempt, delay in enumerate(_IO_RETRY_BACKOFF_S, 1):
            try:
                durable.atomic_write_json(path, obj, path_class="ckpt")
                return
            except OSError as e:
                name = os.path.basename(path)
                if getattr(e, "errno", None) == errno.ENOSPC:
                    self._emergency_gc(trigger=name)
                    try:
                        durable.atomic_write_json(path, obj,
                                                  path_class="ckpt")
                        return
                    except OSError as e2:
                        self._emit("checkpoint_io_error", path=name,
                                   errno=getattr(e2, "errno", None))
                        raise CheckpointIOError(path, e2) from e2
                if attempt == len(_IO_RETRY_BACKOFF_S):
                    self._emit("checkpoint_io_error", path=name,
                               errno=getattr(e, "errno", None))
                    raise CheckpointIOError(path, e) from e
                self._emit("ckpt_io_retry", path=name, attempt=attempt,
                           errno=getattr(e, "errno", None), delay_s=delay)
                time.sleep(delay)

    def _emergency_gc(self, trigger: str = "") -> list[int]:
        """ENOSPC's last resort: delete what no reader may ever load —
        tombstoned steps (data and manifest), manifests of steps that are
        gone, and ``.tmp`` leftovers of torn atomic writes. The intent is
        journaled first (``ckpt_emergency_gc``), so a crash mid-GC (the
        ``ckpt_gc`` fault point) is recovered by running it again: every
        victim was already unloadable. ``last_good``'s step is never a
        victim. Returns the tombstoned steps collected."""
        stones = _read_tombstones(self.directory)
        committed = set(self.all_steps())
        manifested = set(_step_json_names(self._manifest_dir))
        keep = self.last_good_step()
        victims = sorted(s for s in committed | manifested
                         if s in stones and s != keep)
        orphans = sorted(s for s in manifested - committed
                         if s not in stones and s != keep)
        self._emit("ckpt_emergency_gc", trigger=trigger, steps=victims,
                   manifests=orphans)
        obs.counter("checkpoint.emergency_gc_total").add(1)
        faults.inject("ckpt_gc")
        for s in victims:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
        for s in victims + orphans:
            try:
                os.unlink(self._manifest_path(s))
            except OSError:
                pass
        for d in (self.directory, self._manifest_dir, self._tombstone_dir):
            try:
                names = os.listdir(d)
            except OSError:
                continue
            for fname in names:
                if fname.endswith(".tmp"):
                    try:
                        os.unlink(os.path.join(d, fname))
                    except OSError:
                        pass
        self._emit("ckpt_emergency_gc_done", steps=victims)
        return victims

    def wait(self) -> None:
        """Join the background write, if any; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._writer_error is not None:
            err, self._writer_error = self._writer_error, None
            raise err

    def close(self) -> None:
        self.wait()

    # ------------------------------------------------------------ restore

    def _read_step(self, step: int):
        """:func:`_read_step` of a step in the canonical layout or the
        sharded one (which reads back as canonical tables; another layout
        is unreadable to a training run)."""
        state, arrays, nbytes, read_ms = _read_step(self._step_dir(step))
        if state.get("layout", LAYOUT) not in (LAYOUT, "sharded"):
            raise ValueError(f"checkpoint step {step} has layout "
                             f"{state.get('layout')!r}, not {LAYOUT!r}")
        return state, arrays, nbytes, read_ms

    def _remove_stale(self, stale: list[int], restored: int) -> None:
        """Remove the steps a walk-back passed as torn, unreadable or
        corrupt (all newer than ``restored``) with their manifests, and
        point ``last_good`` at ``restored``: nothing newer verifies, and
        the resumed run's saves of those steps must be written anew and
        advance the pointer again."""
        for s in stale:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)
            try:
                os.unlink(self._manifest_path(s))
            except OSError:
                pass
        durable.fsync_dir(self.directory, "ckpt")
        self._durable_json(self._last_good_path,
                           {"step": restored, "ts": round(time.time(), 3)})
        self._emit("checkpoint_stale_removed", steps=stale,
                   last_good=restored)

    def restore(self, params_example=None, step: int | None = None):
        """Restore the newest VERIFIED step (or exactly ``step``).

        Returns None when the chain holds no step, else ``{"params",
        "opt_state", "step", "pipeline", "extra"}``: ``params`` host
        tensors in the tree of ``params_example`` (the canonical flat dict
        without one), ``opt_state`` the flat dict of the optimizer state's
        arrays by canonical key (``{}`` for a chain saved without one);
        :func:`copy_into` moves them into the model's tensors.

        The walk-back skips, newest first, a tombstoned step, a step with
        no manifest newer than ``last_good`` (torn), one that cannot be
        read (unreadable) and one that misses its crc (corrupt), each
        with a journal event, then removes the torn, unreadable and
        corrupt steps it passed and points ``last_good`` at the restored
        step (``checkpoint_stale_removed``), so the resumed run writes
        those steps anew; it raises :class:`CheckpointChainBroken` when
        steps exist and none verifies. An explicit ``step`` skips
        the walk-back and fails loudly: a tombstone or a crc mismatch
        raises :class:`CheckpointChainBroken`, a missing or unreadable
        step its ``OSError`` or ``ValueError``.
        """
        self.wait()
        stones = _read_tombstones(self.directory)
        if step is not None:
            step = int(step)
            if step in stones:
                raise CheckpointChainBroken(
                    f"checkpoint step {step} carries a demotion tombstone; "
                    "restoring it explicitly would resurrect a vetoed model")
            state, arrays, nbytes, read_ms = self._read_step(step)
            manifest = self._read_manifest(step)
            t0 = time.perf_counter()
            if manifest is not None and not _matches(state, arrays,
                                                          manifest):
                raise CheckpointChainBroken(
                    f"checkpoint step {step} fails its manifest checksums "
                    "(corrupt bytes); pick another step or restore without "
                    "an explicit step to walk back automatically")
            self.restore_timing = {
                "step": step, "read_ms": read_ms, "bytes": nbytes,
                "verify_ms": (time.perf_counter() - t0) * 1e3}
            return _result(step, state, arrays, params_example)
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            return None
        chain_active = self._chain_active()
        last_good = self.last_good_step()
        stale = []
        for s in steps:
            if s in stones:
                self._emit("checkpoint_demoted_skipped", step=s)
                continue
            manifest = self._read_manifest(s)
            if manifest is None and chain_active and (
                    last_good is None or s > last_good):
                self._emit("checkpoint_unverified_skipped", step=s)
                stale.append(s)
                continue
            try:
                state, arrays, nbytes, read_ms = self._read_step(s)
            except (OSError, ValueError, KeyError, TypeError) as e:
                self._emit("checkpoint_unreadable", step=s,
                           error=f"{type(e).__name__}: "
                                 f"{(str(e).splitlines() or [''])[0][:200]}")
                stale.append(s)
                continue
            t0 = time.perf_counter()
            if manifest is not None and not _matches(state, arrays,
                                                          manifest):
                self._emit("checkpoint_corrupt", step=s)
                stale.append(s)
                continue
            if s != steps[0]:
                self._emit("checkpoint_walked_back", from_step=steps[0],
                           to_step=s)
            self.restore_timing = {
                "step": s, "read_ms": read_ms, "bytes": nbytes,
                "verify_ms": (time.perf_counter() - t0) * 1e3}
            if stale or (last_good is not None and last_good > s):
                self._remove_stale(stale, s)
            return _result(s, state, arrays, params_example)
        raise CheckpointChainBroken(
            f"{len(steps)} checkpoint step(s) exist under {self.directory} "
            "but none passed verification (all torn or corrupt); refusing "
            "to silently restart from scratch")


class ChainFollower:
    """Read-only reader of a checkpoint chain, for serving followers (the
    port of ``fm_spark_tpu/checkpoint.py``'s ``ChainFollower``).

    It never writes, renames or removes anything under ``directory``
    (:meth:`Checkpointer.restore` removes stale steps and rewrites
    ``last_good``, so a follower cannot reuse it): a step that fails
    verification is skipped and journaled, never repaired. It trusts
    only manifest-verified steps (no leniency for a chain without
    manifests) and walks back from the newest manifested step past torn,
    unreadable and corrupt ones, returning None, not raising, when
    nothing verifies. A tombstoned step is skipped even when its bytes
    verify and a stale ``last_good`` still vouches for it; the reload
    path checks :meth:`is_tombstoned` again just before its swap.

    The port's chain is keyed by name, so the follower reads the params
    (and the optimizer state, returned flat) without an optimizer-state
    example.
    """

    def __init__(self, directory: str, journal=None):
        self.directory = os.path.abspath(str(directory))
        self.journal = journal

    def _emit(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.emit(event, **fields)

    @property
    def _manifest_dir(self) -> str:
        return os.path.join(self.directory, "manifests")

    def last_good_step(self) -> int | None:
        """The trainer's published last verified step: None when absent,
        cleared or torn."""
        try:
            step = durable.read_json(
                os.path.join(self.directory, "last_good.json"),
                path_class="ckpt").get("step")
            return int(step) if step is not None else None
        except (OSError, ValueError, TypeError, AttributeError):
            return None

    def tombstoned_steps(self) -> set[int]:
        return _expanded(_read_tombstones(self.directory))

    def is_tombstoned(self, step: int) -> bool:
        return int(step) in _read_tombstones(self.directory)

    def _read_manifest(self, step: int) -> dict | None:
        try:
            return durable.read_json(
                os.path.join(self._manifest_dir, f"{int(step)}.json"),
                path_class="ckpt")
        except (OSError, ValueError):
            return None

    def restore(self, params_example=None):
        """The newest manifest-verified step no tombstone vetoes, as
        :meth:`Checkpointer.restore`'s dict (host tensors; ``layout`` the
        step's own, its params left flat when it is not canonical), or
        None when no step verifies."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return None
        committed = {int(n) for n in names if n.isdigit() and os.path.isdir(
            os.path.join(self.directory, n))}
        stones = _read_tombstones(self.directory)
        steps = sorted((s for s in _step_json_names(self._manifest_dir)
                        if s in committed), reverse=True)
        for s in steps:
            if s in stones:
                self._emit("checkpoint_demoted_skipped", step=s)
                continue
            manifest = self._read_manifest(s)
            if manifest is None:
                continue
            try:
                state, arrays, _, _ = _read_step(
                    os.path.join(self.directory, str(s)))
                layout = state.get("layout", LAYOUT)
                if not _matches(state, arrays, manifest):
                    self._emit("checkpoint_corrupt", step=s)
                    continue
                result = _result(s, state, arrays, params_example
                                 if layout in (LAYOUT, "sharded") else None)
            except (OSError, ValueError, KeyError, TypeError) as e:
                self._emit("checkpoint_unreadable", step=s,
                           error=f"{type(e).__name__}: "
                                 f"{(str(e).splitlines() or [''])[0][:200]}")
                continue
            if s != steps[0]:
                self._emit("checkpoint_walked_back", from_step=steps[0],
                           to_step=s)
            return result
        return None

    def close(self) -> None:
        """Nothing to release: the follower holds no file open."""


class PreemptionGuard:
    """Preemption signal → flag; the training loop saves and stops.

    Preemption arrives as SIGTERM with a grace window, so SIGTERM is the
    default; ``signals=(signal.SIGTERM, signal.SIGINT)`` also catches
    Ctrl-C. Signal handlers install only in the main thread; elsewhere
    the guard is an always-False flag."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._flag = threading.Event()
        self._previous: dict[int, Any] = {}

    @property
    def should_stop(self) -> bool:
        return self._flag.is_set()

    def _handler(self, signum, frame):
        self._flag.set()
        if obs.is_signal_dump(self._previous.get(signum)):
            # The telemetry plane's dump runs too; its delegate to the
            # default ending does not: this guard's save-and-stop is the
            # ending.
            obs.signal_dump(signum)

    def __enter__(self) -> "PreemptionGuard":
        if threading.current_thread() is threading.main_thread():
            for sig in self._signals:
                self._previous[sig] = signal.signal(sig, self._handler)
        return self

    def __exit__(self, *exc) -> None:
        for sig, prev in self._previous.items():
            signal.signal(sig, prev)
        self._previous.clear()
