"""Hot model reload from the checkpoint chain: the serving follower (the
port of ``fm_spark_tpu/serve/reload.py``).

The trainer's chain has an atomic publish point, ``last_good.json``,
which advances only to manifest-verified steps, so deploying the newest
model is a poll: :class:`ReloadFollower` watches ``last_good`` through the
read-only :class:`~fm_spark_tpu_torch.checkpoint.ChainFollower` (it never
writes in the trainer's directory), loads and verifies the new generation
off the request path, and installs it with
:meth:`~fm_spark_tpu_torch.serve.engine.PredictEngine.swap_generation`,
which on the card also captures the generation's graphs before its single
reference store. A request sees one generation, never a mixture.

Failure is a mode, not an exception: when a reload attempt fails (corrupt
bytes, a torn chain, a failed capture, a fault at the ``serve_reload``
point) the follower journals ``reload_failed``, raises the
``serve/degraded`` gauge and keeps serving the old generation; the next
poll tries again from scratch. The ``serve/staleness_steps`` gauge holds
``last_good - served_step`` after every poll.
"""

from __future__ import annotations

import threading
import time

from fm_spark_tpu_torch import obs
from fm_spark_tpu_torch.checkpoint import LAYOUT, ChainFollower
from fm_spark_tpu_torch.resilience import faults

__all__ = ["ReloadFollower"]


class ReloadFollower:
    """Poll a checkpoint chain and hot-swap the engine's generation.

    ``params_example`` (default: the engine's current params) gives the
    tree the chain's arrays are restored into; chain generations must
    share the served model's structure. No optimizer-state example is
    needed: the port's chain is keyed by name and the follower reads the
    params only. ``last_swap`` holds the newest swap's ``step``,
    ``restore_s``, ``h2d_s`` and ``capture_s``.
    """

    def __init__(self, engine, directory: str, *, poll_s: float = 2.0,
                 journal=None, params_example=None):
        self.engine = engine
        self.poll_s = float(poll_s)
        self.journal = journal
        self.chain = ChainFollower(directory, journal=journal)
        self._params_example = (params_example if params_example is not None
                                else engine.generation().params)
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        # Written by the poll thread, read by callers (cli serve's
        # summary, tests): a direct poll_once() racing the loop must not
        # drop a count.
        self._counter_lock = threading.Lock()
        self.reloads = 0
        self.failures = 0
        self.last_swap: dict | None = None

    # ------------------------------------------------------------ polling

    def _emit(self, event: str, **fields) -> None:
        if self.journal is not None:
            self.journal.emit(event, **fields)

    def _set_staleness(self, last_good: int | None, served: int) -> int:
        staleness = (max(int(last_good) - int(served), 0)
                     if last_good is not None else 0)
        obs.gauge("serve/staleness_steps").set(staleness)
        return staleness

    def _fail(self, error: str, target_step: int, served: int) -> None:
        """The degraded-mode transition: count, raise the gauge, journal;
        the old generation keeps serving."""
        with self._counter_lock:
            self.failures += 1
        obs.counter("serve.reload_failures_total").add(1)
        obs.gauge("serve/degraded").set(1)
        self._emit("reload_failed", target_step=int(target_step),
                   served_step=int(served), error=error)

    @property
    def degraded(self) -> bool:
        return bool(obs.gauge("serve/degraded").value or 0)

    @staticmethod
    def _brief(e: BaseException) -> str:
        return f"{type(e).__name__}: {(str(e).splitlines() or [''])[0][:200]}"

    def poll_once(self) -> str:
        """One poll of the chain. Returns the outcome:

        ``no_checkpoint``  nothing published yet
        ``fresh``          serving the newest verified generation
        ``swapped``        a newer generation was loaded and installed
        ``stale_chain``    the chain's verified tip is not newer than the
                           served step (newest steps torn, corrupt or
                           demoted): keep serving what we have
        ``demoted``        the restored generation was tombstoned between
                           restore and swap: refused, the old one serves
        ``failed``         the reload attempt itself failed: degraded
                           mode, the old generation keeps serving
        """
        last_good = self.chain.last_good_step()
        served = self.engine.generation().step
        self._set_staleness(last_good, served)
        if last_good is None:
            return "no_checkpoint"
        if last_good <= served:
            return "fresh"
        t0 = time.perf_counter()
        with obs.span("serve/reload", target_step=int(last_good),
                      served_step=int(served)):
            try:
                # Inside the attempt, before the swap: an injected error
                # takes the degraded path a torn chain would, an injected
                # exit is the SIGKILL-mid-reload drill.
                faults.inject("serve_reload")
                restored = self.chain.restore(self._params_example)
            except Exception as e:  # noqa: BLE001 — degraded mode is the
                # handler: serving must outlive a failed reload
                self._fail(self._brief(e), last_good, served)
                return "failed"
        restore_s = time.perf_counter() - t0
        if restored is None or restored["step"] <= served:
            self._fail("no verified step newer than served generation "
                       "(torn/corrupt/demoted chain tip)", last_good, served)
            return "stale_chain"
        if self.chain.is_tombstoned(restored["step"]):
            # A demotion landed after restore() walked the chain: the
            # verdict wins, even over a loaded and verified generation.
            obs.counter("serve.demoted_refused_total").add(1)
            self._fail(f"generation {restored['step']} was demoted "
                       "mid-reload (tombstone veto)", last_good, served)
            return "demoted"
        layout = restored.get("layout") or LAYOUT
        if layout not in (LAYOUT, "sharded"):
            # A sharded step reads back as canonical tables.
            self._fail(f"chain holds {layout}-layout checkpoints; serving "
                       "follows canonical layouts only", last_good, served)
            return "failed"
        try:
            gen = self.engine.swap_generation(restored["params"],
                                              restored["step"])
        except Exception as e:  # noqa: BLE001 — a failed capture keeps
            # the old generation serving, as any failed reload does
            self._fail(self._brief(e), last_good, served)
            return "failed"
        swap = {"step": gen.step, "restore_s": restore_s,
                "h2d_s": gen.h2d_s, "capture_s": gen.capture_s}
        with self._counter_lock:
            self.reloads += 1
            self.last_swap = swap
        obs.counter("serve.reloads_total").add(1)
        obs.histogram("serve/swap_capture_ms").observe(gen.capture_s * 1e3)
        obs.gauge("serve/degraded").set(0)
        self._set_staleness(self.chain.last_good_step(), gen.step)
        return "swapped"

    # ----------------------------------------------------------- threading

    def start(self) -> "ReloadFollower":
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._loop, name="fm-spark-torch-serve-reload",
                daemon=True)
            self._thread.start()
        return self

    def _loop(self) -> None:
        while not self._stop.wait(self.poll_s):
            t0 = time.perf_counter()
            try:
                self.poll_once()
            except Exception as e:  # noqa: BLE001 — the poll loop must
                # never die silently: journal and keep polling
                self._emit("reload_failed",
                           error=f"poll loop: {self._brief(e)}")
            # A swap's restore, copy and capture count here too.
            obs.histogram("serve/reload_poll_ms").observe(
                (time.perf_counter() - t0) * 1e3)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=30.0)
            self._thread = None
        self.chain.close()
