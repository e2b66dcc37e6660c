"""Trigger-fired deep introspection (the port's copy of
``fm_spark_tpu/obs/introspect.py``): capture the evidence AT the anomaly,
while the anomalous program is still resident. Each of the TRIGGERS — a
sentinel ``regressed`` verdict, a watchdog near miss (a phase past
:data:`NEAR_MISS_FRACTION` of its deadline), a serve SLO overrun, a p99
step-time spike against the trailing window — arms ONE bounded capture
bundle under the run's obs directory::

    <run dir>/captures/<trigger>_<seq>/
        capture.json      atomic manifest: trigger, context, profiler
                          status, run_id, ts (the bundle is valid iff
                          this file parses)
        metrics.json      the metrics registry's snapshot at fire time
        flight.json       the flight recorder's last-N window
        profile/          a bounded ``torch.profiler`` trace (CPU and
                          CUDA activity) stopped at the first step
                          boundary past ``trace_s``

Contracts, as for the rest of the obs plane:

- the disabled path is one None check: :func:`fire`,
  :func:`observe_step_time` and :func:`tick` read a module global when
  no engine is configured;
- rate-limited: at most ``max_per_trigger`` bundles per trigger per run
  and ``min_interval_s`` between two of one trigger; suppressed fires
  are counted (``introspect.suppressed_total``);
- crash-safe and best-effort: a capture never takes down the run it
  narrates; the manifest is written atomically LAST; torch is looked
  up in ``sys.modules``, never imported;
- the profiler is never pinned open: a trace is begun only on the main
  thread (PyTorch's profiler stops only on the thread that began it),
  the first step boundary there past ``trace_s`` (:func:`tick`, which
  the training loops call) stops it, and :func:`clear`
  (``obs.shutdown``) stops one still running. A fire on another thread,
  during a CUDA graph capture or beside another profiler session
  (``fmtorch train --profile``: PyTorch runs one at a time) records its
  skip in the bundle.

The module also holds the reference's per-step cost model
(:func:`step_cost_model`).
"""

from __future__ import annotations

import collections
import json
import os
import threading
import time

from fm_spark_tpu_torch.utils import durable

__all__ = [
    "CAPTURES_DIRNAME",
    "NEAR_MISS_FRACTION",
    "TRIGGERS",
    "CaptureEngine",
    "StepSpikeDetector",
    "active",
    "clear",
    "configure",
    "engine",
    "fire",
    "list_captures",
    "observe_step_time",
    "step_cost_model",
    "tick",
]

#: The trigger registry:
#:
#: ``sentinel_regressed``   a Sentinel.observe verdict of ``regressed``
#: ``watchdog_near_miss``   a guarded phase finished past
#:                          NEAR_MISS_FRACTION of its deadline (but
#:                          under it — an overrun is hang_detected)
#: ``serve_slo_overrun``    a serving micro-batch blew the serve_request
#:                          SLO deadline (HangDetected on the worker)
#: ``step_time_spike``      a train-window step time above factor x the
#:                          trailing window's p99
TRIGGERS = ("sentinel_regressed", "watchdog_near_miss",
            "serve_slo_overrun", "step_time_spike")

#: Fraction of a watchdog deadline that counts as a near-miss.
NEAR_MISS_FRACTION = 0.8

CAPTURES_DIRNAME = "captures"
MANIFEST_FILE = "capture.json"


class StepSpikeDetector:
    """Trailing-window step-time spike detector.

    ``observe(ms)`` returns True when the value exceeds ``factor`` x
    the trailing window's p99 (computed over the last ``window``
    observations, after at least ``min_history`` of them — a cold
    window must not fire on the compile-adjacent early steps). Every
    observation — spikes included — enters the window, so a level
    shift becomes the new normal instead of firing forever (the rate
    limiter bounds the captures either way)."""

    def __init__(self, window: int = 64, factor: float = 3.0,
                 min_history: int = 8):
        self.window = int(window)
        self.factor = float(factor)
        self.min_history = max(int(min_history), 2)
        self._vals: collections.deque = collections.deque(
            maxlen=self.window)
        self.last_p99: float | None = None

    def observe(self, ms: float) -> bool:
        ms = float(ms)
        spike = False
        vals = self._vals
        if len(vals) >= self.min_history:
            ordered = sorted(vals)
            p99 = ordered[min(len(ordered) - 1,
                              int(0.99 * len(ordered)))]
            self.last_p99 = p99
            spike = ms > self.factor * p99
        vals.append(ms)
        return spike


class CaptureEngine:
    """The armed half: owns the rate limits and writes the bundles."""

    def __init__(self, root: str, run_id: str | None = None, *,
                 max_per_trigger: int = 2, min_interval_s: float = 30.0,
                 trace_s: float = 0.5, profile: bool = True,
                 spike_window: int = 64, spike_factor: float = 3.0,
                 spike_min_history: int = 8,
                 _monotonic=time.monotonic):
        self.root = os.path.abspath(str(root))
        self.run_id = run_id
        self.max_per_trigger = int(max_per_trigger)
        self.min_interval_s = float(min_interval_s)
        self.trace_s = float(trace_s)
        self.profile = bool(profile)
        self.spike_detector = StepSpikeDetector(
            window=spike_window, factor=spike_factor,
            min_history=spike_min_history)
        self._monotonic = _monotonic
        self._lock = threading.Lock()
        self._seq = {t: 0 for t in TRIGGERS}
        self._last_fire: dict[str, float] = {}
        self._session: _BoundedTrace | None = None
        self.captures: list[str] = []
        self.traces: list[dict] = []
        self.suppressed = 0

    # ------------------------------------------------------------- firing

    def fire(self, trigger: str, **context) -> str | None:
        """One capture attempt. Returns the bundle directory, or None
        when the trigger is rate-limited or the bundle could not be
        written (best-effort by the telemetry contract)."""
        if trigger not in TRIGGERS:
            raise ValueError(
                f"unknown introspection trigger {trigger!r} "
                f"(registry: {TRIGGERS})")
        now = self._monotonic()
        with self._lock:
            if self._seq[trigger] >= self.max_per_trigger:
                self.suppressed += 1
                self._count_suppressed(trigger, "max_per_trigger")
                return None
            last = self._last_fire.get(trigger)
            if last is not None and now - last < self.min_interval_s:
                self.suppressed += 1
                self._count_suppressed(trigger, "min_interval")
                return None
            self._seq[trigger] += 1
            seq = self._seq[trigger]
            self._last_fire[trigger] = now
        try:
            return self._capture(trigger, seq, context)
        except Exception:
            return None

    def _count_suppressed(self, trigger: str, reason: str) -> None:
        try:
            from fm_spark_tpu_torch import obs

            obs.counter("introspect.suppressed_total").add(1)
            obs.event("capture_suppressed", trigger=trigger,
                      reason=reason)
        except Exception:
            pass

    def _capture(self, trigger: str, seq: int, context: dict) -> str:
        from fm_spark_tpu_torch import obs

        bundle = os.path.join(self.root, CAPTURES_DIRNAME,
                              f"{trigger}_{seq:03d}")
        os.makedirs(bundle, exist_ok=True)
        # Metrics snapshot first (cheapest, most likely to matter), then
        # the flight window, then the bounded profiler arm — each
        # individually best-effort so a failed piece still leaves the
        # rest of the bundle.
        try:
            durable.atomic_write_json(
                os.path.join(bundle, "metrics.json"),
                obs.registry().snapshot(),
                path_class="obs", best_effort=True)
        except Exception:
            pass
        try:
            obs.flight_dump(f"capture:{trigger}",
                            path=os.path.join(bundle, "flight.json"))
        except Exception:
            pass
        profiler = self._arm_profiler(bundle)
        manifest = {
            "trigger": trigger, "seq": seq,
            "run_id": self.run_id,
            "ts": round(time.time(), 3),
            "context": context,
            "profiler": profiler,
            "files": sorted(os.listdir(bundle)),
        }
        if context.get("traces"):
            # Top-level pointer for report/tooling: the distributed
            # trace ids this bundle is the evidence for.
            manifest["trace_ids"] = list(context["traces"])
        # Manifest LAST and atomically: a bundle directory without a
        # parseable capture.json is a torn capture, and every reader
        # (obs_report/run_doctor) treats it as such. Routed through the
        # durable seam (obs class) so a disk schedule can tear it.
        durable.atomic_write_json(
            os.path.join(bundle, MANIFEST_FILE), manifest,
            path_class="obs", best_effort=True, default=str)
        with self._lock:
            self.captures.append(bundle)
        try:
            obs.counter("introspect.captures_total").add(1)
            obs.event("capture_fired", trigger=trigger, seq=seq,
                      bundle=bundle)
        except Exception:
            pass
        return bundle

    def _arm_profiler(self, bundle: str) -> dict:
        """Start a BOUNDED ``torch.profiler`` trace (CPU and, on a card,
        CUDA activity) into ``<bundle>/profile/``, stopped at the first
        step boundary past ``trace_s`` (:meth:`tick`). torch is looked
        up, never imported. A trace is begun only on the main thread,
        the one whose loop ticks and which shuts the plane down: PyTorch's
        profiler is stopped only on the thread that started it (a stop
        from another thread, even after the starting one ended, crashed
        the process on the CPU), so a fire from a worker thread (the
        serving batcher, the checkpoint writer, the prefetcher) records
        its skip. Nor is one begun while a CUDA graph capture is underway
        (a profiler switched on mid-capture would put its own calls into
        the captured stream's window) or beside another profiler session
        (``fmtorch train --profile``: PyTorch runs one at a time). A
        session that cannot start records its failure; none of these
        raises."""
        import sys

        if not self.profile:
            return {"status": "disabled"}
        torch = sys.modules.get("torch")
        if torch is None:
            return {"status": "skipped: torch not loaded"}
        if threading.current_thread() is not threading.main_thread():
            return {"status": "skipped: fired off the main thread"}
        graphs = sys.modules.get("fm_spark_tpu_torch.graphs")
        if graphs is not None and graphs.capture_underway():
            return {"status": "skipped: CUDA graph capture underway"}
        with self._lock:
            if self._session is not None:
                return {"status": "skipped: trace already active"}
            try:
                if torch.autograd._profiler_enabled():
                    return {"status": "skipped: another profiler session "
                                      "is active"}
            except Exception:
                pass
            trace_dir = os.path.join(bundle, "profile")
            try:
                os.makedirs(trace_dir, exist_ok=True)
                self._session = _BoundedTrace(torch, trace_dir,
                                              self.trace_s, self._monotonic)
            except Exception as e:
                self._session = None
                return {"status": f"failed: {type(e).__name__}: "
                                  f"{(str(e).splitlines() or [''])[0][:160]}"}
        return {"status": "armed", "trace_s": self.trace_s,
                "dir": trace_dir}

    def tick(self) -> None:
        """A step boundary: stop a bounded trace whose ``trace_s`` has
        passed, when called on the thread that began it (the main
        thread)."""
        s = self._session
        if s is not None and s.due():
            self.stop_trace()

    def stop_trace(self) -> None:
        """Stop and export the running bounded trace, if any and if
        called on the thread that began it (idempotent; never raises).
        The plane's shutdown calls it on the main thread, so a trace
        never outlives its run."""
        with self._lock:
            s = self._session
            if s is None or threading.current_thread() is not s.owner:
                return
            self._session = None
        s.stop()
        self.traces.append(s.status())


class _BoundedTrace:
    """One ``torch.profiler.profile`` session, writing a Chrome trace
    into ``trace_dir`` when stopped."""

    def __init__(self, torch, trace_dir: str, trace_s: float, monotonic):
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.trace_dir = trace_dir
        self._monotonic = monotonic
        self._deadline = monotonic() + float(trace_s)
        self.owner = threading.current_thread()
        self.result: str | None = None
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.start()

    def due(self) -> bool:
        return self._monotonic() >= self._deadline

    def stop(self) -> None:
        try:
            self._prof.stop()
            path = os.path.join(self.trace_dir, "trace.json")
            self._prof.export_chrome_trace(path)
            self.result = path
        except Exception as e:
            self.result = (f"failed: {type(e).__name__}: "
                           f"{(str(e).splitlines() or [''])[0][:160]}")

    def status(self) -> dict:
        return {"dir": self.trace_dir, "result": self.result}


# Module state, as in faults.py and watchdog.py: None = unconfigured (the
# one-check disabled path).
_engine: CaptureEngine | None = None


def configure(root: str, run_id: str | None = None,
              **kw) -> CaptureEngine:
    """Arm the capture engine over a run directory (the obs run dir is
    the convention: bundles land under ``<root>/captures/``)."""
    global _engine
    _engine = CaptureEngine(root, run_id=run_id, **kw)
    return _engine


def clear() -> None:
    """Disarm the engine, stopping a bounded trace it still runs."""
    global _engine
    eng, _engine = _engine, None
    if eng is not None:
        eng.stop_trace()


def tick() -> None:
    """The step-boundary hook of the training and serving loops: stops a
    bounded trace past its ``trace_s``. One None check when unarmed."""
    eng = _engine
    if eng is not None and eng._session is not None:
        try:
            eng.tick()
        except Exception:
            pass


def active() -> bool:
    return _engine is not None


def engine() -> CaptureEngine | None:
    return _engine


def fire(trigger: str, **context) -> str | None:
    """The production hook: one module-global None check when disabled;
    armed, a rate-limited capture attempt that can never raise into the
    hot path that fired it."""
    eng = _engine
    if eng is None:
        return None
    try:
        return eng.fire(trigger, **context)
    except Exception:
        return None


def observe_step_time(ms: float) -> str | None:
    """Feed one step-time observation (a train log-window mean) to the
    spike detector; a spike past the trailing p99 fires the
    ``step_time_spike`` capture. No-op (one check) when disabled."""
    eng = _engine
    if eng is None:
        return None
    try:
        if eng.spike_detector.observe(ms):
            return eng.fire(
                "step_time_spike", step_ms=round(float(ms), 3),
                trailing_p99_ms=round(eng.spike_detector.last_p99 or 0.0,
                                      3),
                factor=eng.spike_detector.factor)
    except Exception:
        pass
    return None


def list_captures(obs_dir: str) -> list[dict]:
    """Parse every VALID capture bundle under ``obs_dir/captures/``
    (manifest parses), oldest-first by (trigger, seq). Torn bundles —
    a crash between mkdir and the atomic manifest write — are skipped,
    never fatal."""
    root = os.path.join(obs_dir, CAPTURES_DIRNAME)
    out = []
    try:
        names = sorted(os.listdir(root))
    except OSError:
        return out
    for name in names:
        bundle = os.path.join(root, name)
        try:
            with open(os.path.join(bundle, MANIFEST_FILE)) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            continue
        if isinstance(manifest, dict):
            manifest["dir"] = bundle
            out.append(manifest)
    out.sort(key=lambda m: (str(m.get("trigger")),
                            int(m.get("seq") or 0)))
    return out


# ------------------------------------------------------ cost attribution

#: Default field counts of the models (the reference's):
#: Criteo rows carry 39 fields, Avazu 23.
_MODEL_FIELDS = {"fm": 39, "fm_kaggle": 39, "deepfm": 39, "ffm": 23}


def step_cost_model(model: str, batch: int, rank: int, *,
                    fields: int | None = None, cap: int = 0,
                    param_bytes: int = 4,
                    compute_bytes: int = 4) -> dict:
    """Bytes-moved model for ONE train step of a bench model.

    The per-family traffic terms are the reference's
    (``fm_spark_tpu/obs/introspect.py``), composed into a whole-step
    estimate:

    - ``gather``   — read B x F embedding rows of width w=rank+1 at the
      storage dtype, plus the id stream;
    - ``interact`` — the [B, F, k] activation build + score reduction +
      backward re-read in the compute dtype (FFM's field-aware
      interaction materializes the [B, F, F·k] sel set instead — its
      dominant term);
    - ``update``   — the fp32 read-modify-write of the touched rows:
      B x F lanes on the scatter path, or F x cap lanes when a compact
      capacity bounds the write set;
    - ``segsum``   — the compact path's per-field segment totals (the
      sorted-delta stream + the [cap, w] accumulator), zero without a
      cap.

    This is a MODEL, not a measurement: it states the traffic the
    step's design intends at this shape, so pairing it with a measured
    step time yields a model-implied bandwidth the autotuner can rank
    levers by (a leg far below the attachment's streaming bandwidth has
    a dispatch or overlap problem, not a traffic problem). DeepFM's dense
    MLP head is deliberately excluded (compute-bound, not an HBM term);
    the assumption is recorded in the result.
    """
    B = int(batch)
    k = int(rank)
    w = k + 1
    F = int(fields) if fields is not None else _MODEL_FIELDS.get(model,
                                                                 39)
    cap = int(cap or 0)
    fam = {}
    fam["gather"] = B * F * w * param_bytes + B * F * 4
    if model == "ffm":
        # The field-aware sel/dsel set is the FFM step's dominant
        # traffic: forward build + backward re-read of [B, F, F·k].
        fam["interact"] = 2 * B * F * F * k * compute_bytes
    else:
        fam["interact"] = 3 * B * F * k * compute_bytes
    if cap > 0:
        lanes = min(cap, B)
        fam["update"] = F * 2 * lanes * w * 4
        fam["segsum"] = F * (B * w + B + lanes * w) * 4
    else:
        fam["update"] = 2 * B * F * w * 4 + B * F * 4
        fam["segsum"] = 0
    total = int(sum(fam.values()))
    return {
        "families": {n: int(v) for n, v in fam.items()},
        "bytes_total": total,
        "assumptions": {
            "model": model, "batch": B, "rank": k, "fields": F,
            "cap": cap, "param_bytes": param_bytes,
            "compute_bytes": compute_bytes,
            "excluded": "deepfm dense head (compute-bound)",
        },
    }
