"""Drives ``fm_spark_tpu_torch.train.fit_field_sparse``, the loop that
``fmtorch train`` runs for a field config, as a user's loop runs it:
numpy batches in host memory, the program's ``Prefetcher`` (two batches
deep), and the captured step replayed back to back, one step a call.

One call trains one set of tables from the seed. Its first three steps
(set-up) are the ones the reference follows: the harness's guard, which
the loop polls between calls, takes the per-leaf norms of the tables'
change after steps 1 and 3 (and a seeded projection of the change after
3). The window opens at the first loss line at
or after the mix's ``warmup_steps`` (each loss line fetches the loss,
which synchronises) and closes when ``fit_field_sparse`` returns, which
synchronises too; the guard turns ``should_stop`` true once ``seconds``
have passed since the window opened. With ``trace`` the harness's logger starts
``torch.profiler`` one loss line after the opening, keeps one line's
steps as warm-up, and records the next line's steps.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmark import compare, traffic
from benchmark.reference import common

#: The loop's step budget: the guard, not the count, ends a run.
NO_END = 10 ** 12
#: One step a call, so the guard's polls, which come once a call, count
#: steps; and the prefetcher's depth, as a user's loop runs it.
STEPS_PER_CALL = 1
PREFETCH = 2
#: The guard's polls at which the tables' change is read (steps done).
CHANGE_READS = (1, 3)
REF_STEPS = 3


def build(cell: dict, seed: int):
    """The program's spec and ``TrainConfig`` for the cell."""
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.train import TrainConfig

    cfg, mix = cell["config"], cell["traffic"]
    cls = {"field_fm": models.FieldFMSpec,
           "field_ffm": models.FieldFFMSpec}[cfg["family"]]
    spec = cls(num_features=cfg["num_fields"] * cfg["bucket"],
               rank=cfg["rank"], num_fields=cfg["num_fields"],
               bucket=cfg["bucket"], task=cfg["task"], loss=cfg["loss"],
               init_std=cfg["init_std"], param_dtype=cfg["param_dtype"],
               compute_dtype=cfg["compute_dtype"])
    tconf = TrainConfig(
        num_steps=NO_END, batch_size=mix["batch"],
        learning_rate=cfg["learning_rate"], lr_schedule=cfg["lr_schedule"],
        optimizer=cfg["optimizer"], reg_bias=cfg["reg_bias"],
        reg_linear=cfg["reg_linear"], reg_factors=cfg["reg_factors"],
        seed=seed, log_every=mix["log_every"],
        sparse_update=cfg["sparse_update"], use_pallas=cfg["use_pallas"],
        compact_cap=mix.get("compact_cap", 0),
        compact_device=cfg["compact_device"],
        compact_overflow=cfg["compact_overflow"],
        sel_blocked=cfg["sel_blocked"], fused_embed=cfg["fused_embed"])
    return spec, tconf


def shape(cell: dict, unique) -> dict:
    """The roofline shape dict: the cell's sizes and the pool's mean
    distinct ids per field."""
    cfg = cell["config"]
    width = cfg["rank"] * (cfg["num_fields"] if cfg["family"] == "field_ffm"
                           else 1) + 1
    size = {"float32": 4, "bfloat16": 2}
    return {"batch": cell["traffic"]["batch"], "fields": cfg["num_fields"],
            "rank": cfg["rank"], "width": width,
            "store_bytes": size[cfg["param_dtype"]],
            "compute_bytes": size[cfg["compute_dtype"]],
            "unique": [float(u) for u in unique.mean(0)]}


class Window:
    """The harness's logger (``log``, called at each loss line, after its
    fetch) and preemption guard (``should_stop``, polled before each
    call). ``seconds=None``: no window; the guard stops the loop once the
    last change is read."""

    def __init__(self, mix: dict, seconds, trace: bool, read):
        self.warmup = mix["warmup_steps"]
        self.seconds = seconds
        self.trace = trace
        self._read = read
        self.polls = 0
        self.deadline = None
        self.open_step = self.t_open = None
        self.lines = 0
        self.prof = None
        self.profiled = (0, 0)
        self.span_s = None
        self.events = None

    @property
    def should_stop(self) -> bool:
        k = self.polls
        self.polls += 1
        if k in CHANGE_READS:
            self._read(k)
            if self.seconds is None and k == CHANGE_READS[-1]:
                return True
        if self.prof is not None and self.span_s is None:
            return False                  # a span begun is seen to its end
        return (self.deadline is not None
                and time.perf_counter() >= self.deadline)

    def log(self, step: int, samples=None, **values) -> None:
        t = time.perf_counter()
        if "loss" not in values or self.seconds is None:
            return
        if self.open_step is None:
            if step >= self.warmup:
                self.open_step, self.t_open = step, t
                self.deadline = t + self.seconds
            return
        self.lines += 1
        if not self.trace:
            return
        if self.lines == 1:
            from torch.profiler import ProfilerActivity, profile, schedule

            self.prof = profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                on_trace_ready=self._keep)
            self.prof.start()
            self._from = step
        elif self.lines == 2:
            self.prof.step()                      # warm-up → recording
            self._t0 = t
        elif self.lines == 3:
            self.prof.step()                      # recording → done
            self.span_s = t - self._t0
            self.profiled = (self._from, step)

    def _keep(self, prof) -> None:
        self.events = prof.events()


def _warm_profiler() -> None:
    """Start and stop the profiler once in set-up: its first start loads
    and initialises the tracer, which takes seconds."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass


def _leaves(params: dict) -> list:
    return [params["w0"], *params["vw"]]


def train(cell: dict, seed: int, seconds, trace: bool, device) -> dict:
    """One ``fit_field_sparse`` call over the cell's pool; returns what
    the run read: the window, the stats, the program's readings of its
    first three steps, the pool's distinct counts and the span."""
    from fm_spark_tpu_torch import obs
    from fm_spark_tpu_torch.ops import kernel_launches
    from fm_spark_tpu_torch.train import fit_field_sparse

    if obs.enabled():
        raise RuntimeError("the obs plane must be off in a benchmark run")
    stamps = {"imported": time.perf_counter()}
    cfg, mix = cell["config"], cell["traffic"]
    spec, tconf = build(cell, seed)
    pool, unique = traffic.make_pool(mix, cfg["num_fields"], cfg["bucket"],
                                     seed, device)
    stamps["pool"] = time.perf_counter()
    made, norms, peaks = {}, {}, []
    init = spec.init

    def init_and_keep(*a, **k):
        made["params"] = init(*a, **k)
        return made["params"]

    # The guard reads the tables the loop trains: the spec hands them over
    # as it makes them.
    object.__setattr__(spec, "init", init_and_keep)

    def read(k):
        """The per-leaf norms of the change after ``k`` steps, against the
        tables as ``spec.init`` makes them from the seed again; the card's
        peak before this work is kept and the peak reset after it, so the
        harness's own memory never counts."""
        t0 = time.perf_counter()
        if device.type == "cuda":
            peaks.append(torch.cuda.max_memory_allocated(device))
        p0 = _leaves(init(torch.Generator(device=device).manual_seed(seed),
                          device=device))
        now = _leaves(made["params"])
        norms[k] = torch.stack([(a.double() - b.double()).norm()
                                for a, b in zip(now, p0)]).tolist()
        if k == CHANGE_READS[-1]:
            norms["proj"] = common.projections(now, p0, seed)
        del p0, now
        if device.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
        stamps["change_read_s"] = (stamps.get("change_read_s", 0.0)
                                   + time.perf_counter() - t0)

    window = Window(mix, seconds, trace, read)
    if trace:
        _warm_profiler()
    stats = {}
    before = kernel_launches()
    fit_field_sparse(spec, tconf, traffic.Cycle(pool), device=device,
                     steps_per_call=STEPS_PER_CALL, prefetch=PREFETCH,
                     logger=window, stats=stats,
                     preemption_guard=window)
    t_close = time.perf_counter()
    per_replay = {k: v - before[k] for k, v in kernel_launches().items()}
    if device.type == "cuda":
        peaks.append(torch.cuda.max_memory_allocated(device))
    span = None
    if window.span_s is not None:
        from benchmark.trace import Span

        span = Span(window.events, window.span_s)
    made.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    lr = cfg["learning_rate"]
    return {"stats": stats, "window": window, "t_close": t_close,
            "stamps": stamps,
            "pool": pool, "unique": unique, "span": span,
            "peak": max(peaks, default=0), "per_replay": per_replay,
            "program": {"loss": stats["loss"][:REF_STEPS],
                        "grad": [n / lr for n in norms[1]],
                        "change": norms[3], "change_proj": norms["proj"]}}


def reference(cell: dict, seed: int, pool, device, lower=None) -> dict:
    """The family's plain reference over the pool's first three batches."""
    import importlib

    cfg = cell["config"]
    fam = importlib.import_module(f"benchmark.reference.{cfg['family']}")
    return common.follow(fam.step, cfg, seed, pool[:REF_STEPS],
                         steps=REF_STEPS, lower=lower, device=device)


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, limits: dict) -> dict:
    """A timed run: the result's fields (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ``breakdown``, ``checks``) and
    the lines printed before it."""
    from benchmark import metrics

    got = train(cell, seed, seconds, trace, device)
    w, stats = got["window"], got["stats"]
    if w.open_step is None:
        raise RuntimeError(
            f"the window never opened: the loop stopped at step "
            f"{stats['end']} before warm-up step {w.warmup}")
    steps = stats["end"] - w.open_step
    st = got["stamps"]
    setup = {"import_s": st["imported"] - t_start,
             "pool_s": st["pool"] - st["imported"],
             "capture_s": sum(stats["capture_s"]),
             "change_read_s": st["change_read_s"],
             "fit_to_open_s": w.t_open - st["pool"]}
    losses = stats["loss"][w.open_step:stats["end"]]
    out = {"attempted": steps,
           "failed": sum(not math.isfinite(x) for x in losses),
           "metrics": {}, "early": [{"setup_phases": setup}]}
    mix = cell["traffic"]
    if not trace:
        out["metrics"] = {
            "train_samples_per_s": {
                "value": steps * mix["batch"] / (got["t_close"] - w.t_open),
                "unit": "samples/s"},
            "setup_s": {"value": w.t_open - t_start, "unit": "s"}}
    else:
        ctx = {"stats": stats, "span": got["span"],
               "window": {"open_step": w.open_step, "end": stats["end"],
                          "profiled": w.profiled},
               "shape": shape(cell, got["unique"]),
               "config": cell["config"], "traffic": mix}
        for m in cell["per_layer"]:
            v = metrics.load(m["name"]).read(ctx)
            if v is not None:
                out["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        span = got["span"]
        if span is not None:
            out["busy_s"], out["window_s"] = span.busy_s(), span.window_s
            out["breakdown"] = span.breakdown()
            out["early"].append({"trace_records":
                                 span.record_loss(got["per_replay"])})
    out["peak"] = got["peak"]
    ref = reference(cell, seed, got["pool"], device)
    found = compare.gaps(got["program"], ref)
    out["correct"], out["checks"] = compare.judge(found, limits)
    out["correct"] = out["correct"] and out["failed"] == 0
    return out


def readings(cell: dict, seed: int, device, lower=None):
    """The compared numbers of one seed with no window, and both
    sides' per-step and per-leaf readings: the program trained through its
    first three steps (or, with ``lower``, the reference in that precision
    in its place) against the reference."""
    if lower is None:
        got = train(cell, seed, None, False, device)
        prog, pool = got["program"], got["pool"]
    else:
        pool, _ = traffic.make_pool(cell["traffic"],
                                    cell["config"]["num_fields"],
                                    cell["config"]["bucket"], seed, device)
        prog = reference(cell, seed, pool, device, lower=lower)
    ref = reference(cell, seed, pool, device)
    return compare.gaps(prog, ref), {"program": prog, "reference": ref}
