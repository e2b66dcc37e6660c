"""Reductions of a ``torch.profiler`` trace of the profiled span: the
device's busy time (the union of its records), each kernel call's device
time by symbol, the breakdown of device time and idle gaps, and the
records the trace lost against the runs the captured graph recorded."""

from __future__ import annotations

import collections

#: Each kernel wrapper of the program (its launch counter's name) and
#: the one kernel symbol that runs once per launch of it.
WRAPPER_SYMBOLS = {
    "fm_fused_scores": ("fm_fused_fwd_kernel", "fm_fused_fwd_warp_kernel"),
    "segment_totals": ("first_pass",),
    "fm_bwd_segment_totals": ("bwd_first_pass",),
    "ffm_sel_scores": ("ffm_fwd_kernel",),
    "ffm_sel_bwd": ("ffm_bwd_kernel",),
    "gather_rows": ("gather_elems",),
    "update_rows_add": ("update_elems",),
    "sr_bits": ("sr_bits_kernel",),
}
TOP = 10
NAME_CHARS = 120


class Span:
    """The device and host records of one profiled span, times in
    microseconds on the profiler's clock, and the span's wall seconds on
    the host's clock (from one synchronised loss line to another)."""

    def __init__(self, events, window_s: float):
        from torch.autograd import DeviceType

        self.window_s = window_s
        self.device = sorted(
            (e.time_range.start, e.time_range.end, e.name)
            for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep"))
        self.host = [(e.time_range.start, e.time_range.end, e.name, e.thread)
                     for e in events if e.device_type == DeviceType.CPU
                     and not e.name.startswith("ProfilerStep")]
        launches = collections.Counter(
            t for _, _, n, t in self.host if n.startswith("cudaGraphLaunch"))
        self.main_thread = launches.most_common(1)[0][0] if launches else None
        self.graph_launches = sum(launches.values())

    def busy_intervals(self) -> list[tuple[float, float]]:
        merged = []
        for lo, hi, _ in self.device:
            if merged and lo <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], hi)
            else:
                merged.append([lo, hi])
        return [(lo, hi) for lo, hi in merged]

    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e6

    def calls(self, symbols, first: str) -> list[float]:
        """Device seconds of each call of one kernel: a record of
        ``first`` opens a call, and the records of ``symbols`` that follow
        it with no other kernel between belong to it (copies and sets,
        which may run on the prefetcher's stream meanwhile, are passed
        over)."""
        out, cur = [], None
        for lo, hi, name in self.device:
            if name.startswith(("Memcpy", "Memset")):
                continue
            if first in name:
                if cur is not None:
                    out.append(cur)
                cur = (hi - lo) / 1e6
            elif cur is not None and any(s in name for s in symbols):
                cur += (hi - lo) / 1e6
            elif cur is not None:
                out.append(cur)
                cur = None
        if cur is not None:
            out.append(cur)
        return out

    def breakdown(self) -> dict:
        """The device operations that took most time, by name, and the
        longest idle gaps by what the main thread was doing (its
        innermost operation at the gap's middle)."""
        ops = collections.Counter()
        for lo, hi, name in self.device:
            ops[name[:NAME_CHARS]] += (hi - lo) / 1e6
        main = [(lo, hi, n) for lo, hi, n, t in self.host
                if t == self.main_thread]
        gaps = collections.Counter()
        busy = self.busy_intervals()
        for (_, a), (b, _) in zip(busy, busy[1:]):
            mid = (a + b) / 2
            around = [(hi - lo, n) for lo, hi, n in main if lo <= mid <= hi]
            label = min(around)[1] if around else "host python (no op)"
            gaps[label[:NAME_CHARS]] += (b - a) / 1e6
        return {"device_ops": [[k, v] for k, v in ops.most_common(TOP)],
                "idle_gaps": [[k, v] for k, v in gaps.most_common(TOP)]}

    def record_loss(self, per_replay: dict) -> dict:
        """Per kernel wrapper that runs in the graph: the runs the trace
        holds against the graph launches times the runs per replay (the
        wrapper's launches in the capture's warm-up)."""
        seen = collections.Counter()
        for _, _, name in self.device:
            found = [(len(s), w) for w, syms in WRAPPER_SYMBOLS.items()
                     for s in syms if s in name]
            if found:
                seen[max(found)[1]] += 1
        return {w: {"seen": seen[w], "expected": n * self.graph_launches}
                for w, n in per_replay.items() if n}
