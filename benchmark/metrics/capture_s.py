"""Seconds the step's CUDA graph captures took (``graphs.CapturedStep``:
the warm-up call and the capture), summed."""


def read(ctx):
    caps = ctx["stats"].get("capture_s") or []
    return float(sum(caps)) if caps else None
