"""Share of the profiled span's wall time in which nothing ran on the
card (the union of its kernel, copy and set records)."""


def read(ctx):
    span = ctx["span"]
    if span is None or not span.device or span.window_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - span.busy_s() / span.window_s)
