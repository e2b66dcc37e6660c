"""Mean device milliseconds of a window's step (``train.fit_steps``'
CUDA events around each call), over the window's calls outside the
profiled span: their sum over their count."""


def read(ctx):
    w = ctx["window"]
    lo, hi = w["profiled"]
    ms = [m for i, m in enumerate(ctx["stats"]["step_ms"])
          if w["open_step"] <= i < w["end"] and not lo <= i < hi]
    return sum(ms) / len(ms) if ms else None
