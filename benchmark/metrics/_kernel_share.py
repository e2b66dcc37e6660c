"""A kernel's share of its roofline: the sum of its parts' bounds over
the sum of their mean device seconds per call in the profiled span."""

from benchmark import peaks, roofline


def share(ctx, kernels: list[str]):
    span = ctx["span"]
    if span is None:
        return None
    bound = took = 0.0
    for name in kernels:
        mod = roofline.load(name)
        calls = span.calls(mod.SYMBOLS, mod.FIRST)
        if not calls:
            return None
        flops, nbytes = mod.count(ctx["shape"])
        bound += peaks.bound_s(nbytes, flops, ctx["config"]["compute_dtype"])
        took += sum(calls) / len(calls)
    return 100.0 * bound / took
