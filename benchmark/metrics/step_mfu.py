"""The whole step's share of the card's peak: the larger of its
necessary bytes over the memory's rate and its operations over the
compute dtype's peak (``roofline/step_<family>.py``), over the mean
device time of a step (``step_device_ms``)."""

from benchmark import peaks, roofline
from benchmark.metrics import step_device_ms


def read(ctx):
    ms = step_device_ms.read(ctx)
    if not ms:
        return None
    flops, nbytes = roofline.load(
        f"step_{ctx['config']['family']}").count(ctx["shape"])
    bound = peaks.bound_s(nbytes, flops, ctx["config"]["compute_dtype"])
    return 100.0 * bound * 1e3 / ms
