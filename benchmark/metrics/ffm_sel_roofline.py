"""The two ``ffm_sel`` kernels' share of their rooflines: the sum of
their bounds over the sum of their device times per call."""

from benchmark.metrics import _kernel_share


def read(ctx):
    return _kernel_share.share(ctx, ["ffm_sel_scores", "ffm_sel_bwd"])
