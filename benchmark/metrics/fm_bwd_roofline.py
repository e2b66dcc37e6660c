"""Kernel B's share of its roofline (``roofline/fm_bwd.py``)."""

from benchmark.metrics import _kernel_share


def read(ctx):
    return _kernel_share.share(ctx, ["fm_bwd"])
