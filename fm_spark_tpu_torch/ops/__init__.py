"""Compute ops: the FM forward math and the hand-written CUDA kernels'
wrappers (each beside its plain PyTorch version)."""


class KernelUnavailable(ValueError):
    """A CUDA kernel cannot serve this (device, shape, dtype, layout)
    request — the counterpart of ``fm_spark_tpu.ops.PallasUnavailable``.

    Raised instead of running some other path: a CUDA tensor either goes
    through its kernel or is refused with the reason. Subclasses
    ``ValueError`` like its counterpart.
    """


#: The launch counter of every kernel wrapper: (wrapper, module, counter).
KERNEL_COUNTERS = (
    ("fm_fused_scores", "fused_fwd", "launches"),
    ("segment_totals", "segsum", "launches"),
    ("fm_bwd_segment_totals", "fused_bwd", "launches"),
    ("ffm_sel_scores", "ffm_sel", "scores_launches"),
    ("ffm_sel_bwd", "ffm_sel", "bwd_launches"),
    ("gather_rows", "rows", "gather_launches"),
    ("update_rows_add", "rows", "update_launches"),
    ("sr_bits", "srbits", "launches"),
)


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count, by the wrapper's name. A
    wrapper counts the launches it makes; the replays of a CUDA graph
    launch the kernels it recorded past the wrappers, uncounted."""
    import importlib

    return {name: getattr(importlib.import_module(f"{__name__}.{mod}"), attr)
            for name, mod, attr in KERNEL_COUNTERS}
