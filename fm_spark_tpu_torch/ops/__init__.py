"""Compute ops: the FM forward math and the hand-written CUDA kernels'
wrappers (each beside its plain PyTorch version)."""


class KernelUnavailable(ValueError):
    """A CUDA kernel cannot serve this (device, shape, dtype, layout)
    request — the counterpart of ``fm_spark_tpu.ops.PallasUnavailable``.

    Raised instead of running some other path: a CUDA tensor either goes
    through its kernel or is refused with the reason. Subclasses
    ``ValueError`` like its counterpart.
    """
