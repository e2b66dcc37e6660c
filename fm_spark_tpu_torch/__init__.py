"""PyTorch/CUDA port of fm_spark_tpu, the serving slice.

The JAX package ``fm_spark_tpu`` is the reference; this package keeps its
module names (``models.field_fm``, ``serve.engine``, ``ops.fm``...) so a
reader finds each counterpart, and uses PyTorch idiom inside: plain
functions on tensors, ``torch.Generator`` for random init, and dict
parameters. It imports ``torch`` and never ``jax`` or ``fm_spark_tpu``.

Every entry point runs on the CUDA device unless the caller asks for the
CPU (``device="cpu"``), and :func:`resolve_device` raises rather than
silently picking the CPU when no device is asked for and none is present.
"""

from __future__ import annotations

import torch

__all__ = ["DeviceUnavailable", "resolve_device"]


class DeviceUnavailable(RuntimeError):
    """A CUDA device was needed (asked for, or implied by no choice at
    all) and this process has none."""


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the current CUDA device; with no CUDA present that is
    an error, never a silent move to the CPU — pass ``device="cpu"`` to
    run the plain PyTorch versions of the kernels on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise DeviceUnavailable(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        return torch.device("cuda", torch.cuda.current_device())
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (want 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise DeviceUnavailable(f"device {dev} requested but CUDA is absent")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
