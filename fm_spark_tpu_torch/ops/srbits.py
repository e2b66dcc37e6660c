"""The SR noise bits of a bf16 ``dedup_sr`` write: JAX's threefry key
schedule, as a CUDA kernel's wrapper and its plain PyTorch version.

The JAX steps draw ``jax.random.bits(sr_key(key(seed), step, field),
shape, uint32) & 0xFFFF`` (``fm_spark_tpu/ops/scatter.py:44-67``) with
the threefry-2x32 PRNG in its partitionable counter layout. Both versions
here give those bits exactly: the kernel (``csrc/sr_bits.cu``) on the
card, the plain version with 32-bit arithmetic on int64 tensors (threefry
has adds, rotations and xors only, so int64 ops masked to 32 bits are
exact). ``step`` may be a Python int or a 0-dim integer tensor on the
output's device; the kernel reads it from device memory, so a captured
step draws each replay's own bits. No TPU kernel has this job.
"""

from __future__ import annotations

import threading

import torch

from fm_spark_tpu_torch.ops import KernelUnavailable, note_recorded

__all__ = ["launches", "sr_bits", "sr_bits_plain", "threefry2x32"]

#: Kernel launches made by :func:`sr_bits` in this process.
#: A call that a CUDA graph records is no launch: the graph's replays
#: launch the kernel, past the wrapper.
launches = 0
_launch_lock = threading.Lock()

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0, k1, x0, x1):
    """The 20-round threefry-2x32 hash of ``(x0, x1)`` under the key
    ``(k0, k1)`` (``jax._src.prng._threefry2x32_lowering``). Every operand
    is a Python int or an int64 tensor holding 32-bit words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


def sr_bits_plain(seed: int, step, field: int, shape,
                  device="cpu") -> torch.Tensor:
    """Plain PyTorch version of :func:`sr_bits`."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.int64) & _M32
    else:
        step = int(step) & _M32
    # key(seed) = (0, seed); fold_in(k, d) = threefry2x32(k, (0, d)).
    k0, k1 = threefry2x32(0, int(seed) & _M32, 0, step)
    k0, k1 = threefry2x32(k0, k1, 0, int(field) & _M32)
    e = torch.arange(_numel(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(k0, k1, e >> 32, e & _M32)
    return ((b0 ^ b1) & 0xFFFF).to(torch.int32).reshape(tuple(shape))


def sr_bits(seed: int, step, field: int, shape, device) -> torch.Tensor:
    """``jax.random.bits(fold_in(fold_in(key(seed), step), field), shape,
    uint32) & 0xFFFF`` as int32 values in ``[0, 65536)`` on ``device``.

    ``seed`` is the schedule's seed (``TrainConfig.seed + 0x5EED``), a
    32-bit word as JAX's key takes it; ``step`` a Python int or a 0-dim
    integer tensor on ``device``. On the CPU the plain version runs; on a
    CUDA device the kernel, or an error.
    """
    device = torch.device(device)
    if device.type == "cpu":
        return sr_bits_plain(seed, step, field, shape, device)
    if device.type != "cuda":
        raise KernelUnavailable(f"sr_bits: no kernel for {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if isinstance(step, torch.Tensor):
        if step.dim() != 0 or step.device != device:
            raise ValueError(f"sr_bits: step must be a 0-dim tensor on "
                             f"{device}, got {tuple(step.shape)} on "
                             f"{step.device}")
        if step.dtype != torch.int32:
            step = step.to(torch.int32)
    else:
        step = torch.full((), int(step), dtype=torch.int32, device=device)
    from fm_spark_tpu_torch.kernels import build

    lib = build.load("sr_bits")
    out = torch.empty(tuple(shape), dtype=torch.int32, device=device)
    n = out.numel()
    if n == 0:
        return out
    err = lib.sr_bits(step.data_ptr(), int(seed) & _M32, int(field) & _M32, n,
                      out.data_ptr(),
                      torch.cuda.current_stream(device).cuda_stream,
                      device.index)
    if err:
        raise RuntimeError(f"sr_bits launch failed: CUDA error {err} "
                           f"({lib.sr_cuda_error_string(err).decode()})")
    global launches
    if torch.cuda.is_current_stream_capturing():
        note_recorded("sr_bits")
    else:
        with _launch_lock:
            launches += 1
    return out
