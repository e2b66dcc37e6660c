"""The port's segment totals (``fm_spark_tpu_torch.ops.segsum``) against
the JAX package's Pallas kernel ``pallas_segsum.segment_totals`` run in
interpret mode.

On CPU tensors ``segment_totals`` runs its plain version; the CUDA kernel
is held against that version on the card (``test_torch_package.py``,
``chip_smoke.py``). Inputs keep the reference's contract: non-decreasing
DENSE ranks, and deltas at the scale of the step's ``-lr·g``. Tolerance
``rtol=1e-5, atol=1e-6``: both sum float32 in different orders (the
Pallas kernel as one-hot matmuls per 512-lane tile), so a run of ~1000
lanes differs by a few 1e-7.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu.ops import pallas_segsum
from fm_spark_tpu_torch.ops import KernelUnavailable, segsum

RTOL, ATOL = 1e-5, 1e-6


def _case(b, runs, seed=0, w=9):
    """Sorted dense ranks: the given run lengths first (long runs span
    several 512-lane tiles), then random short runs up to ``b`` lanes."""
    rng = np.random.default_rng(seed)
    lengths = list(runs)
    while sum(lengths) < b:
        lengths.append(int(rng.integers(1, 6)))
    seg = np.repeat(np.arange(len(lengths)), lengths)[:b].astype(np.int32)
    # Deltas at the scale of the step's -lr·g (lr 0.05).
    x = (rng.normal(size=(b, w)) * 0.05).astype(np.float32)
    return x, seg


@pytest.mark.parametrize("b,runs,cap_less", [
    (700, [], 0),                 # B not a multiple of 512
    (1800, [1200], 0),            # one segment over three tiles
    (2000, [3, 900, 600], 5),     # ranks >= cap drop to the trash row
    (511, [511], 0),
    (1, [], 0),
])
def test_plain_matches_the_pallas_kernel(b, runs, cap_less):
    x, seg = _case(b, runs, seed=b)
    cap = int(seg.max()) + 1 - cap_less
    want = np.asarray(pallas_segsum.segment_totals(
        jnp.asarray(x), jnp.asarray(seg), cap, interpret=True))
    got = segsum.segment_totals(torch.from_numpy(x), torch.from_numpy(seg), cap)
    assert got.shape == (cap, x.shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)


def test_spare_capacity_stays_zero():
    x, seg = _case(300, [50])
    cap = int(seg.max()) + 20
    got = segsum.segment_totals_plain(torch.from_numpy(x),
                                      torch.from_numpy(seg), cap)
    assert not got[int(seg.max()) + 1:].any()
    exact = segsum.segment_totals_plain(torch.from_numpy(x).double(),
                                        torch.from_numpy(seg), cap)
    assert exact.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=RTOL, atol=ATOL)


def test_bad_inputs_raise_and_other_devices_are_refused():
    x = torch.zeros(4, 3)
    seg = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        segsum.segment_totals(x.double(), seg, 2)
    with pytest.raises(TypeError):
        segsum.segment_totals(x, seg.long(), 2)
    with pytest.raises(ValueError):
        segsum.segment_totals(x, seg[:3], 2)
    with pytest.raises(ValueError):
        segsum.segment_totals(x, seg, 0)
    # A tensor off the CPU takes the kernel or is refused; meta tensors
    # stand in for one here.
    with pytest.raises(KernelUnavailable):
        segsum.segment_totals(x.to("meta"), seg.to("meta"), 2)
