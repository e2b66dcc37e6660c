"""The port's SR noise bits (``fm_spark_tpu_torch.ops.srbits``) against
JAX's key schedule: ``jax.random.bits(sr_key(key(seed), step, field),
shape, uint32) & 0xFFFF`` (threefry-2x32, partitionable counters), held
bit for bit. On the CPU the wrapper runs the plain version; the kernel
is held against it on the card (``tests/test_torch_package.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu.ops import scatter as jscatter
from fm_spark_tpu_torch.ops import KernelUnavailable, scatter, srbits


def _jax_bits(seed, step, field, shape):
    key = jscatter.sr_key(jax.random.key(seed), step, field)
    bits = jax.random.bits(key, shape, jnp.uint32) & jnp.uint32(0xFFFF)
    return np.asarray(bits).astype(np.int32)


def test_jax_runs_the_partitionable_counter_layout():
    # The layout the port reproduces: element e hashes (e >> 32, e & M).
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0x5EED, 2**31 - 1, -7])
@pytest.mark.parametrize("step,field", [(0, 0), (1, 38), (266, 5),
                                        (10**7, 22)])
@pytest.mark.parametrize("shape", [(1,), (7, 4), (96, 9), (300, 250)])
def test_plain_bits_equal_jax(seed, step, field, shape):
    # (300, 250) is 75,000 elements: past 2^16, so the counter's upper
    # half-word takes part in the hash.
    want = _jax_bits(seed, step, field, shape)
    got = srbits.sr_bits(seed, step, field, shape, "cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("step", [0, 5, 123456])
def test_a_step_tensor_gives_the_bits_of_its_value(step):
    t = torch.tensor(step, dtype=torch.int32)
    np.testing.assert_array_equal(
        srbits.sr_bits_plain(0x5EED, t, 3, (33, 17)).numpy(),
        _jax_bits(0x5EED, step, 3, (33, 17)))


def test_threefry_hash_of_the_reference_vector():
    # Threefry-2x32's published known-answer vectors (Salmon et al.,
    # Random123 kat_vectors, 20 rounds; the third is the one JAX's own
    # tests pin), as (key, counter) -> hash.
    m = 0xFFFFFFFF
    assert srbits.threefry2x32(m, m, m, m) == (0x1CB996FC, 0xBB002BE7)
    assert srbits.threefry2x32(0, 0, 0, 0) == (0x6B200159, 0x99BA4EFE)
    assert srbits.threefry2x32(0x13198A2E, 0x03707344, 0x243F6A88,
                               0x85A308D3) == (0xC4923A9C, 0x483DF7A0)


def test_sr_noise_draws_the_schedules_bits():
    noise = scatter.SrNoise(3 + 0x5EED, "cpu")
    np.testing.assert_array_equal(noise(2, 4, (12, 5)).numpy(),
                                  _jax_bits(3 + 0x5EED, 2, 4, (12, 5)))


def test_cpu_runs_the_plain_version_and_launches_nothing():
    before = srbits.launches
    out = srbits.sr_bits(1, 2, 3, (4, 5), torch.device("cpu"))
    assert srbits.launches == before
    assert int(out.min()) >= 0 and int(out.max()) < 1 << 16


def test_other_devices_are_refused():
    with pytest.raises(KernelUnavailable, match="no kernel for meta"):
        srbits.sr_bits(1, 2, 3, (4, 5), "meta")
