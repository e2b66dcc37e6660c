"""The row kernels' plain versions (``fm_spark_tpu_torch.ops.rows``) against
the JAX package's ``pallas_fm.gather_rows`` / ``update_rows_add`` run in
interpret mode, and the wrappers' device rules.

A gather is a copy and the update one fp32 add and one rounding per
element, so both are held bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu.ops import pallas_fm
from fm_spark_tpu_torch.ops import KernelUnavailable, rows

N = 700


def _table(w, dtype, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, w)) * 0.5).astype(np.float32), dtype


def _bits(t):
    """A tensor's or array's raw bits as int numpy (bf16 compared by bits)."""
    if isinstance(t, torch.Tensor):
        t = t.contiguous()
        return t.view(torch.int16 if t.dtype == torch.bfloat16
                      else torch.int32).numpy()
    a = np.asarray(t)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


# Widths of every regime of the gather kernel: rows narrower than a
# 16-byte chunk (1, 3), rows of whole chunks (4, 8 fp32; 8 bf16), config
# 3's 65 and config 4's 369 columns, and the widest kernel-B row (128).
WIDTHS = [1, 3, 4, 8, 65, 128, 369]

DTYPES = [("float32", jnp.float32, torch.float32),
          ("bfloat16", jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("b", [256, 512])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
def test_gather_plain_equals_jax_kernel_bitwise(w, b, name, jdt, tdt):
    arr, _ = _table(w, name, seed=w + b)
    ids = np.random.default_rng(b).integers(0, N, b).astype(np.int32)
    want = pallas_fm.gather_rows(jnp.asarray(arr).astype(jdt),
                                 jnp.asarray(ids), interpret=True)
    table = torch.from_numpy(arr.copy()).to(tdt)
    got = rows.gather_rows(table, torch.from_numpy(ids))
    assert got.dtype == tdt and got.shape == (b, w)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(
        _bits(rows.gather_rows_plain(table, torch.from_numpy(ids))),
        _bits(want))


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("b", [256, 512])
@pytest.mark.parametrize("name,jdt,tdt", DTYPES, ids=[d[0] for d in DTYPES])
@pytest.mark.parametrize("delta_bf16", [False, True])
def test_update_plain_equals_jax_kernel_bitwise(w, b, name, jdt, tdt,
                                                delta_bf16):
    rng = np.random.default_rng(w * b)
    arr, _ = _table(w, name, seed=w)
    ids = rng.permutation(N)[:b].astype(np.int32)        # unique
    valid = (rng.random(b) < 0.6).astype(np.int32)
    # Invalid lanes all aim at row 0: a lane that wrote would show there.
    ids = np.where(valid == 1, ids, 0).astype(np.int32)
    delta = (rng.normal(size=(b, w)) * 0.01).astype(np.float32)
    jd = jnp.asarray(delta).astype(jnp.bfloat16 if delta_bf16 else jnp.float32)
    td = torch.from_numpy(delta).to(torch.bfloat16 if delta_bf16
                                    else torch.float32)
    want = pallas_fm.update_rows_add(jnp.asarray(arr).astype(jdt),
                                     jnp.asarray(ids), jnp.asarray(valid), jd,
                                     interpret=True)
    table = torch.from_numpy(arr.copy()).to(tdt)
    out = rows.update_rows_add(table, torch.from_numpy(ids),
                               torch.from_numpy(valid), td)
    assert out is table                                   # in place
    np.testing.assert_array_equal(_bits(table), _bits(want))


@pytest.mark.parametrize("d", [1, 2, 3, 4, 5, 7, 8, 16, 17, 23, 33, 65, 92,
                               128, 260, 369, 1000, 1476, (1 << 20) + 7,
                               (1 << 31) - 1])
def test_divider_divides_every_31_bit_numerator(d):
    magic, shift = rows._divider(d)
    assert 0 < magic < 1 << 32
    rng = np.random.default_rng(d)
    xs = np.concatenate([np.arange(0, min(4 * d + 3, 5000)),
                         [(1 << 31) - 1, (1 << 31) - 2],
                         (np.arange(1, 200) * d) - 1, np.arange(1, 200) * d,
                         rng.integers(0, 1 << 31, 5000)])
    xs = [int(x) for x in xs if 0 <= x < 1 << 31]
    assert [(x * magic) >> shift for x in xs] == [x // d for x in xs]


@pytest.mark.parametrize("offset", [1, 2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_takes_a_table_at_a_storage_offset(offset, dtype):
    """A contiguous view at a storage offset is a legal table."""
    base = torch.arange(16 * 4 + 8, dtype=torch.float32).to(dtype)
    table = base[offset:offset + 16 * 4].view(16, 4)
    assert table.is_contiguous() and table.storage_offset() == offset
    ids = torch.tensor([0, 15, 3, -1, 99], dtype=torch.int32)
    assert torch.equal(rows.gather_rows(table, ids), table[[0, 15, 3, 0, 15]])


def test_gather_clamps_out_of_range_ids():
    table = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    ids = torch.tensor([-5, -1, 0, 5, 6, 1 << 30], dtype=torch.int32)
    got = rows.gather_rows(table, ids)
    assert torch.equal(got, table[[0, 0, 0, 5, 5, 5]])


def test_update_skips_invalid_and_out_of_range_lanes():
    table = torch.zeros(5, 3)
    ids = torch.tensor([1, -1, 5, 2, 3], dtype=torch.int32)
    valid = torch.tensor([1, 1, 1, 0, 1], dtype=torch.int32)
    delta = torch.ones(5, 3)
    rows.update_rows_add(table, ids, valid, delta)
    want = torch.zeros(5, 3)
    want[1] = want[3] = 1.0
    assert torch.equal(table, want)


def test_empty_batch_is_a_no_op():
    table = torch.randn(4, 3)
    before = table.clone()
    none = torch.zeros(0, dtype=torch.int32)
    assert rows.gather_rows(table, none).shape == (0, 3)
    rows.update_rows_add(table, none, none, torch.zeros(0, 3))
    assert torch.equal(table, before)


def test_wrappers_refuse_bad_operands_and_other_devices():
    table = torch.zeros(4, 3)
    ids = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        rows.gather_rows(table, ids.long())
    with pytest.raises(TypeError):
        rows.gather_rows(table.double(), ids)
    with pytest.raises(ValueError):
        rows.gather_rows(torch.zeros(0, 3), ids)
    with pytest.raises(TypeError):
        rows.update_rows_add(table, ids, ids.bool(), torch.zeros(2, 3))
    with pytest.raises(TypeError):
        rows.update_rows_add(table, ids, ids, torch.zeros(2, 4))
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(KernelUnavailable, match="no kernel"):
        rows.gather_rows(meta, ids.to("meta"))
    with pytest.raises(KernelUnavailable, match="no kernel"):
        rows.update_rows_add(meta, ids.to("meta"), ids.to("meta"),
                             torch.zeros(2, 3, device="meta"))
    # The CPU runs the plain versions: no launch.
    assert rows.gather_launches == 0 and rows.update_launches == 0
