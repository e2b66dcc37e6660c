"""The port's sparse row updates (``fm_spark_tpu_torch.ops.scatter``)
against the JAX package's ``fm_spark_tpu.ops.scatter``.

Integer results (the compact aux) and stochastic rounding with JAX's own
noise bits injected are held bitwise. Float updates are held at
``rtol=1e-5, atol=1e-6`` for fp32 tables (the segment sums are fp32 in
another summation order); compact writes to bf16 tables at one bf16 ulp
of the result (``rtol=2**-7``: one rounding of the same fp32 value), and
bf16 scatter-add, which rounds after every duplicate's add, at the
reference's bf16 step tolerance ``atol=1e-2``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu.ops import scatter as jscatter
from fm_spark_tpu_torch.ops import scatter

B, F, BUCKET, W = 256, 5, 96, 9


def _ids(seed=0, bucket=BUCKET, b=B, f=F):
    rng = np.random.default_rng(seed)
    return (rng.zipf(1.3, (b, f)) % bucket).astype(np.int32)


def _jax_bits(seed, step, field, shape):
    key = jscatter.sr_key(jax.random.key(seed + 0x5EED), step, field)
    bits = jax.random.bits(key, shape, jnp.uint32) & jnp.uint32(0xFFFF)
    return np.asarray(bits).astype(np.int32)


@pytest.mark.parametrize("cap", [40, 96, 256])
@pytest.mark.parametrize("b", [1, 37, 256])
def test_compact_aux_bitwise_equals_jax(cap, b):
    ids = _ids(seed=b, b=b)
    cap = min(cap, b)
    try:
        want = jscatter.compact_aux(ids, cap)
    except jscatter.CompactCapOverflow:
        with pytest.raises(scatter.CompactCapOverflow, match="compact cap"):
            scatter.compact_aux(ids, cap)
        return
    got = scatter.compact_aux(ids, cap)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    # Padding past the unique count: distinct ascending sentinels.
    useg = got[0][0]
    n = np.unique(ids[:, 0]).size
    assert (np.diff(useg) > 0).all()
    np.testing.assert_array_equal(
        useg[n:], np.iinfo(np.int32).max - cap + np.arange(cap - n))


def test_compact_aux_overflow_and_bad_input_raise():
    ids = np.arange(B * F, dtype=np.int32).reshape(B, F)
    with pytest.raises(jscatter.CompactCapOverflow):
        jscatter.compact_aux(ids, 10)
    with pytest.raises(scatter.CompactCapOverflow, match="field 0: 256"):
        scatter.compact_aux(ids, 10)
    assert issubclass(scatter.CompactCapOverflow, ValueError)
    for bad, cap in ((-ids, 10), (ids[:, 0], 10), (ids, 0), (ids, B + 1)):
        with pytest.raises(ValueError):
            scatter.compact_aux(bad, cap)


def _sr_inputs():
    rng = np.random.default_rng(4)
    x = (rng.normal(size=(64, W)) * 3).astype(np.float32)
    bmax = float(jnp.finfo(jnp.bfloat16).max)
    # Just below bf16 max with all-ones low bits: the noise carry would
    # overflow these to inf, so they must saturate to +-max.
    near = np.frombuffer(np.float32(bmax).tobytes(), np.uint32)[0] | 0xFFFF
    x[0, :3] = np.frombuffer(np.uint32(near).tobytes(), np.float32)[0]
    x[0, 3:6] = -x[0, 0]
    x[1, :4] = [np.nan, np.inf, -np.inf, 0.0]
    x[1, 4:6] = [-0.0, 1e-40]
    return x


def test_stochastic_round_bitwise_equals_jax_with_injected_bits():
    x = _sr_inputs()
    key = jscatter.sr_key(jax.random.key(7 + 0x5EED), 3, 2)
    want = np.asarray(jscatter.stochastic_round(jnp.asarray(x), jnp.bfloat16,
                                                key))
    noise = torch.from_numpy(_jax_bits(7, 3, 2, x.shape))
    got = scatter.stochastic_round(torch.from_numpy(x), torch.bfloat16, noise)
    assert got.dtype == torch.bfloat16
    got_bits = got.view(torch.int16).numpy()
    want_bits = want.view(np.int16)
    nan = np.isnan(x)
    np.testing.assert_array_equal(got_bits[~nan], want_bits[~nan])
    assert torch.isnan(got.float()).numpy()[nan].all()
    # Saturation, not overflow.
    assert float(got[0, 0]) == float(jnp.finfo(jnp.bfloat16).max)
    assert float(got[0, 3]) == -float(jnp.finfo(jnp.bfloat16).max)
    assert float(got[1, 1]) == np.inf and float(got[1, 2]) == -np.inf


def test_stochastic_round_fp32_identity_and_bad_dtypes():
    x = torch.randn(4, 3)
    assert scatter.stochastic_round(x, torch.float32) is x
    with pytest.raises(ValueError, match="noise"):
        scatter.stochastic_round(x, torch.bfloat16)
    with pytest.raises(ValueError, match="bf16/fp32"):
        scatter.stochastic_round(x, torch.float16, torch.zeros(4, 3))


def test_sr_noise_is_deterministic_per_step_and_field():
    a = scatter.SrNoise(5, "cpu")
    b = scatter.SrNoise(5, "cpu")
    n = a(3, 1, (7, 4))
    assert n.dtype == torch.int32 and n.shape == (7, 4)
    assert int(n.min()) >= 0 and int(n.max()) < 1 << 16
    assert torch.equal(n, b(3, 1, (7, 4)))          # a re-run draws the same
    assert not torch.equal(n, a(3, 2, (7, 4)))      # another field differs
    assert not torch.equal(n, a(4, 1, (7, 4)))      # another step differs
    assert not torch.equal(n, scatter.SrNoise(6, "cpu")(3, 1, (7, 4)))


def _tables(dtype, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(BUCKET, W)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("mode", ["dedup", "dedup_sr"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("segtotal", [False, True])
def test_compact_apply_matches_jax(mode, dtype, segtotal):
    ids = _ids(seed=9)
    cap = 96
    aux = jscatter.compact_aux(ids, cap)
    rng = np.random.default_rng(1)
    delta = (rng.normal(size=(B, W)) * 0.01).astype(np.float32)
    table = _tables(dtype)
    jt = jnp.asarray(table).astype(dtype)
    # A copy: on the CPU jnp.asarray may share the numpy buffer, which the
    # port's in-place writes would change under JAX.
    tt = torch.from_numpy(table.copy()).to(getattr(torch, dtype))
    for f in range(2):
        caux = tuple(a[f] for a in aux)
        key = jscatter.sr_key(jax.random.key(0x5EED), 0, f)
        jur = jscatter.compact_gather(jt, jnp.asarray(caux[0]))
        jt = jscatter.compact_apply(jt, jnp.asarray(delta), tuple(
            jnp.asarray(a) for a in caux), mode, key, jur,
            segtotal_pallas=segtotal)
        tur = scatter.compact_gather(tt, torch.from_numpy(caux[0]))
        if f == 0:        # the same table: the same rows, sentinels clipped
            np.testing.assert_array_equal(tur.float().numpy(),
                                          np.asarray(jur, np.float32))
        noise = (torch.from_numpy(_jax_bits(0, 0, f, (cap, W)))
                 if mode == "dedup_sr" and dtype == "bfloat16" else None)
        out = scatter.compact_apply(
            tt, torch.from_numpy(delta),
            tuple(torch.from_numpy(a) for a in caux), mode, noise, tur,
            segtotal_pallas=segtotal)
        assert out is tt                                   # in place
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=2.0**-7, atol=0)
    np.testing.assert_allclose(tt.float().numpy(), np.asarray(jt, np.float32),
                               **tol)


def test_compact_write_leaves_rows_outside_the_batch_alone():
    # The last table row in the batch and out of it: the sentinel slots
    # clamp to it and must leave it as the real write (or nothing) left it.
    for last_in_batch in (True, False):
        ids = _ids(seed=3, bucket=BUCKET - 1)
        if last_in_batch:
            ids[5, 0] = BUCKET - 1
        aux = scatter.compact_aux(ids, 128)
        caux = tuple(torch.from_numpy(a[0]) for a in aux)
        table = torch.from_numpy(_tables("float32"))
        before = table.clone()
        ur = scatter.compact_gather(table, caux[0])
        totals = torch.full((128, W), 0.5)
        scatter.compact_apply_totals(table, totals, caux, "dedup_sr", None, ur)
        touched = np.unique(ids[:, 0])
        untouched = np.setdiff1d(np.arange(BUCKET), touched)
        assert torch.equal(table[untouched], before[untouched])
        torch.testing.assert_close(table[touched], before[touched] + 0.5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_add_matches_jax_and_drops_out_of_range(dtype):
    rng = np.random.default_rng(5)
    ids = _ids(seed=5)[:, 0]
    # -1 counts from the end; the others are dropped, as mode="drop".
    ids[:4] = [-1, BUCKET, BUCKET + 7, -BUCKET - 1]
    delta = (rng.normal(size=(B, W)) * 0.01).astype(np.float32)
    table = _tables(dtype)
    want = jscatter.apply_row_updates(jnp.asarray(table).astype(dtype),
                                      jnp.asarray(ids), jnp.asarray(delta))
    got = scatter.apply_row_updates(
        torch.from_numpy(table.copy()).to(getattr(torch, dtype)),
        torch.from_numpy(ids), torch.from_numpy(delta))
    # bf16: every duplicate's add rounds, in another order in each
    # framework, so the head row drifts by a few ulps: the reference's
    # own bf16 step tolerance.
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == "float32" else \
        dict(rtol=0, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


def test_sentinel_range_guard():
    useg = torch.zeros(8, dtype=torch.int32)
    big = torch.empty(1, 1).expand(2**31 - 4, 1)
    with pytest.raises(ValueError, match="sentinel range"):
        scatter.compact_gather(big, useg)
