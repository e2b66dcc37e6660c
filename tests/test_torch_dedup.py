"""The port's per-lane dedup forms and host aux builders
(``fm_spark_tpu_torch.ops.scatter`` and ``fm_spark_tpu_torch.native``)
against the JAX package's ``fm_spark_tpu.ops.scatter``.

Integer results (the aux builders, the device sort's order and masks) are
held int for int. Float updates of fp32 tables are held at
``rtol=1e-6, atol=1e-7``: the segment sums are fp32 in another summation
order. Writes to bf16 tables at one bf16 ulp (``rtol=2**-7``): one
rounding of fp32 values that may differ by that reassociation. The SR
bits of ``dedup_sr`` on bf16 tables are JAX's own, injected.
"""

import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu.ops import scatter as jscatter
from fm_spark_tpu_torch import native
from fm_spark_tpu_torch.ops import rows, scatter

N, W = 40, 9


def _jax_bits(seed, step, field, shape):
    key = jscatter.sr_key(jax.random.key(seed + 0x5EED), step, field)
    bits = jax.random.bits(key, shape, jnp.uint32) & jnp.uint32(0xFFFF)
    return np.asarray(bits).astype(np.int32)


def _ids(b, seed, n=N, wild=False):
    """Zipf ids with heavy duplication; ``wild`` adds out-of-range ones
    (too high, and negative below -n) and one -1, which counts from the end
    on the XLA path and never aliases a real id (all are below n - 1)."""
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, b) % (n - 1)).astype(np.int32)
    if wild:
        ids[:5] = [-1, n, n + 7, -n - 3, n]
        rng.shuffle(ids)
    return ids


def _table(dtype, seed=2, w=W):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, w)) * 0.5).astype(np.float32)


def _tol(dtype):
    return (dict(rtol=1e-6, atol=1e-7) if dtype == "float32"
            else dict(rtol=2.0 ** -7, atol=0))


@pytest.mark.parametrize("b", [1, 48, 300])
def test_device_dedup_matches_jax(b):
    """The port's per-segment form against JAX's per-lane one: segment s
    is JAX's s-th run-start lane (its id, its first lane in sorted order,
    its total); the segments past the count are not live."""
    ids = _ids(b, seed=b, wild=b > 5)
    delta = (np.random.default_rng(1).normal(size=(b, W)) * 0.1).astype(
        np.float32)
    jsid, jsum, jrun, jorder = (np.asarray(a) for a in jscatter._dedup(
        jnp.asarray(ids), jnp.asarray(delta)))
    d = scatter._dedup(torch.from_numpy(ids), torch.from_numpy(delta))
    u = int(jrun.sum())
    assert int(d.count) == u and d.count.dtype == torch.int32
    np.testing.assert_array_equal(d.order.numpy(), jorder)
    np.testing.assert_array_equal(d.run_start.numpy(), jrun)
    np.testing.assert_array_equal(d.seg.numpy(), np.cumsum(jrun) - 1)
    np.testing.assert_array_equal(d.useg[:u].numpy(), jsid[jrun])
    np.testing.assert_array_equal(scatter._first_lanes(d)[:u].numpy(),
                                  np.flatnonzero(jrun))
    assert d.totals.dtype == torch.float32 and d.totals.shape == (b, W)
    np.testing.assert_allclose(d.totals[:u].numpy(), jsum[jrun],
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("b", [1, 100, 300])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pallas_gather_clamps_like_jax(b, dtype):
    table = _table(dtype)
    ids = _ids(b, seed=b, wild=b > 5)
    want = jscatter.pallas_gather(jnp.asarray(table).astype(dtype),
                                  jnp.asarray(ids))
    got = scatter.pallas_gather(
        torch.from_numpy(table.copy()).to(getattr(torch, dtype)),
        torch.from_numpy(ids))
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


@pytest.mark.parametrize("mode", ["scatter_add", "dedup"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [48, 300])
def test_pallas_dedup_add_matches_jax(mode, dtype, b):
    """B not a multiple of 256 (JAX pads), duplicates, out-of-range and
    negative ids (dropped), bf16 tables summed once."""
    table = _table(dtype)
    ids = _ids(b, seed=7 + b, wild=True)
    delta = (np.random.default_rng(3).normal(size=(b, W)) * 0.05).astype(
        np.float32)
    want = jscatter.apply_row_updates(
        jnp.asarray(table).astype(dtype), jnp.asarray(ids),
        jnp.asarray(delta), mode=mode, use_pallas=True)
    tt = torch.from_numpy(table.copy()).to(getattr(torch, dtype))
    out = scatter.apply_row_updates(tt, torch.from_numpy(ids),
                                    torch.from_numpy(delta), mode,
                                    use_pallas=True)
    assert out is tt
    np.testing.assert_allclose(tt.float().numpy(),
                               np.asarray(want, np.float32), **_tol(dtype))


def test_pallas_update_drops_negative_and_high_ids():
    """The port's version of the reference's pin: out-of-range lanes, a
    negative one especially, never touch the table."""
    table = torch.ones(16, 4)
    ids = torch.tensor([3, -1, 16, 100, -7, 3], dtype=torch.int32)
    delta = torch.full((6, 4), 10.0)
    got = scatter.apply_row_updates(table, ids, delta, mode="dedup",
                                    use_pallas=True)
    want = torch.ones(16, 4)
    want[3] += 20.0                   # two valid lanes, deduped
    assert torch.equal(got, want)
    # The XLA route counts -1 and -7 from the end instead, as JAX's.
    plain = scatter.apply_row_updates(torch.ones(16, 4), ids, delta,
                                      mode="dedup")
    want[15] += 10.0
    want[9] += 10.0
    assert torch.equal(plain, want)
    jwant = jscatter.apply_row_updates(jnp.ones((16, 4)),
                                       jnp.asarray(ids.numpy()),
                                       jnp.asarray(delta.numpy()),
                                       mode="dedup")
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jwant))


MODES = [(mode, pallas, host)
         for mode in ("scatter_add", "dedup", "dedup_sr")
         for pallas in (False, True)
         for host in (False, True)
         if not (host and mode == "scatter_add")
         and not (host and pallas)]


def _every_mode(mode, pallas, host, dtype, w):
    b = 96
    table = _table(dtype, seed=5, w=w)
    # The host aux takes only non-negative ids.
    ids = _ids(b, seed=11, wild=not host)
    rng = np.random.default_rng(12)
    delta = (rng.normal(size=(b, w)) * 0.05).astype(np.float32)
    jt = jnp.asarray(table).astype(dtype)
    old = np.asarray(jscatter.pallas_gather(jt, jnp.asarray(ids))
                     if pallas else jt[jnp.asarray(ids)])
    key = jscatter.sr_key(jax.random.key(4 + 0x5EED), 2, 1)
    aux = jscatter.dedup_aux(ids) if host else None
    want = jscatter.apply_row_updates(
        jt, jnp.asarray(ids), jnp.asarray(delta), mode=mode, key=key,
        old_rows=jnp.asarray(old), use_pallas=pallas,
        aux=None if aux is None else tuple(map(jnp.asarray, aux)))
    tt = torch.from_numpy(table.copy()).to(getattr(torch, dtype))
    noise = (torch.from_numpy(_jax_bits(4, 2, 1, (b, w)))
             if mode == "dedup_sr" and dtype == "bfloat16" else None)
    paux = None if aux is None else tuple(
        torch.from_numpy(a) for a in scatter.dedup_aux(ids))
    scatter.apply_row_updates(
        tt, torch.from_numpy(ids), torch.from_numpy(delta), mode,
        noise=noise, old_rows=torch.from_numpy(old.astype(np.float32)).to(
            getattr(torch, dtype)),
        use_pallas=pallas, aux=paux)
    # bf16 scatter_add without the kernel rounds after every duplicate's
    # add, in another order in each framework: the reference's bf16 step
    # tolerance.
    tol = (dict(rtol=0, atol=1e-2)
           if (mode, pallas, dtype) == ("scatter_add", False, "bfloat16")
           else _tol(dtype))
    np.testing.assert_allclose(tt.float().numpy(),
                               np.asarray(want, np.float32), **tol)
    assert rows.update_launches == 0           # the CPU: plain versions


@pytest.mark.parametrize("mode,pallas,host", MODES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_row_updates_matches_jax_in_every_mode(mode, pallas, host,
                                                     dtype):
    _every_mode(mode, pallas, host, dtype, W)


@pytest.mark.parametrize("mode,pallas,host", MODES)
@pytest.mark.parametrize("w", [65, 369], ids=["fm", "ffm"])
def test_dedup_forms_match_jax_at_model_widths(mode, pallas, host, w):
    """Every mode at config 3's row width (65) and config 4's (369), where
    the per-segment dedup sums rows of the models' own widths."""
    _every_mode(mode, pallas, host, "float32", w)


def test_aux_apply_matches_device_dedup_and_guards():
    """The host aux path equals the device sort's (fp32, where SR is the
    identity), and the reference's guards hold."""
    rng = np.random.default_rng(6)
    table = torch.from_numpy(rng.normal(size=(20, 6)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(0, 20, 40).astype(np.int32))
    delta = torch.from_numpy(rng.normal(size=(40, 6)).astype(np.float32))
    aux = tuple(torch.from_numpy(a) for a in scatter.dedup_aux(ids.numpy()))
    for mode in ("dedup", "dedup_sr"):
        want = scatter.apply_row_updates(table.clone(), ids, delta, mode,
                                         old_rows=table[ids.long()])
        got = scatter.apply_row_updates(table.clone(), ids, delta, mode,
                                        old_rows=table[ids.long()], aux=aux)
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="dedup mode"):
        scatter.apply_row_updates(table, ids, delta, "scatter_add", aux=aux)
    for kw in (dict(aux=aux), {}):
        with pytest.raises(ValueError, match="old_rows"):
            scatter.apply_row_updates(table, ids, delta, "dedup_sr", **kw)
    with pytest.raises(ValueError, match="unknown"):
        scatter.apply_row_updates(table, ids, delta, "nope")


def test_dedup_sr_set_keeps_rows_outside_the_batch_and_last_row():
    """Every dropped lane writes the value its row ends with: the rows the
    batch does not touch stay, row n - 1 included, whatever lanes clamp
    to it."""
    table = torch.from_numpy(_table("float32"))
    before = table.clone()
    ids = torch.tensor([3, 3, N, N + 9, 5, -2 * N], dtype=torch.int32)
    delta = torch.ones(6, W)
    scatter.apply_row_updates(table, ids, delta, "dedup_sr",
                              old_rows=before[ids.long().clamp(0, N - 1)])
    want = before.clone()
    want[3] += 2.0
    want[5] += 1.0
    assert torch.equal(table, want)


@pytest.mark.parametrize("f", [1, 5])
@pytest.mark.parametrize("b", [0, 1, 300, 4096])
def test_native_aux_equals_numpy_and_jax(f, b):
    rng = np.random.default_rng(b + f)
    ids = (rng.zipf(1.3, (b, f)) % 50).astype(np.int32)     # heavy dups
    got = scatter.dedup_aux(ids)
    for name, g, p, j in zip(("order", "seg", "useg", "ord_first"), got,
                             scatter.dedup_aux_plain(ids),
                             jscatter.dedup_aux(ids)):
        assert g.dtype == np.int32 and g.shape == (f, b)
        np.testing.assert_array_equal(g, p, err_msg=name)
        np.testing.assert_array_equal(g, j, err_msg=name)
    cap = max(1, min(b, 64))
    try:
        want = jscatter.compact_aux(ids, cap)
    except jscatter.CompactCapOverflow:
        want = None
    if want is None:
        with pytest.raises(scatter.CompactCapOverflow):
            scatter.compact_aux(ids, cap)
        return
    for g, p, j in zip(scatter.compact_aux(ids, cap),
                       scatter.compact_aux_plain(ids, cap), want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_array_equal(g, j)
    if b:                                   # the native builder ran
        assert native._lib is not None


def test_native_one_dimensional_and_empty_batches():
    ids = np.array([4, 1, 4, 0], np.int32)
    for g, j in zip(scatter.dedup_aux(ids), jscatter.dedup_aux(ids)):
        assert g.shape == (4,)
        np.testing.assert_array_equal(g, j)
    with pytest.raises(ValueError, match="non-negative"):
        scatter.dedup_aux(np.array([[1], [-1]], np.int32))


def test_compact_overflow_names_the_lowest_field_on_both_builders():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 8, (300, 6)).astype(np.int32)
    ids[:, 2] = np.arange(300)                 # fields 2 and 4 overflow
    ids[:, 4] = np.arange(300)[::-1]
    for build in (scatter.compact_aux, scatter.compact_aux_plain):
        with pytest.raises(scatter.CompactCapOverflow,
                           match="field 2: 300 unique ids > compact cap 16"):
            build(ids, 16)


def test_bucket_too_large_for_the_counting_sort_uses_numpy():
    ids = np.array([[0, 5], [1 << 28, 5], [3, 1 << 29]], np.int32)
    assert not native.counting_sort_fits((1 << 29) + 1, 2)
    with mock.patch.object(native, "dedup_aux",
                           side_effect=AssertionError("native called")), \
            mock.patch.object(native, "compact_aux",
                              side_effect=AssertionError("native called")):
        got = scatter.dedup_aux(ids)
        gotc = scatter.compact_aux(ids, 3)
    for g, j in zip(got, jscatter.dedup_aux(ids)):
        np.testing.assert_array_equal(g, j)
    for g, j in zip(gotc, jscatter.compact_aux(ids, 3)):
        np.testing.assert_array_equal(g, j)


def test_failed_native_build_raises_with_the_compiler_output(tmp_path,
                                                              monkeypatch):
    with monkeypatch.context() as m:
        m.setattr(native.shutil, "which", lambda name: None)
        with pytest.raises(native.NativeBuildError, match="g\\+\\+ not found"):
            native._gxx()
    fake = tmp_path / "g++"
    fake.write_text("#!/bin/sh\necho 'aux.cpp:1: error: bad'\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(native, "_gxx", lambda: str(fake))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeBuildError, match="error: bad"):
        scatter.dedup_aux(np.zeros((4, 2), np.int32))
    # No fallback: the numpy builder is not taken in its place.
    with pytest.raises(native.NativeBuildError):
        scatter.compact_aux(np.zeros((4, 2), np.int32), 1)
