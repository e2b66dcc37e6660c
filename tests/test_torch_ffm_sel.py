"""The sel-blocked FFM kernels' plain versions against the JAX package's
Pallas kernels in interpret mode (``pallas_fused.ffm_sel_scores`` /
``ffm_sel_bwd``), and the wrappers' CPU contract.

Inputs are numpy from a seed; B values that are not multiples of 128
run JAX's padding path. Tolerances: float32 ``acc`` within
``rtol=1e-5, atol=1e-5`` (fp32 sums over k and over fields in another
order) and ``dvs`` within ``atol=1e-6``; bf16 ``dvs`` bit for bit (no
sums: the same three roundings in the same order), bf16 ``acc`` bit for
bit against JAX's owner loop run op by op and, against the fused
interpret-mode kernel, within the rounding that kernel skips (see the
test).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu.ops import pallas_fused
from fm_spark_tpu_torch.ops import KernelUnavailable, ffm_sel

CASES = [(1, 4, 1), (4, 6, 127), (5, 4, 192), (5, 6, 300), (4, 4, 300),
         (1, 6, 127)]


def _inputs(f, k, b, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(b, f, f * k)).astype(np.float32)
    vals = rng.uniform(0.5, 1.5, (b, f)).astype(np.float32)
    vals[::7] = 1.0                             # some ones, most not
    ds = (rng.normal(size=b) * 0.3).astype(np.float32)
    return rows, vals, ds


def _jax_owner_loop(rows, vals):
    """``_ffm_fwd_kernel``'s loop as eager jnp ops, each rounded to the
    inputs' dtype as it is issued."""
    b, f, fk = rows.shape
    rv = rows.reshape(b, f, f, fk // f)
    acc = jnp.zeros((b,), rows.dtype)
    for i in range(f):
        sel_i = rv[:, i] * vals[:, i, None, None]
        selt_i = rv[:, :, i, :] * vals[:, :, None]
        prod = jnp.sum(sel_i * selt_i, axis=-1)
        acc = acc + jnp.sum(prod, axis=1) - prod[:, i]
    return np.asarray(acc.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("f,k,b", CASES)
def test_plain_versions_match_the_jax_kernels(f, k, b, dtype):
    rows, vals, ds = _inputs(f, k, b, seed=f * 100 + k * 10 + b)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jr = jnp.asarray(rows).astype(jdt)
    jv, jds = jnp.asarray(vals).astype(jdt), jnp.asarray(ds).astype(jdt)
    want_acc = np.asarray(pallas_fused.ffm_sel_scores(jr, jv, interpret=True)
                          .astype(jnp.float32))
    want_dvs = np.asarray(pallas_fused.ffm_sel_bwd(jr, jv, jds, interpret=True)
                          .astype(jnp.float32))
    tr = torch.from_numpy(rows.copy()).to(tdt)
    tv = torch.from_numpy(vals.copy()).to(tdt)
    tds = torch.from_numpy(ds.copy()).to(tdt)
    acc = ffm_sel.ffm_sel_scores(tr, tv)
    dvs = ffm_sel.ffm_sel_bwd(tr, tv, tds)
    assert acc.shape == (b,) and acc.dtype == tdt
    assert dvs.shape == (b, f, f * k) and dvs.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(acc.numpy(), want_acc, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(dvs.numpy(), want_dvs, rtol=0, atol=1e-6)
    else:
        got = acc.float().numpy()
        # Term for term: JAX's owner loop run op by op (no fusion) gives
        # the same bits.
        np.testing.assert_array_equal(got, _jax_owner_loop(jr, jv))
        # XLA fuses the interpret-mode kernel and keeps fp32 intermediates
        # where the loop rounds to bf16, so its acc rounds at fewer places.
        # Each of acc's 2F roundings moves it by at most half a bf16 ulp
        # of a value bounded by S = Σ_ij |prod_ij|.
        r = tr.float().reshape(b, f, f, k) * tv.float()[:, :, None, None]
        s = (r * r.transpose(1, 2)).sum(-1).abs().sum((1, 2)).numpy()
        assert (np.abs(got - want_acc) <= 2 * f * 2.0**-8 * s + 3e-3).all()
        np.testing.assert_array_equal(dvs.float().numpy(), want_dvs)
    # The diagonal blocks are zero.
    for i in range(f):
        assert not bool(dvs[:, i, i * k:(i + 1) * k].any())


def test_scores_take_vals_dtype_and_cast_vals_to_the_rows_dtype():
    rows, vals, ds = _inputs(3, 4, 50)
    tr = torch.from_numpy(rows).to(torch.bfloat16)
    acc = ffm_sel.ffm_sel_scores(tr, torch.from_numpy(vals))
    assert acc.dtype == torch.float32               # vals' dtype, as JAX
    same = ffm_sel.ffm_sel_scores(tr, torch.from_numpy(vals).to(torch.bfloat16))
    assert torch.equal(acc, same.float())
    dvs = ffm_sel.ffm_sel_bwd(tr, torch.from_numpy(vals), torch.from_numpy(ds))
    assert dvs.dtype == torch.bfloat16              # the rows' dtype


def test_plain_sums_run_in_index_order():
    # fp32, left to right: 1e8 + 1 rounds back to 1e8, so only the last
    # 1 survives (a pairwise sum would give 0 or 2).
    x = torch.tensor([[1e8, 1.0, -1e8, 1.0]], dtype=torch.float32)
    assert float(ffm_sel._sum_in_order(x, 1)) == 1.0


@pytest.mark.parametrize("fields,rank,cd,ok", [
    (23, 16, 4, True), (23, 16, 2, True), (39, 64, 2, True),
    (60, 64, 4, False), (23, 16, 8, False)])
def test_supported_names_its_reason(fields, rank, cd, ok):
    reason = ffm_sel.ffm_sel_supported(fields, rank, cd)
    assert (reason is None) == ok
    if not ok:
        assert "shared memory" in reason or "bytes" in reason


def test_smem_bytes_at_config_4():
    # 23 × 23 k-vectors at 5 (fp32) or 3 (bf16) 16-byte units each, plus
    # the forward's 2F + F² floats.
    assert ffm_sel.smem_bytes(23, 16, 4) == 529 * 80 + 4 * (46 + 529)
    assert ffm_sel.smem_bytes(23, 16, 2) == 529 * 48 + 4 * (46 + 529)


def test_wrappers_refuse_what_they_do_not_take():
    rows = torch.zeros(4, 3, 7)
    with pytest.raises(KernelUnavailable, match="not divisible"):
        ffm_sel.ffm_sel_scores(rows, torch.ones(4, 3))
    rows = torch.zeros(4, 3, 6)
    with pytest.raises(ValueError, match="vals"):
        ffm_sel.ffm_sel_scores(rows, torch.ones(4, 2))
    with pytest.raises(ValueError, match="dscores"):
        ffm_sel.ffm_sel_bwd(rows, torch.ones(4, 3), torch.ones(5))
    with pytest.raises(TypeError):
        ffm_sel.ffm_sel_scores(rows.double(), torch.ones(4, 3))
    with pytest.raises(KernelUnavailable, match="no kernel for meta"):
        ffm_sel.ffm_sel_scores(rows.to("meta"), torch.ones(4, 3, device="meta"))


def test_cpu_runs_the_plain_version_and_launches_nothing():
    rows, vals, ds = _inputs(4, 4, 10)
    before = (ffm_sel.scores_launches, ffm_sel.bwd_launches)
    tr, tv, tds = (torch.from_numpy(a) for a in (rows, vals, ds))
    assert torch.equal(ffm_sel.ffm_sel_scores(tr, tv),
                       ffm_sel.ffm_sel_scores_plain(tr, tv))
    assert torch.equal(ffm_sel.ffm_sel_bwd(tr, tv, tds),
                       ffm_sel.ffm_sel_bwd_plain(tr, tv, tds))
    assert (ffm_sel.scores_launches, ffm_sel.bwd_launches) == before
