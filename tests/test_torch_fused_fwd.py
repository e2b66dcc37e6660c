"""The port's fused gather→FM-interaction forward against the JAX package.

On CPU tensors ``fm_spark_tpu_torch.ops.fused_fwd.fm_fused_scores`` runs
its plain PyTorch version (the CUDA kernel itself is checked against that
version on the card by ``chip_smoke.py`` and by the ``gpu``-marked test
in ``test_torch_package.py``). Here the same numpy inputs go through the
JAX Pallas kernel in interpret mode and through the XLA formula of
``FieldFMSpec.scores``.

Tolerance: ``rtol=1e-5, atol=1e-5``. Both sides accumulate in float32 in
different orders, and the score is the difference of two sums (Σs² and
Σxv²) that are each far larger than the score, so an absolute bound alone
fails on large scores: the JAX package's own
``test_fm_fused_forward_matches_xla_reference`` misses ``atol=1e-5`` by
one element at a score of ~40 (relative difference 3.8e-7). bf16 storage
keeps the same tolerance: both packages round the same numpy values to
bf16 the same way (round to nearest even) and widen them to float32
exactly, so what is left is the float32 summation order, as for fp32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu.models import FieldFMSpec as JaxFieldFMSpec
from fm_spark_tpu.ops import pallas_fused
from fm_spark_tpu_torch.ops import KernelUnavailable, fused_fwd

F, BUCKET, B = 4, 60, 24
RTOL, ATOL = 1e-5, 1e-5


def _inputs(k, seed, f=F):
    # Rows at 0.3·sqrt(F / f): Σs² and Σxv² stay the size they are at
    # F = 4 (the size the tolerance above is stated for) at any field count.
    rng = np.random.default_rng(seed)
    scale = 0.3 * np.sqrt(F / f)
    tables = [(rng.normal(size=(BUCKET, k + 1)) * scale).astype(np.float32)
              for _ in range(f)]
    ids = rng.integers(0, BUCKET, (B, f)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (B, f)).astype(np.float32)
    ids[0, :] = 0                       # table edges
    ids[1, :] = BUCKET - 1
    ids[-3:] = 0                        # padded rows: id 0, value 0
    vals[-3:] = 0.0
    return tables, ids, vals


def _port(tables, ids, vals, dtype, use_linear, w0):
    t = [torch.from_numpy(x).to(dtype) for x in tables]
    w = None if w0 is None else torch.tensor(w0, dtype=torch.float32)
    s, acc = fused_fwd.fm_fused_scores(t, torch.from_numpy(ids),
                                       torch.from_numpy(vals),
                                       use_linear=use_linear, w0=w)
    return s.numpy(), acc.numpy()


# Widths 9, 65 and 129 (past the 128 columns the first kernel took) at
# F = 4, and 70 fields (past its 64) at width 65.
@pytest.mark.parametrize("k,f", [(8, F), (64, F), (128, F), (64, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_linear", [True, False])
@pytest.mark.parametrize("w0", [None, 0.3])
def test_fused_fwd_matches_jax_pallas_and_xla(k, f, dtype, use_linear, w0):
    tables, ids, vals = _inputs(k, seed=k + f - F, f=f)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    got_s, got_acc = _port(tables, ids, vals, tdt, use_linear, w0)

    jt = [jnp.asarray(t, dtype) for t in tables]
    ref_s, ref_acc = pallas_fused.fm_fused_scores(
        jt, jnp.asarray(ids), jnp.asarray(vals), use_linear=use_linear,
        w0=None if w0 is None else jnp.float32(w0), interpret=True)
    np.testing.assert_allclose(got_s, np.asarray(ref_s), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_acc, np.asarray(ref_acc), rtol=RTOL,
                               atol=ATOL)

    spec = JaxFieldFMSpec(num_features=f * BUCKET, rank=k, num_fields=f,
                          bucket=BUCKET, use_linear=use_linear,
                          use_bias=w0 is not None, param_dtype=dtype)
    params = {"w0": jnp.float32(0.0 if w0 is None else w0), "vw": jt}
    xla = spec.scores(params, jnp.asarray(ids), jnp.asarray(vals))
    np.testing.assert_allclose(got_s, np.asarray(xla), rtol=RTOL, atol=ATOL)
    # Padded rows score exactly the bias.
    np.testing.assert_array_equal(got_s[-3:], np.float32(w0 or 0.0))


def test_fused_fwd_clamps_ids_like_the_pallas_kernel():
    tables, ids, vals = _inputs(8, seed=3)
    wild = ids.copy()
    wild[2, :] = BUCKET + 7
    wild[3, :] = -5
    clamped = np.clip(wild, 0, BUCKET - 1)
    a = _port(tables, wild, vals, torch.float32, True, 0.1)
    b = _port(tables, clamped, vals, torch.float32, True, 0.1)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_fused_fwd_takes_a_stacked_table_tensor():
    tables, ids, vals = _inputs(8, seed=4)
    listed = _port(tables, ids, vals, torch.float32, True, None)
    stacked = fused_fwd.fm_fused_scores(
        torch.from_numpy(np.stack(tables)), torch.from_numpy(ids),
        torch.from_numpy(vals))
    np.testing.assert_array_equal(listed[0], stacked[0].numpy())


def test_fused_fwd_cpu_path_launches_no_kernel():
    tables, ids, vals = _inputs(8, seed=5)
    before = fused_fwd.launches
    _port(tables, ids, vals, torch.float32, True, None)
    assert fused_fwd.launches == before


def test_fused_fwd_refuses_rather_than_falls_back():
    # A tensor on a device with no kernel is refused: only CPU tensors
    # take the plain version.
    ids = torch.zeros((4, F), dtype=torch.int32, device="meta")
    vals = torch.zeros((4, F), dtype=torch.float32, device="meta")
    tables = [torch.zeros((BUCKET, 9), device="meta") for _ in range(F)]
    with pytest.raises(KernelUnavailable, match="no kernel"):
        fused_fwd.fm_fused_scores(tables, ids, vals)


@pytest.mark.parametrize("bad", ["ids_dtype", "vals_shape", "table_dtype",
                                 "table_count", "table_shape", "empty",
                                 "w0_dtype"])
def test_fused_fwd_validates_inputs(bad):
    tables, ids, vals = _inputs(8, seed=6)
    t = [torch.from_numpy(x) for x in tables]
    i, v, w0 = torch.from_numpy(ids), torch.from_numpy(vals), None
    if bad == "ids_dtype":
        i = i.long()
    elif bad == "vals_shape":
        v = v[:, :2]
    elif bad == "table_dtype":
        t = [x.double() for x in t]
    elif bad == "table_count":
        t = t[:-1]
    elif bad == "table_shape":
        t[1] = t[1][:, :5].contiguous()
    elif bad == "empty":
        i, v = i[:0], v[:0]
    elif bad == "w0_dtype":
        w0 = torch.tensor(0.5, dtype=torch.float64)
    with pytest.raises((TypeError, ValueError)):
        fused_fwd.fm_fused_scores(t, i, v, w0=w0)
