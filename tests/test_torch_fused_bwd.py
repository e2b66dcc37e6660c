"""The port's fused FM backward + segment totals
(``fm_spark_tpu_torch.ops.fused_bwd``) against the JAX package's XLA
composition it subsumes: ``sparse._gfull_grads`` for ``g_full``, then
``scatter.compact_apply``'s blocked-prefix segment sums of ``-lr·g_full``.

Not against the Pallas kernel ``fm_bwd_segment_totals``, whose bit-exact
claim does not hold on this tree (ROADMAP Queue 3). On CPU tensors the
port runs its plain version; the CUDA kernel is held against that version
on the card (``test_torch_package.py``, ``chip_smoke.py``).

Tolerance ``rtol=1e-5, atol=1e-6`` for both compute dtypes: every
elementwise step rounds at the same place in both packages (bf16 too), so
what differs is only the fp32 summation, which the blocked prefix does by
differences of running sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import sparse as jsparse
from fm_spark_tpu.ops import scatter as jscatter
from fm_spark_tpu.train import TrainConfig as JaxTrainConfig
from fm_spark_tpu_torch import models, sparse
from fm_spark_tpu_torch.ops import KernelUnavailable, fused_bwd
from fm_spark_tpu_torch.train import TrainConfig

B, F, K, BUCKET, CAP = 256, 5, 8, 96, 96
RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    ids = (rng.zipf(1.3, (B, F)) % BUCKET).astype(np.int32)
    aux = jscatter.compact_aux(ids, CAP)
    tables = [(rng.normal(size=(BUCKET, K + 1)) * 0.3).astype(np.float32)
              for _ in range(F)]
    vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
    weights = (rng.random(B) > 0.1).astype(np.float32)
    ds = (rng.normal(size=B) * 0.3).astype(np.float32)
    return ids, aux, tables, vals, weights, ds


def _jax_totals(cd, store, use_linear, reg, lr, inputs):
    ids, aux, tables, vals, weights, ds = inputs
    cfg = JaxTrainConfig(reg_factors=reg[0], reg_linear=reg[1])
    vals_c = jnp.asarray(vals).astype(cd)
    urows = [jscatter.compact_gather(jnp.asarray(t).astype(store),
                                     jnp.asarray(aux[0][f]))
             for f, t in enumerate(tables)]
    rows = [u.astype(cd)[jnp.asarray(aux[4][f])] for f, u in enumerate(urows)]
    xv_fulls = [r * vals_c[:, f:f + 1] for f, r in enumerate(rows)]
    s = sum(x[:, :K] for x in xv_fulls)
    touched = jnp.asarray(weights) > 0
    g_fulls = jsparse._gfull_grads(jnp.asarray(ds).astype(cd), vals_c, s,
                                   xv_fulls, rows, touched, K, cd,
                                   use_linear, cfg)
    totals = []
    for f, g in enumerate(g_fulls):
        caux = tuple(jnp.asarray(a[f]) for a in aux)
        zero = jnp.zeros((BUCKET, K + 1), jnp.float32)
        out = jscatter.compact_apply(zero, -jnp.float32(lr) * g, caux,
                                     "dedup", None, None)
        totals.append(np.asarray(out)[aux[0][f][aux[0][f] < BUCKET]])
    return totals, urows, s


@pytest.mark.parametrize("cd,store", [("float32", "float32"),
                                      ("bfloat16", "bfloat16"),
                                      ("float32", "bfloat16")])
@pytest.mark.parametrize("use_linear,reg", [(True, (1e-3, 2e-3)),
                                            (True, (0.0, 0.0)),
                                            (False, (1e-3, 0.0))])
def test_plain_matches_the_xla_composition(cd, store, use_linear, reg):
    lr = np.float32(0.05)
    inputs = _inputs(seed=3)
    ids, aux, tables, vals, weights, ds = inputs
    want, jurows, js = _jax_totals(cd, store, use_linear, reg, lr, inputs)
    tcd, tstore = getattr(torch, cd), getattr(torch, store)
    urows = [torch.from_numpy(np.asarray(u, np.float32)).to(tstore)
             for u in jurows]
    s1 = torch.cat([torch.from_numpy(np.asarray(js, np.float32)).to(tcd),
                    torch.full((B, 1), 1.0 if use_linear else 0.0, dtype=tcd)],
                   dim=1)
    rv = reg if any(reg) else None
    if rv is not None and not use_linear:
        rv = (reg[0], 0.0)
    got = fused_bwd.fm_bwd_segment_totals(
        urows, s1, torch.from_numpy(ds).to(tcd), torch.from_numpy(vals),
        torch.from_numpy(weights), torch.from_numpy(aux[3]),
        torch.from_numpy(aux[4]), float(-lr), rv, cap=CAP)
    assert got.shape == (F, CAP, K + 1) and got.dtype == torch.float32
    for f in range(F):
        n = len(want[f])
        np.testing.assert_allclose(got[f, :n].numpy(), want[f],
                                   rtol=RTOL, atol=ATOL)
        assert not got[f, n:].any()          # spare capacity stays zero


def test_supported_envelope_and_require():
    assert fused_bwd.fm_bwd_supported(12288, 65, 39) is None
    assert "thread per column" in fused_bwd.fm_bwd_supported(96, 129, 5)
    assert "fields" in fused_bwd.fm_bwd_supported(96, 9, 65)
    assert "int32" in fused_bwd.fm_bwd_supported(2**26, 65, 5)
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET)
    cfg = dict(sparse_update="dedup", host_dedup=True, compact_cap=CAP)
    wide = models.FieldFMSpec(rank=128, **kw)
    with pytest.raises(KernelUnavailable, match="require.*thread per column"):
        sparse.make_field_sparse_sgd_body(
            wide, TrainConfig(fused_embed="require", **cfg))
    assert sparse.fused_embed_plan(
        wide, TrainConfig(fused_embed="auto", **cfg))[0] is None
    narrow = models.FieldFMSpec(rank=K, **kw)
    assert sparse.fused_embed_plan(
        narrow, TrainConfig(fused_embed="auto", **cfg)) == ("fm_compact_bwd",
                                                            None)
    # Without the compact path there is nothing for the kernel to serve.
    with pytest.raises(KernelUnavailable, match="compact_cap"):
        sparse.make_field_sparse_sgd_body(narrow,
                                          TrainConfig(fused_embed="require"))


def test_other_devices_are_refused_and_inputs_checked():
    aux = _inputs()[1]

    def call(dev, **over):
        args = dict(
            urows=[torch.zeros(CAP, K + 1, device=dev) for _ in range(F)],
            s1=torch.zeros(B, K + 1, device=dev),
            dscores=torch.zeros(B, device=dev),
            vals=torch.zeros(B, F, device=dev),
            weights=torch.zeros(B, device=dev),
            order=torch.from_numpy(aux[3]).to(dev),
            inv=torch.from_numpy(aux[4]).to(dev))
        args.update(over)
        return fused_bwd.fm_bwd_segment_totals(
            args["urows"], args["s1"], args["dscores"], args["vals"],
            args["weights"], args["order"], args["inv"], -0.1, cap=CAP)

    assert not call("cpu").any()
    with pytest.raises(KernelUnavailable):
        call("meta")
    with pytest.raises(TypeError):
        call("cpu", dscores=torch.zeros(B, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        call("cpu", vals=torch.zeros(B, F + 1))
    with pytest.raises(ValueError, match="urows"):
        call("cpu", urows=[torch.zeros(CAP + 1, K + 1)] * F)
