"""FieldFM's two other forms against the JAX package: the transposed
tables (``table_layout="col"``) and the unfused linear weights
(``fused_linear=False``).

Parameters are drawn by JAX and carried across by ``params_from_numpy``;
batches are numpy from a seed. Scores use ``tests/test_torch_field_fm.py``'s
tolerance (``rtol=1e-5, atol=1e-5``); steps ``tests/test_torch_train.py``'s
(loss within 1e-6 and parameters within ``atol=1e-5`` in float32, loss
within 1e-3 and parameters within ``atol=1e-2`` where bf16 is involved).
The ``col`` layout holds the row layout's values, so its steps equal the
row layout's bit for bit once transposed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fm_spark_tpu import sparse as jsparse
from fm_spark_tpu import train as jtrain
from fm_spark_tpu.models.field_fm import FieldFMSpec as JaxFieldFMSpec
from fm_spark_tpu_torch import models, ops, sparse
from fm_spark_tpu_torch.ops import scatter, segsum
from fm_spark_tpu_torch.train import TrainConfig

B, F, K, BUCKET, CAP = 256, 5, 8, 96, 96


def _specs(pd="float32", cd="float32", **kw):
    kw = dict(num_features=F * BUCKET, num_fields=F, bucket=BUCKET, rank=K,
              param_dtype=pd, compute_dtype=cd, init_std=0.1, **kw)
    return JaxFieldFMSpec(**kw), models.FieldFMSpec(**kw)


def _jax_params(jspec, seed=0):
    """JAX-initialised params with a random linear part and bias."""
    p = jspec.init(jax.random.key(0))
    rng = np.random.default_rng(seed)
    p = dict(p, w0=jnp.float32(0.2))
    if jspec.fused_linear:
        out = []
        for t in p["vw"]:
            a = np.asarray(t.astype(jnp.float32)).copy()
            lin = (slice(None), K) if jspec.table_layout == "row" \
                else (K, slice(None))
            a[lin] = rng.normal(size=a[lin].shape) * 0.1
            out.append(jnp.asarray(a).astype(jspec.pdtype))
        p["vw"] = out
    else:
        p["w"] = [jnp.asarray(rng.normal(size=BUCKET) * 0.1)
                  .astype(jspec.pdtype) for _ in range(F)]
    return p


def _carry(pspec, jp):
    flat = {"w0": np.asarray(jp["w0"])}
    for group in ("vw", "v", "w"):
        flat.update({f"{group}/{f}": np.asarray(t.astype(jnp.float32))
                     for f, t in enumerate(jp.get(group, []))})
    return models.params_from_numpy(pspec, flat, "cpu")


def _batches(n, seed=1):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        ids = (rng.zipf(1.3, (B, F)) % BUCKET).astype(np.int32)
        vals = rng.uniform(0.5, 1.5, (B, F)).astype(np.float32)
        labels = rng.integers(0, 2, B).astype(np.float32)
        weights = np.ones(B, np.float32)
        weights[-7:] = 0.0                      # padded tail lanes
        out.append((ids, vals, labels, weights))
    return out


def _aux(cfg, ids):
    if not cfg.get("host_dedup"):
        return None
    return (scatter.compact_aux(ids, CAP) if cfg.get("compact_cap")
            else scatter.dedup_aux(ids))


def _tables(params):
    return [t for g in ("vw", "v", "w") for t in params.get(g, [])]


# ------------------------------------------------------------- scores


@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", [dict(table_layout="col"),
                                  dict(fused_linear=False)])
def test_scores_match_jax(form, cd):
    jspec, pspec = _specs("float32", cd, **form)
    jp = _jax_params(jspec)
    ids, vals, _, _ = _batches(1, seed=4)[0]
    want = np.asarray(jspec.scores(jp, jnp.asarray(ids), jnp.asarray(vals)),
                      np.float64)
    got = pspec.scores(_carry(pspec, jp), torch.from_numpy(ids),
                       torch.from_numpy(vals)).double().numpy()
    tol = 1e-5 if cd == "float32" else 2e-2
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
    # On the CPU no kernel and no library path is counted.
    assert ops.library_calls() == {"field_fm_scores_library": 0}


def test_col_scores_equal_row_scores_bit_for_bit():
    _, rspec = _specs()
    _, cspec = _specs(table_layout="col")
    rp = rspec.init(torch.Generator().manual_seed(3), device="cpu")
    cp = {"w0": rp["w0"], "vw": [t.t().contiguous() for t in rp["vw"]]}
    ids, vals, _, _ = _batches(1, seed=5)[0]
    args = (torch.from_numpy(ids), torch.from_numpy(vals))
    assert torch.equal(cspec.scores(cp, *args), rspec._scores_plain(rp, *args))


# -------------------------------------------------------------- steps


STEP_FORMS = {
    "col-dedup": ("float32", "float32", dict(table_layout="col"),
                  dict(sparse_update="dedup", host_dedup=True,
                       compact_cap=CAP)),
    "col-dedup_sr-segtotal": ("bfloat16", "bfloat16",
                              dict(table_layout="col"),
                              dict(sparse_update="dedup_sr", host_dedup=True,
                                   compact_cap=CAP, segtotal_pallas=True)),
    "col-dedup-gfull": ("float32", "float32", dict(table_layout="col"),
                        dict(sparse_update="dedup", host_dedup=True,
                             compact_cap=CAP, gfull_fused=True)),
    "col-devaux-drop": ("float32", "float32", dict(table_layout="col"),
                        dict(sparse_update="dedup", compact_device=True,
                             compact_cap=CAP, compact_overflow="drop")),
    "unfused-fp32": ("float32", "float32", dict(fused_linear=False),
                     dict(sparse_update="scatter_add")),
    "unfused-bf16": ("bfloat16", "bfloat16", dict(fused_linear=False),
                     dict(sparse_update="scatter_add")),
    "unfused-no-linear": ("float32", "float32",
                          dict(fused_linear=False, use_linear=False),
                          dict(sparse_update="scatter_add")),
}


@pytest.mark.parametrize("form", list(STEP_FORMS))
def test_three_steps_match_jax(form):
    pd, cd, spec_kw, lever = STEP_FORMS[form]
    jspec, pspec = _specs(pd, cd, **spec_kw)
    cfg = dict(learning_rate=0.05, reg_factors=1e-4, reg_linear=1e-5,
               reg_bias=1e-6, seed=3, lr_schedule="inv_sqrt", **lever)
    jstep = jax.jit(jsparse.make_field_sparse_sgd_body(
        jspec, jtrain.TrainConfig(**cfg)))
    pstep = sparse.make_field_sparse_sgd_body(pspec, TrainConfig(**cfg))
    jp = _jax_params(jspec)
    pp = _carry(pspec, jp)
    exact = pd == cd == "float32"
    before = segsum.launches
    for i, batch in enumerate(_batches(3)):
        aux = _aux(cfg, batch[0])
        jp, jl = jstep(jp, jnp.int32(i), *map(jnp.asarray, batch),
                       None if aux is None else tuple(map(jnp.asarray, aux)))
        pp, pl = pstep(pp, i, *(torch.from_numpy(a.copy()) for a in batch),
                       None if aux is None else
                       tuple(map(torch.from_numpy, aux)))
        assert abs(float(jl) - float(pl)) < (1e-6 if exact else 1e-3)
        for want, got in zip(_tables(jp), _tables(pp)):
            assert got.dtype == pspec.pdtype
            np.testing.assert_allclose(
                got.double().numpy(), np.asarray(want, np.float64),
                rtol=0, atol=1e-5 if exact else 1e-2)
        assert abs(float(jp["w0"]) - float(pp["w0"])) < (
            1e-5 if exact else 1e-2)
    # On the CPU the wrappers run their plain versions: no launch.
    assert segsum.launches == before


@pytest.mark.parametrize("pd,cd,lever", [
    ("bfloat16", "bfloat16", dict(sparse_update="dedup_sr", host_dedup=True,
                                  compact_cap=CAP, segtotal_pallas=True)),
    ("bfloat16", "float32", dict(sparse_update="dedup_sr", host_dedup=True,
                                 compact_cap=CAP, gfull_fused=True)),
    ("float32", "float32", dict(sparse_update="dedup", host_dedup=True,
                                compact_cap=CAP)),
    ("bfloat16", "bfloat16", dict(sparse_update="dedup_sr",
                                  compact_device=True, compact_cap=CAP)),
])
def test_col_steps_equal_row_steps_bit_for_bit(pd, cd, lever):
    """The same steps from the same values: the col tables equal the row
    tables transposed, bit for bit, and so do the losses."""
    _, rspec = _specs(pd, cd)
    _, cspec = _specs(pd, cd, table_layout="col")
    cfg = TrainConfig(learning_rate=0.05, reg_factors=1e-4, reg_linear=1e-5,
                      reg_bias=1e-6, seed=3, **lever)
    rp = rspec.init(torch.Generator().manual_seed(3), device="cpu")
    cp = {"w0": rp["w0"].clone(),
          "vw": [t.t().contiguous() for t in rp["vw"]]}
    rstep = sparse.make_field_sparse_sgd_body(rspec, cfg)
    cstep = sparse.make_field_sparse_sgd_body(cspec, cfg)
    for i, batch in enumerate(_batches(4, seed=8)):
        aux = _aux(lever, batch[0])
        aux = None if aux is None else tuple(map(torch.from_numpy, aux))
        args = [torch.from_numpy(a.copy()) for a in batch]
        rp, rl = rstep(rp, i, *args, aux)
        cp, cl = cstep(cp, i, *args, aux)
        assert torch.equal(rl, cl)
        assert torch.equal(rp["w0"], cp["w0"])
        for r, c in zip(rp["vw"], cp["vw"]):
            assert torch.equal(r, c.t())


def test_unfused_form_runs_only_with_scatter_add():
    for mode in ("dedup", "dedup_sr"):
        jspec, pspec = _specs(fused_linear=False)
        cfg = dict(sparse_update=mode)
        with pytest.raises(ValueError) as want:
            jsparse.make_field_sparse_sgd_body(jspec,
                                               jtrain.TrainConfig(**cfg))
        with pytest.raises(ValueError) as got:
            sparse.make_field_sparse_sgd_body(pspec, TrainConfig(**cfg))
        assert str(got.value) == str(want.value)


@pytest.mark.parametrize("cfg", [
    dict(sparse_update="dedup"),                         # col needs compact
    dict(sparse_update="dedup", host_dedup=True, compact_cap=CAP,
         use_pallas=True),
    dict(sparse_update="dedup", host_dedup=True, compact_cap=CAP,
         fused_embed="require"),
])
def test_col_guards_raise_the_reference_messages(cfg):
    jspec, pspec = _specs(table_layout="col")
    with pytest.raises(ValueError) as want:
        jsparse.make_field_sparse_sgd_body(jspec, jtrain.TrainConfig(**cfg))
    with pytest.raises(ValueError) as got:
        sparse.make_field_sparse_sgd_body(pspec, TrainConfig(**cfg))
    assert str(got.value) == str(want.value)


def test_split_update_sums_each_id_once():
    """``apply_split_row_updates``: duplicates summed in float32, one add
    per id; an id in [-n, 0) counts from the end, others are dropped."""
    v = torch.zeros(6, 2)
    w = torch.zeros(6)
    ids = torch.tensor([1, 1, -1, 9, 1], dtype=torch.int32)
    delta = torch.tensor([[1., 2., 3.], [1., 2., 3.], [5., 6., 7.],
                          [9., 9., 9.], [1., 2., 3.]])
    scatter.apply_split_row_updates(v, w, ids, delta)
    assert v[1].tolist() == [3., 6.] and w[1] == 9.
    assert v[5].tolist() == [5., 6.] and w[5] == 7.
    # Nothing else is written: id 9 (past the table) is dropped.
    assert float(v.abs().sum() + w.abs().sum()) == 9. + 11. + 16.
