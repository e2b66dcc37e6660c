"""The port's sharded steps (``fm_spark_tpu_torch.parallel``) at world 2,
each rank a spawned process in a gloo group on the CPU, against the JAX
package's sharded steps on a mesh of 2 of the conftest's host devices and
against the port's single-card steps, from the same params and batches
(``torch_parallel_harness.py``): FieldFM on the 1-D ``feat`` mesh (the
per-lane dedup with the reg triple, the host compact aux, the device
compact aux with kernel A's plain version, ``score_sharded``, and
``collective_dtype='bfloat16'``), FieldFFM (per lane and device compact),
FieldDeepFM (replicated and ``deep_sharded`` head, Adam on the head),
``dp`` over ``data`` (the flat FM and FieldFM's generic dense step) and
``row`` over ``feat`` (the flat FM).

Tolerances, and why: after 3 steps every loss and parameter within
``rtol=1e-5, atol=1e-6`` (float32): the all_reduce adds the two ranks'
partial sums where the single card adds field by field, and JAX's psum in
its own order, a few ulps a step; bit for bit is not expected at world 2
(at world 1 the FieldFM step equals the single-card body bit for bit,
``tests/test_torch_parallel_cli.py``). The bf16 wire rounds the score
sums to bf16 once per step: its losses within ``1e-2`` of the single
card's and parameters within ``atol=2e-3``, against JAX's bf16 wire within
``rtol=1e-5, atol=1e-6``.
"""

import pytest

import torch_parallel_harness as h

FM, FFM, DEEP = "FieldFMSpec", "FieldFFMSpec", "FieldDeepFMSpec"
CASES = {
    "fm_dedup": dict(spec=h.field(FM), mesh=["field", 1],
                     config=dict(sparse_update="dedup", **h.REG)),
    "fm_scatter_add": dict(spec=h.field(FM), mesh=["field", 1],
                           config=dict(sparse_update="scatter_add",
                                       **h.REG)),
    "fm_host_compact": dict(spec=h.field(FM), mesh=["field", 1], config=dict(
        sparse_update="dedup", host_dedup=True, compact_cap=h.CAP,
        gfull_fused=True, **h.REG)),
    "fm_device_compact": dict(spec=h.field(FM), mesh=["field", 1], config=dict(
        sparse_update="dedup", compact_device=True, compact_cap=h.CAP,
        segtotal_pallas=True, **h.REG)),
    "fm_score_sharded": dict(spec=h.field(FM), mesh=["field", 1], config=dict(
        sparse_update="dedup", score_sharded=True, **h.REG)),
    "fm_wire_bf16": dict(spec=h.field(FM), mesh=["field", 1], config=dict(
        sparse_update="dedup", collective_dtype="bfloat16", **h.REG)),
    "ffm_dedup": dict(spec=h.field(FFM), mesh=["field", 1],
                      config=dict(sparse_update="dedup", **h.REG)),
    "ffm_device_compact": dict(spec=h.field(FFM), mesh=["field", 1],
                               config=dict(sparse_update="dedup",
                                           compact_device=True,
                                           compact_cap=h.CAP, **h.REG)),
    "deepfm": dict(spec=h.field(DEEP, mlp_dims=[8, 8]), mesh=["field", 1],
                   config=dict(sparse_update="dedup", optimizer="adam",
                               **h.REG)),
    "deepfm_deep_sharded": dict(spec=h.field(DEEP, mlp_dims=[8, 8]),
                                mesh=["field", 1],
                                config=dict(sparse_update="dedup",
                                            optimizer="adam",
                                            deep_sharded=True, **h.REG)),
    "dp_flat_fm": dict(spec=h.FLAT_SPEC, mesh=["dense", 2, 1], strategy="dp",
                       config=dict(**h.REG)),
    "dp_field_fm": dict(spec=h.field(FM), mesh=["dense", 2, 1],
                        strategy="dp", config=dict(optimizer="adam",
                                                   learning_rate=0.05)),
    "row_flat_fm": dict(spec=h.FLAT_SPEC, mesh=["dense", 1, 2],
                        strategy="row", config=dict(**h.REG)),
}
for c in CASES.values():
    c["world"] = 2


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("w2")
    inputs = h.write_cases(d, CASES)
    return inputs, h.spawn(d, 2)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_single_card(run, name):
    inputs, results = run
    single = h.port_single(CASES[name], *inputs[name])
    if name == "fm_wire_bf16":
        h.assert_close(results[name], single, 1e-2, 2e-3, name)
    else:
        h.assert_close(results[name], single, 1e-5, 1e-6, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_matches_jax_sharded(run, name):
    inputs, results = run
    h.assert_close(results[name], h.jax_sharded(CASES[name], *inputs[name]),
                   1e-5, 1e-6, name)
