"""The port's sharded steps at world 4 on the 2-D meshes, each rank a
spawned process in a gloo group on the CPU, against the JAX package's
sharded steps on 4 of the conftest's host devices and against the port's
single-card steps (``torch_parallel_harness.py``): FieldFM, FieldFFM and
FieldDeepFM on the ``(feat, row)`` mesh of 2 × 2 (each field's 16
buckets split over 2 row shards, the ids another shard owns masked and
their writes dropped; per-lane and device-compact aux), and ``row`` on a
``(data, feat)`` mesh of 2 × 2. Tolerances as in
``tests/test_torch_parallel.py`` (float32, ``rtol=1e-5, atol=1e-6``): the
sums over four ranks add in another order than the single card's.
"""

import pytest

import torch_parallel_harness as h

FM, FFM, DEEP = "FieldFMSpec", "FieldFFMSpec", "FieldDeepFMSpec"
CASES = {
    "fm2d_dedup": dict(spec=h.field(FM), mesh=["field", 2],
                       config=dict(sparse_update="dedup", **h.REG)),
    "fm2d_device_compact": dict(spec=h.field(FM), mesh=["field", 2],
                                config=dict(sparse_update="dedup",
                                            compact_device=True,
                                            compact_cap=h.CAP, **h.REG)),
    "fm2d_score_sharded": dict(spec=h.field(FM), mesh=["field", 2],
                               config=dict(sparse_update="dedup",
                                           score_sharded=True, **h.REG)),
    "ffm2d_dedup": dict(spec=h.field(FFM), mesh=["field", 2],
                        config=dict(sparse_update="dedup", **h.REG)),
    "ffm2d_device_compact": dict(spec=h.field(FFM), mesh=["field", 2],
                                 config=dict(sparse_update="dedup",
                                             compact_device=True,
                                             compact_cap=h.CAP, **h.REG)),
    "deepfm2d": dict(spec=h.field(DEEP, mlp_dims=[8, 8]), mesh=["field", 2],
                     config=dict(sparse_update="dedup", optimizer="adam",
                                 **h.REG)),
    "deepfm2d_deep_sharded": dict(spec=h.field(DEEP, mlp_dims=[8, 8]),
                                  mesh=["field", 2],
                                  config=dict(sparse_update="dedup",
                                              optimizer="adam",
                                              deep_sharded=True, **h.REG)),
    "row_2x2": dict(spec=h.FLAT_SPEC, mesh=["dense", 2, 2], strategy="row",
                    config=dict(**h.REG)),
}
for c in CASES.values():
    c["world"] = 4


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    d = tmp_path_factory.mktemp("w4")
    inputs = h.write_cases(d, CASES)
    return inputs, h.spawn(d, 4)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_2d_matches_single_card(run, name):
    inputs, results = run
    h.assert_close(results[name], h.port_single(CASES[name], *inputs[name]),
                   1e-5, 1e-6, name)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_2d_matches_jax_sharded(run, name):
    inputs, results = run
    h.assert_close(results[name], h.jax_sharded(CASES[name], *inputs[name]),
                   1e-5, 1e-6, name)
