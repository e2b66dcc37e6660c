"""Each plain reference against the program's plain path on the CPU at a
tiny size: the same seed, batches and three steps. A ``correct: false``
on the card then points at the kernels, not at the reference."""

import pytest

from benchmark import compare
from benchmark.drivers import fit_field_sparse as driver
from benchmark.tests.conftest import tiny


@pytest.mark.parametrize("seed", [11, 2 ** 31 + 3])
@pytest.mark.parametrize("name", ["fm3_train_b131k", "ffm4_train_b131k",
                                  "fm3_train_b16k", "ffm4_train_b8k"])
def test_reference_follows_the_programs_plain_path(name, seed, cpu):
    cell = tiny(name, batch=1024)
    found, raw = driver.readings(cell, seed, cpu)
    ok, checks = compare.judge(found, cell["limits"])
    assert ok, checks
    # Same rounding rules, same order: the plain FieldFM path agrees bit
    # for bit; FieldFFM's pair sums run in another order.
    exact = cell["config"]["family"] == "field_fm"
    for k, (value, _) in found.items():
        assert value == 0.0 if exact else value < 1e-4, (k, value)
    assert raw["program"]["loss"][0] > 0.5
