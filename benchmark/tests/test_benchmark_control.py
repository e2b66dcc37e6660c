"""The comparison is shown to fail: the control (the reference computed
one precision below the configuration's compute dtype, in the program's
place) and runs with the step broken underneath come out not correct.
On the CPU at a size a test run holds; the card's test at the cell's own
size runs with ``pytest -m gpu benchmark/tests``."""

import pytest
import torch

from benchmark import calibrate, compare, faults
from benchmark.drivers import fit_field_sparse as driver
from benchmark.tests.conftest import tiny

CELLS = ["fm3_train_b131k", "ffm4_train_b131k", "fm3_train_b16k",
         "ffm4_train_b8k"]
#: The number each fault has to fail: a misplaced write keeps each
#: table's norm of change, and only its projection reads it.
FAILS = {"state": "grad_gap", "half": "grad_gap",
         "misplace": "change_proj_gap"}


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(name, cpu):
    # 2,048 rows: each score's gradient is below fp8's least subnormal, as
    # at the cells' own sizes.
    cell = tiny(name, batch=2048)
    lower = calibrate.LOWER[cell["config"]["compute_dtype"]]
    found, _ = driver.readings(cell, 5, cpu, lower=lower)
    ok, checks = compare.judge(found, cell["limits"])
    assert not ok, checks
    assert checks["grad_gap"]["value"] == 1.0


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_step_comes_out_not_correct(name, kind, cpu):
    cell = tiny(name)
    with faults.planted(kind):
        got = driver.run(cell, 2 ** 31 + 7, 0.3, False, cpu, 0.0,
                         cell["limits"])
    assert not got["correct"], got["checks"]
    failed = [k for k, c in got["checks"].items() if c["value"] > c["limit"]]
    assert FAILS[kind] in failed


def test_faults_are_taken_out_again(cpu):
    cell = tiny("fm3_train_b131k")
    with faults.planted("state"):
        pass
    found, _ = driver.readings(cell, 3, cpu)
    assert compare.judge(found, cell["limits"])[0]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_at_the_cells_own_size_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cell's own size runs on "
                    "the card")
    from benchmark import cells

    cell = cells.load(name)
    lower = calibrate.LOWER[cell["config"]["compute_dtype"]]
    dev = torch.device("cuda", 0)
    for seed in (3_100_000_019, 3_100_007_938, 3_100_015_857):
        found, _ = driver.readings(cell, seed, dev, lower=lower)
        assert not compare.judge(found, cell["limits"])[0], found
