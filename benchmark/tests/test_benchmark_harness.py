"""The harness on the CPU: every name in ``BENCHMARK.json`` resolves to
its files, the traffic generator, the roofline counts, the result line,
the refusal without a card, and the modules a run loads."""

import importlib
import json
import math
import os
import re
import shutil
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import cells, roofline, traffic
from benchmark import run as bench_run
from benchmark.tests.conftest import tiny

ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = cells.bench()
CELLS = [w["name"] for w in SPEC["workloads"]]


def test_benchmark_json_keeps_to_its_shapes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    names = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    names += CELLS + [c["name"] for c in SPEC["configs"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] == "host_clock"
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = cells.load(name)
    conf = {c["name"]: c for c in SPEC["configs"]}[
        next(w for w in SPEC["workloads"] if w["name"] == name)["config"]]
    assert conf["file"].startswith("benchmark/configs/")
    assert cell["config"]["reduced"] == conf["reduced"] == []
    importlib.import_module(f"benchmark.drivers.{cell['config']['driver']}")
    importlib.import_module(
        f"benchmark.reference.{cell['config']['family']}")
    roofline.load(f"step_{cell['config']['family']}")
    assert set(cell["limits"]) == {"loss_gap", "grad_gap", "change_gap",
                                   "change_proj_gap"}
    reported = {m["name"] for m in cell["end_to_end"]}
    assert {"setup_s", "train_samples_per_s"} <= reported
    assert cell["per_layer"]
    for m in cell["per_layer"]:
        reader = importlib.import_module(f"benchmark.metrics.{m['name']}")
        assert callable(reader.read)


@pytest.mark.parametrize("kernel", ["fm_bwd", "ffm_sel_scores",
                                    "ffm_sel_bwd"])
def test_every_kernel_count_names_its_symbols(kernel):
    mod = roofline.load(kernel)
    assert mod.FIRST in mod.SYMBOLS


def test_generator_is_deterministic_per_seed(cpu):
    mix = dict(traffic.load("criteo1tb_b131k_cap65536"), pool=2)
    a, ua = traffic.make_pool(mix, 39, 1 << 18, 2 ** 31 + 17, cpu)
    b, ub = traffic.make_pool(mix, 39, 1 << 18, 2 ** 31 + 17, cpu)
    c, _ = traffic.make_pool(mix, 39, 1 << 18, 2 ** 31 + 18, cpu)
    assert all(np.array_equal(x, y) for p, q in zip(a, b)
               for x, y in zip(p, q))
    assert np.array_equal(ua, ub)
    assert not np.array_equal(a[0][0], c[0][0])
    ids, vals, labels, weights = a[0]
    assert ids.shape == (131072, 39) and ids.dtype == np.int32
    assert ids.min() >= 0 and ids.max() < 1 << 18
    assert (vals == 1).all() and (weights == 1).all()
    assert abs(labels.mean() - mix["label_rate"]) < 0.003
    # A field shows no more ids than its vocabulary holds, and a small
    # vocabulary shows whole but for a collision of the hash.
    vocab = np.array([f["vocab"] for f in mix["fields"]])
    small = vocab <= 192
    assert (ua <= vocab).all() and (ua[:, small] >= vocab[small] - 2).all()


MIXES = {"criteo1tb_b131k_cap65536": (39, 1 << 18),
         "criteo1tb_b16k_cap12288": (39, 1 << 18),
         "avazu_b131k": (23, 1 << 14), "avazu_b8k": (23, 1 << 14)}


def test_every_cell_names_a_mix_of_its_configs_fields():
    for name in CELLS:
        cell = cells.load(name)
        fields, bucket = MIXES[cell["traffic"]["name"]]
        assert cell["config"]["num_fields"] == len(
            cell["traffic"]["fields"]) == fields
        assert cell["config"]["bucket"] == bucket


@pytest.mark.parametrize("mix", ["criteo1tb_b131k_cap65536",
                                 "criteo1tb_b16k_cap12288"])
def test_every_field_stays_within_the_cap(mix, cpu):
    m = traffic.load(mix)
    fields, bucket = MIXES[mix]
    _, unique = traffic.make_pool(m, fields, bucket, 2 ** 31 + 99, cpu)
    assert unique.shape == (m["pool"], fields)
    assert unique.max() <= m["compact_cap"]
    # The cap holds with room: the most distinct ids sit well under it.
    assert unique.max() < 0.9 * m["compact_cap"]


def test_generator_refuses_a_pool_past_its_cap(cpu):
    mix = dict(traffic.load("criteo1tb_b16k_cap12288"), pool=1,
               compact_cap=100)
    with pytest.raises(traffic.PoolError, match="compact_cap 100"):
        traffic.make_pool(mix, 39, 1 << 18, 5, cpu)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_each_vocabulary_is_derived_from_the_published_count(mix):
    """A field's vocabulary is the smallest whose Zipf law shows the
    published distinct count in the published rows."""
    m = traffic.load(mix)
    assert m["zipf_a"] == 1.0 and m["rows"] > 10 ** 7
    for f in m["fields"]:
        assert f["vocab"] == traffic.vocab_for(f["distinct"], m["rows"],
                                               m["zipf_a"]), f
        seen = traffic.expected_distinct(f["vocab"], m["rows"], m["zipf_a"])
        assert abs(seen - f["distinct"]) <= max(1.0, 1e-4 * f["distinct"])


def test_expected_distinct_is_the_exact_sum():
    vocab, rows = 300_000, 2e6
    p = np.arange(1, vocab + 1, dtype=np.float64) ** -1.0
    exact = -np.expm1(-rows * p / p.sum()).sum()
    assert traffic.expected_distinct(vocab, rows, 1.0) == pytest.approx(
        exact, rel=1e-6)


@pytest.mark.parametrize("a", [1.0, 1.3])
def test_zipf_ranks_draw_the_zipf_law(a, cpu):
    """Ranks past the exact head, from the integral: each rank band's share
    within five binomial deviations of the exact law."""
    vocab, n = 3 * traffic.HEAD, 4_000_000
    u = torch.rand(n, generator=torch.Generator().manual_seed(0),
                   dtype=torch.float64)
    ranks = traffic.zipf_ranks(u, vocab, a).numpy()
    assert ranks.min() >= 1 and ranks.max() <= vocab
    pmf = np.arange(1, vocab + 1, dtype=np.float64) ** -a
    pmf /= pmf.sum()
    edges = np.array([1, 2, 3, 11, 101, 1001, traffic.HEAD + 1,
                      traffic.HEAD + 2, 2 * traffic.HEAD, vocab + 1])
    want = np.add.reduceat(pmf, edges[:-1] - 1)
    got = np.histogram(ranks, bins=edges)[0] / n
    sd = np.sqrt(want * (1 - want) / n)
    assert np.all(np.abs(got - want) <= 5 * sd), (got, want)


def test_hash_spreads_a_fields_ranks_over_its_buckets(cpu):
    ranks = torch.arange(1, 1 << 20)
    ids = traffic.hash_ids(ranks, 3, 1 << 14)
    assert ids.min() >= 0 and ids.max() < 1 << 14
    counts = torch.bincount(ids, minlength=1 << 14).double()
    # As a random draw spreads: 64 ranks a bucket, a Poisson spread of 1/8.
    assert 0.1 < float(counts.std() / counts.mean()) < 0.15
    assert not torch.equal(ids, traffic.hash_ids(ranks, 4, 1 << 14))
    assert torch.equal(ids[:5], traffic.hash_ids(ranks[:5], 3, 1 << 14))


def test_roofline_counts_by_hand():
    sh = {"batch": 8, "fields": 3, "rank": 2, "width": 3, "store_bytes": 2,
          "compute_bytes": 2, "unique": [4.0, 5.0, 6.0]}
    live = 15
    flops, nbytes = roofline.load("fm_bwd").count(sh)
    assert flops == 6 * 8 * 3 * 3
    assert nbytes == (live * 3 * 2 + 8 * 4 * 2 + 8 * 3 * 4 + 8 * 4
                      + 2 * 3 * 8 * 4 + live * 3 * 4)
    flops, nbytes = roofline.load("step_field_fm").count(sh)
    assert nbytes == 8 * 3 * 8 + 8 * 8 + 2 * live * 3 * 2 + 8
    assert flops == 8 * 3 * (8 * 2 + 4) + 2 * live * 3
    ffm = dict(sh, width=3 * 2 + 1, store_bytes=4)
    slab = 8 * 3 * 3 * 2
    assert roofline.load("ffm_sel_scores").count(ffm) == (
        4.0 * slab, float((slab + 8 * 3 + 8) * 2))
    assert roofline.load("ffm_sel_bwd").count(ffm) == (
        3.0 * slab, float((2 * slab + 8 * 3 + 8) * 2))
    flops, nbytes = roofline.load("step_field_ffm").count(ffm)
    assert nbytes == 8 * 3 * 8 + 8 * 8 + 2 * live * 7 * 4 + 8
    assert flops == 8 * (9 * 2 + 3 * 3 * 2 * 2 + 2 * 3 * 7) + 2 * live * 7


def _event(name, lo, hi, device, thread=1):
    from torch.autograd import DeviceType

    return types.SimpleNamespace(
        name=name, time_range=types.SimpleNamespace(start=lo, end=hi),
        device_type=DeviceType.CUDA if device else DeviceType.CPU,
        thread=thread, is_user_annotation=False)


def test_span_reduces_calls_gaps_and_record_loss():
    from benchmark.trace import Span

    ev = [_event("cudaGraphLaunch", 0, 5, False),
          _event("cudaGraphLaunch", 100, 105, False),
          _event("aten::_local_scalar_dense", 30, 60, False),
          _event("void transpose_vals(float*)", 10, 12, True),
          _event("void bwd_first_pass<bf16>(x)", 12, 20, True),
          _event("Memcpy HtoD (Pinned -> Device)", 19, 21, True),
          _event("void segscan::tile_pass<P>(y)", 21, 24, True),
          _event("void elementwise_kernel<add>", 50, 52, True),
          _event("void transpose_vals(float*)", 110, 111, True),
          _event("void bwd_first_pass<bf16>(x)", 111, 115, True)]
    span = Span(ev, window_s=200e-6)
    assert span.graph_launches == 2
    mod = roofline.load("fm_bwd")
    assert span.calls(mod.SYMBOLS, mod.FIRST) == pytest.approx(
        [13e-6, 5e-6])
    assert span.busy_s() == pytest.approx((14 + 2 + 5) * 1e-6)
    bd = span.breakdown()
    assert bd["device_ops"][0] == ["void bwd_first_pass<bf16>(x)",
                                   pytest.approx(12e-6)]
    assert dict(bd["idle_gaps"]) == {
        "aten::_local_scalar_dense": pytest.approx(26e-6),
        "host python (no op)": pytest.approx(58e-6)}
    assert span.record_loss({"fm_bwd_segment_totals": 1, "sr_bits": 0}) == {
        "fm_bwd_segment_totals": {"seen": 2, "expected": 2}}


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", ["fm3_train_b131k", "ffm4_train_b131k"])
def test_a_run_ends_in_the_result_line(name, trace, cpu):
    from benchmark.drivers import fit_field_sparse as driver

    cell = tiny(name)
    got = driver.run(cell, 2 ** 31 + 5, 0.3, trace, cpu, 0.0, cell["limits"])
    assert got["correct"] and got["failed"] == 0 and got["attempted"] > 0
    line = bench_run.result_line(got, {"platform": "cpu"})
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert set(line["checks"]) == {"loss_gap", "grad_gap", "change_gap",
                                   "change_proj_gap"}
    if trace:
        # No device records on the CPU: the device's readers leave theirs out.
        assert set(line["metrics"]) == {"step_device_ms", "step_mfu"}
    else:
        assert set(line["metrics"]) == {"train_samples_per_s", "setup_s"}
        assert all(math.isfinite(m["value"]) and m["value"] > 0
                   for m in line["metrics"].values())
    json.dumps(line)


def _run(args, cwd):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=120, env=dict(os.environ,
                                                CUDA_VISIBLE_DEVICES=""))


def test_refuses_without_a_card():
    got = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                "--trace", "0"], ROOT)
    assert got.returncode != 0
    assert "no result" in got.stderr and got.stdout.strip() == ""


def test_refuses_in_a_checkout_of_the_benchmark_alone(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
                "--trace", "1"], tmp_path)
    assert got.returncode != 0 and got.stdout.strip() == ""


_CHECK = """
import sys, torch
from benchmark.tests.conftest import tiny
from benchmark.drivers import fit_field_sparse as driver
from benchmark import calibrate, faults, run, trace
from benchmark import metrics, roofline
for m in {metrics!r}:
    metrics.load(m)
for r in {rooflines!r}:
    roofline.load(r)
for name in {cells!r}:
    cell = tiny(name)
    driver.run(cell, 3, 0.2, False, torch.device("cpu"), 0.0, cell["limits"])
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(run.forbidden_modules())
"""


def test_nothing_a_run_loads_is_jax_or_the_jax_package():
    code = _CHECK.format(
        metrics=[m["name"] for m in SPEC["per_layer"]],
        rooflines=["fm_bwd", "ffm_sel_scores", "ffm_sel_bwd",
                   "step_field_fm", "step_field_ffm"],
        cells=["fm3_train_b131k", "ffm4_train_b131k"])
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    tops, bad = (eval(line) for line in got.stdout.strip().splitlines()[-2:])
    # Whole top-level names: the port's own name begins with the JAX
    # package's.
    assert "fm_spark_tpu_torch" in tops
    assert not {"jax", "jaxlib", "flax", "fm_spark_tpu"} & set(tops)
    assert bad == []


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fm_spark_tpu_torch_x",
                        types.ModuleType("x"))
    assert bench_run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("y"))
    assert bench_run.forbidden_modules() == ["jax"]


_REF = """
import sys
from benchmark.tests.conftest import tiny
from benchmark.reference import common, field_fm, field_ffm
from benchmark import traffic
import torch
for name, fam in (("fm3_train_b131k", field_fm),
                  ("ffm4_train_b131k", field_ffm)):
    cell = tiny(name)
    pool, _ = traffic.make_pool(cell["traffic"], 5, 512, 1,
                                torch.device("cpu"))
    common.follow(fam.step, cell["config"], 1, pool[:3])
print(sorted({m.split(".")[0] for m in sys.modules}))
"""


def test_the_reference_imports_nothing_of_the_program():
    got = subprocess.run([sys.executable, "-c", _REF], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert got.returncode == 0, got.stderr[-3000:]
    tops = eval(got.stdout.strip().splitlines()[-1])
    assert not {"fm_spark_tpu_torch", "fm_spark_tpu", "jax"} & set(tops)
