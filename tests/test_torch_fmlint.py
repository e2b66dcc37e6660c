"""The port's fmlint (``fm_spark_tpu_torch/analysis``,
``python -m fm_spark_tpu_torch.tools.fmlint``) against the reference's.

- Every rule the two passes share fires on the reference's positive
  fixture (``tests/test_fmlint.py``), rewritten to the port's paths, on
  the same lines as the reference's rule on the original, and stays quiet
  on the rewritten negative fixture; the Pallas rule's counterpart,
  ``kernel-fallback``, on the same fixtures made kernel wrappers.
- The three ``torch-*`` rules fire on their PyTorch spellings.
- Suppressions, the baseline and the report behave as the reference's on
  the same trees.
- Every port rule has a firing fixture, and the shipped port has no
  unbaselined finding (no ``torch-capture-side-effect`` or
  ``durable-write-discipline`` baselined).
"""

import importlib.util
import json
import os
import sys
import textwrap

import pytest

from fm_spark_tpu_torch.tools import fmlint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

port = fmlint.load_analysis()
pcore = port.core


def _load_reference_tests():
    spec = importlib.util.spec_from_file_location(
        "_reference_test_fmlint", os.path.join(REPO, "tests",
                                               "test_fmlint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _load_reference_tests()
rcore = REF.core

#: Rules both passes carry under one id.
SHARED = ("bare-print", "durable-write-discipline", "eventlog-only",
          "fleet-transport-discipline", "parse-error", "registry-coverage",
          "suppression-hygiene", "thread-lifecycle",
          "thread-lock-discipline", "trace-propagation",
          "wallclock-duration")

#: Appended to a rewritten Pallas fixture: the import that makes a
#: module under ops/ a kernel wrapper (at the end, so lines stay put).
_KERNEL_IMPORT = "from fm_spark_tpu_torch.kernels import build\n"


def write_tree(root, files: dict):
    for rel, src in files.items():
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(textwrap.dedent(src))
    return str(root)


def _to_port(files: dict, kernel: bool = False) -> dict:
    """A reference fixture at the port's paths: the package directory,
    ``tests/test_x.py`` -> ``tests/test_torch_x.py``, and (``kernel``)
    each ops/ module made a kernel wrapper."""
    out = {}
    for rel, src in files.items():
        rel = rel.replace("fm_spark_tpu/", "fm_spark_tpu_torch/")
        if rel.startswith("tests/test_"):
            rel = "tests/test_torch_" + rel[len("tests/test_"):]
        src = textwrap.dedent(src).replace("fm_spark_tpu.",
                                           "fm_spark_tpu_torch.")
        if kernel and "/ops/pallas_" in rel:
            src += _KERNEL_IMPORT
        out[rel] = src
    return out


def _run(core, root, rule_id):
    return core.run_rules(core.Context(str(root)), rules=[rule_id])


def _lines(found):
    return sorted((f.line, f.rule) for f in found)


# ---------------------------------------------------- shared rules, parity

@pytest.mark.parametrize("rule_id", SHARED)
@pytest.mark.parametrize("side", ["positive", "negative"])
def test_shared_rule_matches_reference_on_its_fixture(rule_id, side,
                                                      tmp_path):
    fx = REF.FIXTURES[rule_id]
    ref_root, port_root = tmp_path / "ref", tmp_path / "port"
    write_tree(ref_root, fx[side])
    write_tree(port_root, _to_port(fx[side]))
    want, _ = _run(rcore, ref_root, rule_id)
    got, _ = _run(pcore, port_root, rule_id)
    assert _lines(got) == _lines(want), [f.render() for f in got]
    assert len(got) == (fx["expect"] if side == "positive" else 0)
    assert all(f.path.startswith(("fm_spark_tpu_torch/", "tests/"))
               for f in got)


@pytest.mark.parametrize("side", ["positive", "negative"])
def test_kernel_fallback_matches_pallas_fallback(side, tmp_path):
    """The Pallas rule's fixtures, their ops/pallas_* modules made kernel
    wrappers, fire ``kernel-fallback`` on the reference's lines."""
    fx = REF.FIXTURES["pallas-fallback"]
    write_tree(tmp_path / "ref", fx[side])
    write_tree(tmp_path / "port", _to_port(fx[side], kernel=True))
    want, _ = _run(rcore, tmp_path / "ref", "pallas-fallback")
    got, _ = _run(pcore, tmp_path / "port", "kernel-fallback")
    assert [f.line for f in got] == [f.line for f in want]
    assert all(f.rule == "kernel-fallback" for f in got)


def test_kernel_fallback_scopes_to_kernel_wrappers(tmp_path):
    """A module of ops/ that does not import the kernel build is no
    kernel wrapper: its asserts and ValueErrors stay legal."""
    write_tree(tmp_path, _to_port(
        REF.FIXTURES["pallas-fallback"]["positive"], kernel=False))
    got, _ = _run(pcore, tmp_path, "kernel-fallback")
    assert got == []


@pytest.mark.parametrize("side", ["positive", "negative"])
def test_leg_provenance_scans_the_ports_benchmark_only(side, tmp_path):
    """The reference's fixture as the port's benchmark script fires on
    its lines; the JAX package's ``bench.py`` is never scanned, and with
    no port benchmark the rule reports nothing."""
    fx = REF.FIXTURES["leg-provenance"]
    write_tree(tmp_path / "ref", fx[side])
    write_tree(tmp_path / "port", {"bench_torch.py": fx[side]["bench.py"]})
    want, _ = _run(rcore, tmp_path / "ref", "leg-provenance")
    got, _ = _run(pcore, tmp_path / "port", "leg-provenance")
    assert _lines(got) == _lines(want)
    assert [f.path for f in got] == ["bench_torch.py"] * len(want)
    # The reference's bench.py alone: nothing for the port to scan.
    only_ref, _ = _run(pcore, tmp_path / "ref", "leg-provenance")
    assert only_ref == []


def test_leg_provenance_silent_on_the_shipped_repo():
    got, _ = _run(pcore, REPO, "leg-provenance")
    assert got == []


# ------------------------------------------------------ the torch-* rules

TORCH_FIXTURES = {
    "torch-host-sync": {
        # Only HOT_FILES are scanned — the fixture plants a fake train.py;
        # the same code in another module is the negative.
        "positive": {"fm_spark_tpu_torch/train.py": """\
            import numpy as np
            import torch
            def fit(step, batches, ev):
                for b in batches:
                    out = step(b)
                    loss = out['loss'].item()
                    g = out['grad'].cpu()
                    h = out['hist'].tolist()
                    arr = np.asarray(out['w'])
                    f = float(out['loss'])
                    n = int(out['n'][0])
                    torch.cuda.synchronize()
                    ev.synchronize()
                    x = out['x'].numpy()
                return loss, g, h, arr, f, n, x
        """},
        "negative": {
            "fm_spark_tpu_torch/train.py": """\
                import torch
                def fit(step, batches):
                    for b in batches:
                        out = step(torch.as_tensor(b))  # no host read
                        n = float(1)
                    return {k: v.item() for k, v in out.items()}, n
            """,
            "fm_spark_tpu_torch/report.py": """\
                def summarize(rows):
                    for r in rows:
                        x = r['v'].item()
                    return x
            """,
        },
        "expect": 9,
    },
    "torch-capture-side-effect": {
        "positive": {"fm_spark_tpu_torch/sparse.py": """\
            import torch
            from fm_spark_tpu_torch import graphs, obs
            def make_step(body, journal):
                def run(params, step, ids):
                    print('capturing')
                    obs.counter('steps').add(1)
                    journal.emit('step')
                    u = torch.unique(ids)
                    nz = ids.nonzero()
                    lr = torch.tensor([0.1])
                    s = float(params['w0'])
                    return body(params, step, ids, u, nz, lr, s)
                return graphs.CapturedStep(run)
            def replay(g, fn, x):
                with torch.cuda.graph(g):
                    y = fn(x)
                    n = y.sum().item()
                return y, n
        """},
        "negative": {"fm_spark_tpu_torch/sparse.py": """\
            import torch
            from fm_spark_tpu_torch import graphs, obs
            def make_step(body):
                def run(params, step, ids):
                    return body(params, step, ids)
                captured = graphs.CapturedStep(run)
                def run(params):
                    print('an eager helper of the same name, never '
                          'captured')
                    return params
                return captured, run
            def outer(g, fn, x):
                obs.counter('replays').add(1)    # outside the capture
                with torch.cuda.graph(g):
                    y = fn(x)
                return y, y.sum().item()
        """},
        "expect": 8,
    },
    "torch-unfenced-timing": {
        "positive": {"fm_spark_tpu_torch/train.py": """\
            import time
            def fit(step_fn, batches):
                for b in batches:
                    t0 = time.perf_counter()
                    out = step_fn(b)
                    dt = time.perf_counter() - t0
                return out, dt
        """},
        "negative": {"fm_spark_tpu_torch/train.py": """\
            import time
            import torch
            def fit(step_fn, batches, start, end):
                for b in batches:
                    t0 = time.perf_counter()
                    out = step_fn(b)
                    torch.cuda.synchronize()
                    dt = time.perf_counter() - t0
                for b in batches:
                    t0 = time.perf_counter()
                    out = step_fn(b)
                    ms = start.elapsed_time(end)
                    dt = time.perf_counter() - t0
                return out, dt, ms
        """},
        "expect": 1,
    },
}


@pytest.mark.parametrize("rule_id", sorted(TORCH_FIXTURES))
def test_torch_rule_fires_on_positive_fixture(rule_id, tmp_path):
    fx = TORCH_FIXTURES[rule_id]
    write_tree(tmp_path, fx["positive"])
    found, _ = _run(pcore, tmp_path, rule_id)
    assert len(found) == fx["expect"], [f.render() for f in found]
    assert all(f.rule == rule_id for f in found)


@pytest.mark.parametrize("rule_id", sorted(TORCH_FIXTURES))
def test_torch_rule_quiet_on_negative_fixture(rule_id, tmp_path):
    write_tree(tmp_path, TORCH_FIXTURES[rule_id]["negative"])
    found, _ = _run(pcore, tmp_path, rule_id)
    assert found == [], [f.render() for f in found]


def test_every_port_rule_has_a_firing_fixture():
    """A rule with no positive fixture is a rule whose detection can rot
    silently: the shared rules' fixtures are the reference's, the others
    are this file's."""
    covered = (set(SHARED) | set(TORCH_FIXTURES)
               | {"kernel-fallback", "leg-provenance"})
    assert covered == {r.id for r in port.all_rules()}
    assert not any(r.id.startswith("jax-") for r in port.all_rules())
    for r in port.all_rules():
        assert r.doc, f"rule {r.id} has no glossary doc"


# --------------------------- suppressions, baseline, report: as the ref's

_SIDES = {"ref": (rcore, "fm_spark_tpu"), "port": (pcore,
                                                  "fm_spark_tpu_torch")}


@pytest.mark.parametrize("side", sorted(_SIDES))
def test_suppression_semantics(side, tmp_path):
    core, pkg = _SIDES[side]
    cases = {
        # reasoned: suppressed and recorded with its reason
        "a": ("def f():\n    print('x')  # fmlint: disable=bare-print -- "
              "narration is the contract here\n",
              ["bare-print", "suppression-hygiene"], [], 1),
        # bare: suppresses nothing and is itself a finding
        "b": ("def f():\n    print('x')  # fmlint: disable=bare-print\n",
              ["bare-print", "suppression-hygiene"],
              ["bare-print", "suppression-hygiene"], 0),
        # the wrong rule named: the finding stays
        "c": ("import time\ndef f(t0):\n    return time.time() - t0  "
              "# fmlint: disable=bare-print -- wrong rule named\n",
              ["wallclock-duration"], ["wallclock-duration"], 0),
        # suppression-hygiene is never suppressible
        "d": ("x = 1  # fmlint: disable=suppression-hygiene,no-such -- "
              "sneaky\n", ["suppression-hygiene"],
              ["suppression-hygiene"], 0),
    }
    for name, (src, rules, want_active, want_sup) in cases.items():
        root = tmp_path / name
        write_tree(root, {f"{pkg}/m.py": src})
        found, suppressed = core.run_rules(core.Context(str(root)),
                                           rules=rules)
        assert sorted(f.rule for f in found) == want_active, name
        assert len(suppressed) == want_sup, name
        if want_sup:
            assert "narration" in suppressed[0][1]


@pytest.mark.parametrize("side", sorted(_SIDES))
def test_baseline_round_trip_and_burn_down(side, tmp_path):
    core, pkg = _SIDES[side]
    repo = write_tree(tmp_path, {f"{pkg}/m.py": "def f():\n    print('x')\n"})
    bl = str(tmp_path / "baseline.json")
    rules = ["bare-print"]
    rep = core.analyze(repo, baseline_path=bl, rules=rules)
    assert not rep["ok"] and len(rep["new"]) == 1
    findings, _ = core.run_rules(core.Context(repo), rules=rules)
    core.write_baseline(bl, findings)
    assert json.load(open(bl))["counts"]["bare-print"][f"{pkg}/m.py"] == 1
    rep = core.analyze(repo, baseline_path=bl, rules=rules)
    assert rep["ok"] and rep["baselined_total"] == 1
    (tmp_path / pkg / "m.py").write_text(
        "def f():\n    print('x')\n    print('y')\n")
    rep = core.analyze(repo, baseline_path=bl, rules=rules)
    assert not rep["ok"] and len(rep["new"]) == 2
    (tmp_path / pkg / "m.py").write_text("def f():\n    return 1\n")
    rep = core.analyze(repo, baseline_path=bl, rules=rules)
    assert rep["ok"] and rep["burned_down"] == [{
        "rule": "bare-print", "path": f"{pkg}/m.py", "baseline": 1,
        "current": 0}]
    assert core.load_baseline(str(tmp_path / "nope.json")) == {}
    # A baseline of another file's debt hides nothing here.
    json.dump({"version": 1, "counts": {"bare-print": {
        f"{pkg}/other.py": 3}}}, open(bl, "w"))
    (tmp_path / pkg / "m.py").write_text("def f():\n    print('x')\n")
    rep = core.analyze(repo, baseline_path=bl, rules=rules)
    assert not rep["ok"] and len(rep["new"]) == 1


@pytest.mark.parametrize("side", sorted(_SIDES))
def test_report_shape_and_write(side, tmp_path):
    core, pkg = _SIDES[side]
    repo = write_tree(tmp_path, {f"{pkg}/m.py": "def f():\n    print('x')\n"})
    rep = core.analyze(repo, rules=["bare-print"], run_id="r-test")
    assert rep["tool"] == "fmlint" and rep["run_id"] == "r-test"
    assert rep["counts"] == {"bare-print": {f"{pkg}/m.py": 1}}
    assert "bare-print" in rep["rules"]
    out = core.write_report(rep, str(tmp_path / "obs" / "r-test"))
    assert os.path.basename(out) == "fmlint.json"
    loaded = json.load(open(out))
    assert loaded["total_findings"] == 1 and not loaded["ok"]


def test_port_scope_is_the_port(tmp_path):
    """The port's Context scans ``fm_spark_tpu_torch/``, the root
    ``chip_smoke.py`` (no other root script) and ``tests/test_torch_*``."""
    write_tree(tmp_path, {
        "fm_spark_tpu_torch/a.py": "x = 1\n",
        "fm_spark_tpu/b.py": "y = 2\n",
        "chip_smoke.py": "z = 3\n",
        "bench.py": "w = 4\n",
        "tests/test_torch_a.py": "ANCHOR_PORT = 1\n",
        "tests/test_b.py": "ANCHOR_REF = 1\n",
    })
    ctx = pcore.Context(str(tmp_path))
    assert [f.rel for f in ctx.package_files()] == ["fm_spark_tpu_torch/a.py"]
    assert [f.rel for f in ctx.root_files()] == ["chip_smoke.py"]
    assert "ANCHOR_PORT" in ctx.tests_blob()
    assert "ANCHOR_REF" not in ctx.tests_blob()
    assert pcore.BASELINE_FILE == "fmlint_baseline_torch.json"


# ------------------------------------------------------ the shipped tree

def test_shipped_port_has_zero_unbaselined_findings():
    rep = pcore.analyze(REPO)
    lines = "\n".join(f"{f['path']}:{f['line']} {f['rule']}: "
                      f"{f['message']}" for f in rep["new"])
    assert rep["ok"], f"unbaselined fmlint findings:\n{lines}"
    for s in rep["suppressed"]:
        assert s["reason"].strip()
        assert s["path"].startswith("fm_spark_tpu_torch/")
    baseline = pcore.load_baseline(os.path.join(REPO, pcore.BASELINE_FILE))
    assert "torch-capture-side-effect" not in baseline
    # The checkpoint's step directory publishes through the durable seam:
    # no raw durable write is tolerated anywhere.
    assert "durable-write-discipline" not in baseline
    # A capture hazard is a fault, never a suppression either.
    assert not [s for s in rep["suppressed"]
                if s["rule"] == "torch-capture-side-effect"]


def test_chip_smoke_names_no_port_only_rule():
    """The reference's pass scans the root scripts too: a disable naming
    a port-only rule there would be its unknown-rule finding."""
    with open(os.path.join(REPO, "chip_smoke.py")) as f:
        assert "fmlint: disable" not in f.read()


# ---------------------------------------------------------------- CLI

def test_cli_clean_on_shipped_repo(tmp_path, capsys):
    assert fmlint.main(["--out", str(tmp_path)]) == 0
    rep = json.load(open(tmp_path / "fmlint.json"))
    assert rep["ok"] and rep["new"] == []
    assert rep["run_id"].startswith("fmlint-")
    assert rep["baseline_path"].endswith("fmlint_baseline_torch.json")


def test_cli_list_rules_and_usage_error(capsys):
    assert fmlint.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for r in port.all_rules():
        assert r.id in out
    assert fmlint.main(["--rules", "no-such-rule"]) == 2


def test_cli_catches_seeded_violations(tmp_path, capsys):
    """A seeded thread-safety violation and a seeded host sync in a step
    loop fail the CLI (exit 1), each named on stderr."""
    repo = write_tree(tmp_path / "t", _to_port(
        REF.FIXTURES["thread-lock-discipline"]["positive"]))
    assert fmlint.main(["--repo", repo, "--rules",
                        "thread-lock-discipline", "--no-report"]) == 1
    err = capsys.readouterr().err
    assert "thread-lock-discipline" in err and "_count" in err
    repo = write_tree(tmp_path / "h",
                      TORCH_FIXTURES["torch-host-sync"]["positive"])
    assert fmlint.main(["--repo", repo, "--rules",
                        "torch-host-sync,torch-unfenced-timing",
                        "--no-report"]) == 1
    assert "torch-host-sync" in capsys.readouterr().err


def test_cli_write_baseline_merges_and_report_layout(tmp_path, capsys):
    repo = write_tree(tmp_path, {"fm_spark_tpu_torch/m.py":
                                 "def f():\n    print('x')\n"})
    bl = str(tmp_path / "fmlint_baseline_torch.json")
    json.dump({"version": 1, "counts": {
        "torch-host-sync": {"fm_spark_tpu_torch/train.py": 4}}},
        open(bl, "w"))
    assert fmlint.main(["--repo", repo, "--rules", "bare-print",
                        "--baseline", bl, "--no-report"]) == 1
    assert fmlint.main(["--repo", repo, "--rules", "bare-print",
                        "--baseline", bl, "--write-baseline"]) == 0
    counts = json.load(open(bl))["counts"]
    assert counts == {"torch-host-sync": {"fm_spark_tpu_torch/train.py": 4},
                      "bare-print": {"fm_spark_tpu_torch/m.py": 1}}
    capsys.readouterr()
    assert fmlint.main(["--repo", repo, "--rules", "bare-print",
                        "--baseline", bl, "--no-report"]) == 0
    assert "1 baselined" in capsys.readouterr().err
    # The default report path: artifacts/obs/<run_id>/fmlint.json of the
    # scanned repo.
    assert fmlint.main(["--repo", repo, "--rules", "bare-print",
                        "--baseline", bl, "--run-id", "r-fmlint-test"]) == 0
    path = tmp_path / "artifacts" / "obs" / "r-fmlint-test" / "fmlint.json"
    assert json.load(open(path))["run_id"] == "r-fmlint-test"


def test_analysis_loads_without_torch(tmp_path):
    """The pass is stdlib-only: loaded by path, it imports no torch."""
    import subprocess

    code = (
        "import sys, importlib.util\n"
        "sys.modules['torch'] = None\n"
        f"d = {os.path.join(REPO, 'fm_spark_tpu_torch', 'analysis')!r}\n"
        "spec = importlib.util.spec_from_file_location('a', d + "
        "'/__init__.py', submodule_search_locations=[d])\n"
        "m = importlib.util.module_from_spec(spec)\n"
        "sys.modules['a'] = m\n"
        "spec.loader.exec_module(m)\n"
        f"rep = m.analyze({REPO!r})\n"
        "print(rep['ok'], len(m.all_rules()))\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split()[0] == "True"


def test_resilience_lint_shim_delegates():
    from fm_spark_tpu_torch.tools import resilience_lint as rl

    assert rl.violations() == []
    assert rl.library_print_violations() == []
    assert rl.kernel_fallback_violations() == []
    assert rl.duration_time_violations() == []
    assert rl.bench_leg_record_violations() == []
    assert rl.fault_point_coverage_violations() == []
    assert rl.watchdog_phase_coverage_violations() == []
    assert rl.introspect_trigger_coverage_violations() == []
    assert rl.LIBRARY_DIR.endswith("fm_spark_tpu_torch")
    with pytest.raises(TypeError, match="no longer honors"):
        rl.violations(root="/elsewhere")
    assert rl.main() == 0
