"""The port's lever registry (``fm_spark_tpu_torch/cli_levers.py``),
``measured.py``, ``tools/hash_audit.py`` and ``tools/build_native.py``
against the reference's:

- the ``_LEVERS`` rows equal the reference's by flag, field, kind and
  choices; each guard gives the reference's message on the same config;
  the ``fmtorch train`` parser's lever args keep their dest, default and
  choices; ``fmtorch train`` refuses and accepts what it did, with the
  same messages;
- ``measured`` raises the reference's errors on the same malformed files
  (the file's own name in the message), and round-trips;
- ``hash_audit`` gives the reference's rows on the same arguments;
- ``build_native --check`` passes (skipped, named, without ``g++``).
"""

import importlib.util
import json
import os
import shutil
import sys

import pytest

from fm_spark_tpu import cli as rcli
from fm_spark_tpu import cli_levers as rlevers
from fm_spark_tpu import configs as rconfigs
from fm_spark_tpu import measured as rmeasured
from fm_spark_tpu_torch import cli, cli_levers, configs, measured, native
from fm_spark_tpu_torch.tools import build_native, hash_audit

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

FAMILIES = ("criteo1tb_fm_r64", "avazu_ffm_r16", "criteo1tb_deepfm")


def _row(lv):
    return (lv.flag, lv.field, lv.kind, tuple(lv.choices))


# ------------------------------------------------------------------ rows

def test_lever_rows_equal_the_references():
    assert [_row(lv) for lv in cli_levers._LEVERS] == \
        [_row(lv) for lv in rlevers._LEVERS]
    for mine, ref in zip(cli_levers._LEVERS, rlevers._LEVERS):
        assert (mine.validate is None) == (ref.validate is None), mine.flag
        assert (mine.validate_any is None) == (ref.validate_any is None)
        assert mine.help


def _configs(name, **kw):
    """The port's and the reference's TrainConfig of one config."""
    return (configs.get_config(name).train_config(**kw),
            rconfigs.get_config(name).train_config(**kw))


_TRIGGERS = {"collective_dtype": "bfloat16", "score_sharded": True,
             "deep_sharded": True, "sel_blocked": True,
             "embed_tier": "require", "fused_embed": "require"}


@pytest.mark.parametrize("field", sorted(_TRIGGERS))
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("sharded,n", [(False, 1), (True, 1), (True, 4)])
def test_each_guard_gives_the_references_message(field, family, sharded, n):
    mine = {lv.field: lv for lv in cli_levers._LEVERS}[field]
    ref = {lv.field: lv for lv in rlevers._LEVERS}[field]
    pspec = configs.get_config(family).spec()
    rspec = rconfigs.get_config(family).spec()
    assert type(pspec).__name__ == type(rspec).__name__
    pctx = dict(spec=pspec, cap=cli_levers.field_caps(pspec), n=n, pc=1,
                sharded=sharded, row_shards=1)
    rctx = dict(spec=rspec, cap=rcli._FIELD_CAPS[type(rspec).__name__],
                n=n, pc=1, sharded=sharded, row_shards=1)
    for value in (_TRIGGERS[field], None):
        kw = {} if value is None else {field: value}
        ptc, rtc = _configs(family, **kw)
        assert mine.validate(ptc, pctx) == ref.validate(rtc, rctx), kw


@pytest.mark.parametrize("kw", [
    {"compact_overflow": "drop"}, {"compact_overflow": "split"},
    {"compact_overflow": "drop", "compact_cap": 64},
    {"hot_rows": 512}, {"embed_tier": "auto", "hot_rows": 500,
                        "embed_bucket_rows": 64},
    {"embed_tier": "auto", "hot_rows": 512, "embed_bucket_rows": 64},
    {}])
def test_strategy_independent_guards_match(kw):
    ptc, rtc = _configs("criteo1tb_fm_r64", **kw)
    assert cli_levers.check_levers_any(ptc) == rlevers.check_levers_any(rtc)


def test_field_caps_mirror_the_references_table():
    for family in FAMILIES:
        spec = configs.get_config(family).spec()
        ref = rcli._FIELD_CAPS[type(spec).__name__]
        mine = cli_levers.field_caps(spec)
        assert (mine.sharded_score, mine.sharded_deep) == \
            (ref.sharded_score, ref.sharded_deep)


def _train_actions():
    parser = cli.build_parser()
    sub = next(a for a in parser._actions
               if a.__class__.__name__ == "_SubParsersAction")
    return {a.dest: a for a in sub.choices["train"]._actions}


def test_train_parser_lever_args_keep_dest_default_and_choices():
    acts = _train_actions()
    want = {
        "host_dedup": (None, None, 0), "compact_cap": (None, None, None),
        "compact_device": (None, None, 0),
        "compact_overflow": (None, ["error", "drop", "split"], None),
        "collective_dtype": (None, ["float32", "bfloat16"], None),
        "score_sharded": (None, None, 0), "deep_sharded": (None, None, 0),
        "gfull_fused": (None, None, 0), "sel_blocked": (None, None, 0),
        "segtotal_pallas": (None, None, 0),
        "fused_embed": (None, ["off", "auto", "require"], None),
        "embed_tier": (None, ["off", "auto", "require"], None),
        "hot_rows": (None, None, None), "embed_bucket_rows": (None, None,
                                                              None)}
    for dest, (default, choices, nargs) in want.items():
        a = acts[dest]
        assert (a.default, a.choices, a.nargs) == (default, choices, nargs)
        assert a.option_strings == [
            {lv.field: lv.flag for lv in cli_levers._LEVERS}[dest]]
    assert acts["compact_cap"].type is int and acts["hot_rows"].type is int
    # The non-lever flags the dense step refuses keep theirs.
    assert acts["use_pallas"].default is False
    assert acts["sparse_update"].choices == ["scatter_add", "dedup",
                                             "dedup_sr"]


def test_lever_overrides_leave_unset_flags_to_the_config():
    args = cli.build_parser().parse_args(
        ["train", "--config", "criteo1tb_fm_r64", "--steps", "1",
         "--host-dedup", "--compact-cap", "64"])
    ov = cli_levers._lever_overrides(args)
    assert ov["host_dedup"] is True and ov["compact_cap"] == 64
    assert all(ov[k] is None for k in ov if k not in ("host_dedup",
                                                      "compact_cap"))
    assert set(ov) == {lv.field for lv in rlevers._LEVERS}


def test_field_only_levers_keep_their_order_and_flags():
    assert cli_levers.field_only_levers() == (
        ("host_dedup", "--host-dedup"), ("compact_device", "--compact-device"),
        ("compact_cap", "--compact-cap"),
        ("segtotal_pallas", "--segtotal-pallas"),
        ("gfull_fused", "--gfull-fused"), ("sel_blocked", "--sel-blocked"),
        ("use_pallas", "--use-pallas"), ("sparse_update", "--sparse-update"),
        ("compact_overflow", "--compact-overflow"))


# ------------------------------------------------ fmtorch train, refusals

_C3 = ["train", "--config", "criteo1tb_fm_r64", "--bucket", "16",
       "--synthetic", "600", "--batch-size", "128", "--steps", "1",
       "--device", "cpu", "--obs-dir", "none", "--test-fraction", "0"]
_C1 = ["train", "--config", "movielens_fm_r8", "--synthetic", "600",
       "--batch-size", "128", "--steps", "1", "--device", "cpu",
       "--obs-dir", "none"]


@pytest.mark.parametrize("argv,msg", [
    (_C3 + ["--compact-overflow", "drop"],
     "--compact-overflow drop has no effect without --compact-cap"),
    (_C1 + ["--hot-rows", "256"],
     "--hot-rows has no effect without --embed-tier auto|require"),
    (_C1 + ["--embed-tier", "auto", "--hot-rows", "300",
            "--embed-bucket-rows", "64"],
     "--hot-rows 300 must be a multiple of --embed-bucket-rows 64 (the hot "
     "tier is managed in whole buckets)"),
    (_C3 + ["--sel-blocked"],
     "--sel-blocked is the single-chip FieldFFM body's lever (it blocks the "
     "[B, F, F, k] sel tensor; found 1 device(s), FieldFMSpec)"),
    (_C1 + ["--host-dedup"],
     "--host-dedup requires strategy 'field_sparse' (config "
     "'movielens_fm_r8' resolves to 'single')"),
    (_C1 + ["--segtotal-pallas"],
     "--segtotal-pallas requires strategy 'field_sparse' (config "
     "'movielens_fm_r8' resolves to 'single')"),
    (_C3 + ["--collective-dtype", "bfloat16"],
     "--collective-dtype bfloat16 is a wire-precision knob for multi-device "
     "runs (found 1 device(s))"),
    (_C3 + ["--score-sharded"],
     "--score-sharded needs multiple devices and a model family with the "
     "example-sharded score path (found 1 device(s), FieldFMSpec)"),
    (_C3 + ["--deep-sharded"],
     "--deep-sharded needs multiple devices and a model family with an "
     "example-sharded deep head (found 1 device(s), FieldFMSpec)"),
])
def test_train_refuses_with_the_references_message(argv, msg, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    with pytest.raises(SystemExit) as ei:
        cli.main(argv)
    assert str(ei.value) == msg


def test_train_accepts_the_lever_recipe(monkeypatch, capsys):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    assert cli.main(_C3 + ["--sparse-update", "dedup_sr", "--host-dedup",
                           "--compact-cap", "128", "--compact-overflow",
                           "split", "--fused-embed", "auto"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    assert any("loss" in x for x in lines)


# --------------------------------------------------------------- measured

def _write(path, doc):
    with open(path, "w") as f:
        if isinstance(doc, str):
            f.write(doc)
        else:
            json.dump(doc, f)


_E = {"rate_samples_per_sec_per_chip": 1.0, "source": "s", "date": "d"}

_MALFORMED = {
    "missing_entry": {"headline": _E},
    "unknown_entry": {"headline": _E, "ffm_avazu": _E, "mystery": _E},
    "missing_field": {"headline": {"rate_samples_per_sec_per_chip": 1.0,
                                   "source": "s"}, "ffm_avazu": _E},
    "bad_rate": {"headline": dict(_E, rate_samples_per_sec_per_chip=0),
                 "ffm_avazu": _E},
    "string_rate": {"headline": dict(_E, rate_samples_per_sec_per_chip="1"),
                    "ffm_avazu": _E},
    "truncated": "{truncated",
}


@pytest.mark.parametrize("case", sorted(_MALFORMED))
def test_measured_raises_the_references_errors(case, tmp_path):
    mine, ref = str(tmp_path / "m.json"), str(tmp_path / "r.json")
    _write(mine, _MALFORMED[case])
    _write(ref, _MALFORMED[case])
    with pytest.raises(ValueError) as got:
        measured.load_measured(mine)
    with pytest.raises(ValueError) as want:
        rmeasured.load_measured(ref)
    assert type(got.value) is type(want.value)
    assert str(got.value).replace("MEASURED_torch.json", "MEASURED.json") \
        == str(want.value)


def test_measured_fails_loudly_on_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        measured.load_measured(str(tmp_path / "nope.json"))
    with pytest.raises(ValueError, match="unknown MEASURED_torch.json entry"):
        measured.update_entry("mystery", 1.0, "v", "s", "a", "d",
                              path=str(tmp_path / "x.json"))


def test_measured_round_trips_as_the_references(tmp_path):
    docs = []
    for mod, name in ((measured, "m.json"), (rmeasured, "r.json")):
        p = str(tmp_path / name)
        _write(p, {"ffm_avazu": _E})
        mod.update_headline(rate=123.0, vs_baseline=0.5, variant="v",
                            source="test", attachment="NVIDIA H100",
                            date="2026-10-18", path=p)
        mod.update_entry("serving", 7.0, "sv", "s", "a", "2026-10-18",
                         path=p)
        docs.append(mod.load_measured(p))
    assert docs[0] == docs[1]
    assert docs[0]["headline"]["attachment"] == "NVIDIA H100"
    # A corrupt file is never rewritten.
    p = str(tmp_path / "c.json")
    _write(p, "{truncated")
    with pytest.raises(ValueError):
        measured.update_headline(rate=1.0, vs_baseline=None, variant="v",
                                 source="s", attachment="a", date="d", path=p)
    assert open(p).read() == "{truncated"


def test_measured_is_the_ports_own_file():
    assert measured.MEASURED_PATH == os.path.join(REPO, "MEASURED_torch.json")
    with open(measured.__file__) as f:
        src = f.read()
    assert '"MEASURED.json"' not in src


# ------------------------------------------------------------- hash_audit

def _load_ref_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hash_audit_gives_the_references_rows(capsys):
    ref = _load_ref_tool("hash_audit")
    argv = ["--tokens", "20000", "--decades", "1000000,10000000",
            "--seed", "3", "--max-ratio", "1.5"]
    assert hash_audit.main(argv) == ref.main(argv)
    mine, theirs = [json.loads(x) for x in
                    capsys.readouterr().out.splitlines()]
    assert mine == theirs
    assert [r["buckets"] for r in mine["rows"]] == [1_000_000, 10_000_000]
    assert hash_audit.DECADES == ref.DECADES
    for n, m in ((1000, 10**6), (10**5, 10**9)):
        assert hash_audit.expected_collision_fraction(n, m) == \
            ref.expected_collision_fraction(n, m)


def test_hash_audit_fails_above_max_ratio(capsys):
    assert hash_audit.main(["--tokens", "2000", "--decades", "100000",
                            "--max-ratio", "0.01"]) == 1
    assert json.loads(capsys.readouterr().out)["ok"] is False


# ----------------------------------------------------------- build_native

def test_build_native_symbols_cover_the_bindings():
    assert set(build_native.EXPECTED_SYMBOLS["aux.cpp"]) == \
        set(native._SIGNATURES)
    assert set(build_native.EXPECTED_SYMBOLS["fasthash.cpp"]) == \
        set(native._FAST_SIGNATURES)
    assert build_native.command("x.cpp", "y.so") == [
        "g++", *native.GXX_FLAGS, "x.cpp", "-o", "y.so"]


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="no g++ on PATH: the native libraries cannot build")
def test_build_native_check_passes(capsys):
    assert build_native.main(["--check"]) == 0
    assert "symbol check OK: 10 exported symbols in 2 libraries" in \
        capsys.readouterr().out


@pytest.mark.skipif(shutil.which("g++") is None,
                    reason="no g++ on PATH: the native libraries cannot build")
def test_build_native_check_catches_an_unregistered_export(monkeypatch,
                                                           capsys):
    monkeypatch.setitem(build_native.EXPECTED_SYMBOLS, "aux.cpp",
                        ("fmt_dedup_aux",))
    assert build_native.main(["--check"]) == 1
    assert "UNREGISTERED export: fmt_compact_aux" in capsys.readouterr().err


def test_tools_modules_run_as_scripts():
    """Each tool is a ``python -m`` entry point with a ``main(argv)``."""
    import fm_spark_tpu_torch.tools as tools

    for name in ("fmlint", "resilience_lint", "trace_report", "obs_report",
                 "run_doctor", "hash_audit", "build_native", "chaos_drill"):
        path = os.path.join(os.path.dirname(tools.__file__), f"{name}.py")
        with open(path) as f:
            src = f.read()
        assert 'if __name__ == "__main__":' in src, name
        assert "def main(" in src, name
    assert sys.modules["fm_spark_tpu_torch.tools.hash_audit"]
