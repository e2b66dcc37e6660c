"""The port's kernel build cache
(``fm_spark_tpu_torch/utils/compile_cache.py``) against the reference's
switch (``fm_spark_tpu/utils/compile_cache.py``).

- The switch reads ``FM_SPARK_COMPILE_CACHE`` as the reference does: a
  path, ``1`` for the default dir, and the falsy spellings for off.
- The warm-start contract on the CPU: a first process builds the native
  ``g++`` libraries into the cache (misses), a second process with the
  same cache builds nothing (all hits, 0 misses), and two processes
  started together on a cold cache build each library once (the build
  lock): the rest load it.
- Both builds land in the cache's subdirectories; ``serve`` reports the
  warm-up's ``fresh_compiles`` as a number and ``train`` the cache's
  counts (the nvcc builds run only on a card: their dir is held here).
"""

import json
import os
import subprocess
import sys

import pytest

from fm_spark_tpu.utils import compile_cache as jcache
from fm_spark_tpu_torch.utils import compile_cache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_STATS = (
    "import json\n"
    "from fm_spark_tpu_torch.utils import compile_cache\n"
    "compile_cache.enable_from_env()\n"
    "from fm_spark_tpu_torch import native\n"
    "native.load(); native.load_fast()\n"
    "print(json.dumps(compile_cache.cache_stats()))\n")


@pytest.fixture(autouse=True)
def _off(monkeypatch):
    monkeypatch.delenv(compile_cache.DEFAULT_ENV, raising=False)
    compile_cache.reset_stats()
    yield
    compile_cache._state["dir"] = None
    compile_cache.reset_stats()


def _run(env_dir, n=1):
    env = dict(os.environ, PYTHONPATH=REPO, FM_SPARK_COMPILE_CACHE=env_dir)
    procs = [subprocess.Popen([sys.executable, "-c", _STATS], env=env,
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(n)]
    out = []
    for p in procs:
        o, e = p.communicate(timeout=240)
        assert p.returncode == 0, e[-2000:]
        out.append(json.loads(o.strip().splitlines()[-1]))
    return out


@pytest.mark.parametrize("value,enabled", [
    ("", False), ("0", False), ("false", False), ("off", False),
    ("1", True), ("true", True), ("DIR", True)])
def test_env_switch_reads_like_the_reference(tmp_path, monkeypatch, value,
                                            enabled):
    """``enable_from_env`` and ``default_cache_dir`` take the reference's
    spellings: boolean ones are switches, anything else a directory."""
    if value == "DIR":
        value = str(tmp_path / "cache")
    monkeypatch.setenv(compile_cache.DEFAULT_ENV, value)
    got = compile_cache.enable_from_env()
    assert (got is not None) == enabled
    want_default = (jcache.default_cache_dir() != jcache.DEFAULT_DIR)
    assert (compile_cache.default_cache_dir()
            != compile_cache.DEFAULT_DIR) == want_default
    if value == str(tmp_path / "cache"):
        assert got == value and compile_cache.is_enabled()
        assert sorted(os.listdir(value)) == ["cache_meta.json",
                                             "torch_kernels",
                                             "torch_native"]


def test_warm_process_builds_nothing(tmp_path):
    """The warm-start contract: the second process's native builds are
    all hits, with no fresh compile."""
    cache = str(tmp_path / "cache")
    cold, = _run(cache)
    warm, = _run(cache)
    assert cold["requests"] == 2 and cold["misses"] == 2
    assert warm["requests"] == 2 and warm["hits"] == 2
    assert warm["misses"] == 0
    assert warm["entries"] == cold["entries"] == 2 and warm["bytes"] > 0


def test_processes_started_together_build_each_library_once(tmp_path):
    """Two processes on a cold cache: under the build lock one builds a
    library and the other, having waited, loads it."""
    a, b = _run(str(tmp_path / "cache"), n=2)
    assert a["misses"] + b["misses"] == 2
    assert a["hits"] + b["hits"] == 2
    assert a["entries"] == b["entries"] == 2


def test_both_builds_go_into_the_cache(tmp_path):
    from fm_spark_tpu_torch import native
    from fm_spark_tpu_torch.kernels import build

    src = os.path.join(build.CSRC_DIR, "rows.cu")
    assert os.path.dirname(build._lib_path("rows", src)) == build.BUILD_DIR
    d = compile_cache.enable(str(tmp_path / "c"))
    assert os.path.dirname(build._lib_path("rows", src)) == os.path.join(
        d, "torch_kernels")
    assert os.path.dirname(native._lib_path(native._SRC)) == os.path.join(
        d, "torch_native")


def test_a_library_counts_once_per_process():
    compile_cache.reset_stats()
    for hit in (False, True, True):
        compile_cache.note("/x/a.so", hit=hit)
    compile_cache.note("/x/b.so", hit=True)
    st = compile_cache.cache_stats()
    assert (st["requests"], st["hits"], st["misses"]) == (2, 1, 1)
    compile_cache.reset_stats()
    assert compile_cache.cache_stats()["requests"] == 0


def test_train_reports_the_cache_counts(tmp_path, capsys):
    from fm_spark_tpu_torch import cli

    assert cli.main(["train", "--config", "criteo_kaggle_fm_r32", "--bucket",
                     "16", "--synthetic", "600", "--steps", "2",
                     "--batch-size", "128", "--device", "cpu",
                     "--obs-dir", "none", "--compile-cache",
                     str(tmp_path / "c")]) == 0
    summary = json.loads(capsys.readouterr().err.strip().splitlines()[-1])
    assert summary["compile_cache"] == {"enabled": True, "requests": 0,
                                        "hits": 0, "misses": 0}
