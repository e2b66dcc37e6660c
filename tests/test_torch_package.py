"""Package rules of the PyTorch/CUDA port, and its kernels on the card.

This file imports nothing of JAX, so its ``gpu`` tests also run on a
machine with a card and no JAX:

    python -m pytest --noconftest tests/test_torch_package.py -m gpu -q

Off the card those tests skip with the reason named.
"""

import importlib
import os
import pkgutil
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import fm_spark_tpu_torch
from fm_spark_tpu_torch import DeviceUnavailable, resolve_device
from fm_spark_tpu_torch.kernels import build
from fm_spark_tpu_torch.ops import fused_fwd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _modules():
    pkg = fm_spark_tpu_torch
    return [pkg.__name__] + [
        m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")
        if not m.name.endswith("__main__")]


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import importlib, sys\n"
        f"for name in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'fm_spark_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert len(_modules()) >= 15


def test_every_module_imports_without_starting_work():
    before = build.build_logs.copy()
    for name in _modules():
        importlib.import_module(name)
    assert build.build_logs == before     # importing builds nothing


def test_resolve_device_never_picks_the_cpu_silently():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(DeviceUnavailable, match="device='cpu'"):
            resolve_device()
        with pytest.raises(DeviceUnavailable):
            resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_entry_points_default_to_the_card():
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.serve import PredictEngine

    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    spec = models.FieldFMSpec(num_features=8, rank=2, num_fields=2, bucket=4)
    with pytest.raises(DeviceUnavailable):
        spec.init()
    params = spec.init(device="cpu")
    with pytest.raises(DeviceUnavailable):
        PredictEngine(spec, params)


def test_chip_smoke_fails_without_a_card_or_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a CUDA device")
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        if cwd == tmp_path:
            shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        proc = subprocess.run([sys.executable, script], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fm_fused_fwd.cu(1): error: bad'\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(build.KernelBuildError, match="error: bad"):
        build.load("fm_fused_fwd")


def test_unloadable_library_raises(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    # Writes a file that is not a shared library to the -o path.
    fake.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'echo junk > "$2"\n')
    fake.chmod(0o755)
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(build, "_nvcc", lambda: str(fake))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(build.KernelBuildError, match="cannot load"):
        build.load("fm_fused_fwd")
    # The built library is reused, not rebuilt, by a later call.
    fake.write_text("#!/bin/sh\nexit 3\n")
    with pytest.raises(build.KernelBuildError, match="cannot load"):
        build.load("fm_fused_fwd")


def test_missing_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda p: False)
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build._nvcc()


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("k", [8, 64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("use_linear,w0", [(True, 0.3), (False, None)])
def test_kernel_matches_plain_on_the_card(cuda, k, dtype, use_linear, w0):
    rng = np.random.default_rng(k)
    f, bucket, b = 5, 60, 300
    tables = [torch.from_numpy(rng.normal(size=(bucket, k + 1)) * 0.3)
              .to(cuda, dtype) for _ in range(f)]
    ids = torch.from_numpy(rng.integers(-3, bucket + 3, (b, f))
                           .astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.random((b, f)).astype(np.float32)).to(cuda)
    w = None if w0 is None else torch.tensor(w0, device=cuda)
    before = fused_fwd.launches
    got = fused_fwd.fm_fused_scores(tables, ids, vals, use_linear=use_linear,
                                    w0=w)
    torch.cuda.synchronize()
    assert fused_fwd.launches == before + 1
    want = fused_fwd.fm_fused_scores_plain(tables, ids, vals,
                                           use_linear=use_linear, w0=w)
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
def test_engine_serves_through_the_kernel(cuda):
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.serve import PredictEngine

    spec = models.FieldFMSpec(num_features=6 * 50, rank=64, num_fields=6,
                              bucket=50, init_std=0.2)
    params = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    eng = PredictEngine(spec, params, buckets=(1, 8), device=cuda)
    eng.warmup()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 50, (20, 6)).astype(np.int32)
    vals = rng.random((20, 6)).astype(np.float32)
    before = fused_fwd.launches
    got = eng.predict(ids, vals)
    assert fused_fwd.launches - before == 3      # 8 + 8 + 4 rows
    cpu = {"w0": params["w0"].cpu(), "vw": [t.cpu() for t in params["vw"]]}
    want = spec.predict(cpu, torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
    eng.close()
