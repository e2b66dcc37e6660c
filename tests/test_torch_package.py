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


def test_entry_points_default_to_the_card(tmp_path):
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
    from fm_spark_tpu_torch import cli
    from fm_spark_tpu_torch.models import save_model

    model_dir = os.path.join(str(tmp_path), "m")
    save_model(model_dir, spec, params)
    with pytest.raises(DeviceUnavailable):
        cli.main(["serve", "--model", model_dir, "--synthetic", "8"])


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


def test_package_data_ships_every_kernel_source_and_header():
    import fnmatch
    import re
    import tomllib

    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        globs = tomllib.load(fh)["tool"]["setuptools"]["package-data"][
            "fm_spark_tpu_torch"]
    csrc = os.path.join(REPO, "fm_spark_tpu_torch", "csrc")

    def shipped(name):
        return any(fnmatch.fnmatch(f"csrc/{name}", g) for g in globs)

    sources = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    assert sources and all(shipped(f) for f in sources)
    for src in sources:
        with open(os.path.join(csrc, src)) as fh:
            for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', fh.read(),
                                  re.M):
                assert os.path.exists(os.path.join(csrc, inc)), (src, inc)
                assert shipped(inc), f"{src} includes {inc}, not shipped"
    # The native aux builder's source, compiled at first use, and any
    # header it includes.
    nat = os.path.join(REPO, "fm_spark_tpu_torch", "native")
    cpp = sorted(f for f in os.listdir(nat) if f.endswith(".cpp"))
    assert cpp and all(any(fnmatch.fnmatch(f"native/{f}", g) for g in globs)
                       for f in cpp)
    for src in cpp:
        with open(os.path.join(nat, src)) as fh:
            assert not re.findall(r'^\s*#\s*include\s+"', fh.read(), re.M)


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


# The forward kernel's four storage/compute pairs.
_FWD_PAIRS = [(torch.float32, False), (torch.bfloat16, False),
              (torch.bfloat16, True), (torch.float32, True)]


def _same_tree(a, b):
    from fm_spark_tpu_torch.graphs import _leaves

    return all(torch.equal(x, y) for x, y in zip(_leaves(a), _leaves(b)))


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["sparse-ftrl", "sparse-adagrad",
                                  "dense-ftrl", "dense-ffm", "dense-deepfm",
                                  "field-deepfm-ftrl"])
def test_new_steps_capture_and_repeat_bit_for_bit_on_the_card(cuda, form):
    """The sparse adaptive step (FTRL, AdaGrad), the dense step with FTRL,
    the flat FFM's and DeepFM's dense steps and FieldDeepFM's hybrid step
    with FTRL on its head, on the card: the eager body run twice from
    copies of the same params and state gives the same bits (kernel A sums
    each id once, no atomics; the sets are one per id), and the captured
    step equals the eager one bit for bit over three steps, its params and
    state included."""
    from fm_spark_tpu_torch import models, optim, sparse, train
    from fm_spark_tpu_torch.graphs import _clone

    kw = dict(num_features=3000, rank=8, init_std=0.1)
    nnz = 39 if form in ("sparse-ftrl", "sparse-adagrad", "dense-ftrl") \
        else 6
    if form == "field-deepfm-ftrl":
        spec = models.FieldDeepFMSpec(num_fields=nnz, bucket=500,
                                      mlp_dims=(32, 32), **kw)
    elif form == "dense-ffm":
        spec = models.FFMSpec(num_fields=nnz, **kw)
    elif form == "dense-deepfm":
        spec = models.DeepFMSpec(num_fields=nnz, mlp_dims=(32, 32), **kw)
    else:
        spec = models.FMSpec(**kw)
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(3):
        ids = (rng.zipf(1.3, (1024, nnz)) % 3000).astype(np.int32)
        ids[0, 0], ids[1, 1] = -5, 3007
        batches.append([torch.from_numpy(a).to(cuda) for a in (
            ids, rng.uniform(0.5, 1.5, (1024, nnz)).astype(np.float32),
            rng.integers(0, 2, 1024).astype(np.float32),
            (rng.random(1024) > 0.1).astype(np.float32))])
    if form == "field-deepfm-ftrl":
        for b in batches:                          # field-local ids
            b[0].remainder_(500)
    p0 = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    if form == "field-deepfm-ftrl":
        cfg = train.TrainConfig(learning_rate=0.05, optimizer="ftrl",
                                sparse_update="dedup", reg_bias=1e-3,
                                reg_factors=1e-3)
        step = sparse.make_field_deepfm_sparse_step(spec, cfg)
        body, init = sparse.make_field_deepfm_sparse_body(spec, cfg)
        s0 = init(p0)

        def eager(p, s, i, b):
            return body(p, s, i, *b)[2]

        def captured(p, s, i, b):
            return step(p, s, i, *b)[2]
    elif form.startswith("sparse"):
        name = form.split("-")[1]
        cfg = train.TrainConfig(learning_rate=0.05, optimizer=name)
        s0 = optim.init_adaptive_slots(name, spec, p0)
        step = optim.make_sparse_adaptive_step(spec, cfg, l1=1e-3, l2=1e-2)

        def eager(p, s, i, b):
            return step.body(p, s, *b)[2]

        def captured(p, s, i, b):
            return step(p, s, *b)[2]
    else:
        cfg = train.TrainConfig(
            learning_rate=0.05, reg_bias=1e-3, reg_linear=1e-3,
            reg_factors=1e-3,
            optimizer="ftrl" if form == "dense-ftrl" else "adam")
        s0 = train.make_optimizer(cfg).init(p0)
        step = train.make_train_step(spec, cfg)

        def eager(p, s, i, b):
            return torch.stack(step.body(p, s, *b))

        def captured(p, s, i, b):
            m = step(p, s, *b)[2]
            return torch.stack([m["loss"], m["grad_norm"]])
    runs = {}
    for name, fn in (("eager1", eager), ("eager2", eager),
                     ("captured", captured)):
        p, s = _clone(p0), _clone(s0)
        out = [fn(p, s, i, b) for i, b in enumerate(batches)]
        torch.cuda.synchronize()
        runs[name] = (p, s, torch.stack(out).cpu())
    assert len(step.captured.capture_s) == 1
    for name in ("eager2", "captured"):
        assert torch.equal(runs[name][2], runs["eager1"][2]), name
        assert _same_tree(runs[name][0], runs["eager1"][0]), name
        assert _same_tree(runs[name][1], runs["eager1"][1]), name


def _fwd_tables(rng, cuda, f, bucket, w, dtype, offset):
    """``f`` tables ``[bucket, w]``; with ``offset`` > 0 each is a
    contiguous view that many elements into a larger buffer, so its rows
    start off the 16-byte grid. Rows at 0.3·sqrt(320 / (f·(w-1))) keep
    Σs² and Σxv² near their size at 5 fields of rank 64 whatever the
    shape."""
    scale = 0.3 * np.sqrt(320 / (f * (w - 1)))
    tables = []
    for _ in range(f):
        t = torch.from_numpy(rng.normal(size=(bucket, w)) * scale).to(cuda, dtype)
        if offset:
            buf = torch.zeros(bucket * w + offset, dtype=dtype, device=cuda)
            buf[offset:] = t.reshape(-1)
            t = buf[offset:].view(bucket, w)
            assert t.storage_offset() == offset and t.is_contiguous()
        tables.append(t)
    return tables


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 17, 65, 129, 201])
@pytest.mark.parametrize("f", [1, 39, 70])
@pytest.mark.parametrize("dtype,cd", _FWD_PAIRS)
def test_kernel_matches_plain_on_the_card(cuda, w, f, dtype, cd):
    """Both launch forms: the staged one for bf16 tables, for fp32 tables
    up to 512 rows and past 128 columns or 64 fields (one sample per
    block up to 4099 rows, tiles of several at 9001 on an H100), and the
    warp one for the other fp32 cases from 4099 rows. Ids below 0 and
    past the bucket (clamped), tables aligned and at an odd storage
    offset, use_linear and w0 both ways, and a repeat of each call that
    must give the same bits."""
    rng = np.random.default_rng(100 * w + f)
    bucket = 300
    flags = [(True, 0.3), (False, None), (True, None), (False, 0.3)]
    # Products rounded the same way on both sides; fp32 sums in another
    # order (bf16 compute: the rounded products differ in the last bit
    # of a bf16 more often, hence the wider absolute bound).
    tol = dict(rtol=1e-5, atol=1e-4 if cd else 1e-5)
    for offset in (0, 1 + 2 * (w % 3)):
        tables = _fwd_tables(rng, cuda, f, bucket, w, dtype, offset)
        for i, b in enumerate((1, 7, 64, 512, 4099, 9001)):
            use_linear, w0 = flags[(i + offset) % 4]
            ids = torch.from_numpy(rng.integers(-3, bucket + 3, (b, f))
                                   .astype(np.int32)).to(cuda)
            vals = torch.from_numpy(rng.random((b, f)).astype(np.float32)
                                    + 0.5).to(cuda)
            wt = None if w0 is None else torch.tensor(w0, device=cuda)
            before = fused_fwd.launches
            got = fused_fwd.fm_fused_scores(tables, ids, vals,
                                            use_linear=use_linear, w0=wt,
                                            compute_bf16=cd)
            again = fused_fwd.fm_fused_scores(tables, ids, vals,
                                              use_linear=use_linear, w0=wt,
                                              compute_bf16=cd)
            torch.cuda.synchronize()
            assert fused_fwd.launches == before + 2
            want = fused_fwd.fm_fused_scores_plain(
                tables, ids, vals, use_linear=use_linear, w0=wt,
                compute_bf16=cd)
            for g, a, r in zip(got, again, want):
                assert torch.equal(g.view(torch.int32), a.view(torch.int32))
                torch.testing.assert_close(g, r, **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,cd", _FWD_PAIRS)
def test_forward_kernel_runs_column_windows_on_the_card(cuda, dtype, cd):
    """Rows past the 1024 columns of one window (w = 1100) go through in
    two windows, at one sample per block and at tiles of several."""
    rng = np.random.default_rng(11)
    f, bucket, w = 3, 50, 1100
    tables = _fwd_tables(rng, cuda, f, bucket, w, dtype, offset=3)
    w0 = torch.tensor(-0.2, device=cuda)
    for b in (3, 600, 9001):
        ids = torch.from_numpy(rng.integers(-2, bucket + 2, (b, f))
                               .astype(np.int32)).to(cuda)
        vals = torch.from_numpy(rng.random((b, f)).astype(np.float32)).to(cuda)
        got = fused_fwd.fm_fused_scores(tables, ids, vals, w0=w0,
                                        compute_bf16=cd)
        torch.cuda.synchronize()
        want = fused_fwd.fm_fused_scores_plain(tables, ids, vals, w0=w0,
                                               compute_bf16=cd)
        for g, r in zip(got, want):
            torch.testing.assert_close(g, r, rtol=1e-5,
                                       atol=1e-4 if cd else 1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("w", [17, 65, 128])
@pytest.mark.parametrize("f", [1, 39])
@pytest.mark.parametrize("dtype,cd", _FWD_PAIRS)
def test_forward_launch_forms_give_the_same_bits_on_the_card(cuda, w, f,
                                                             dtype, cd):
    """A sample scores to the same bits whatever batch it comes in: at
    8192 rows (the warp form for fp32 tables, tiles of several samples
    for bf16) and at 64 or 7 rows (one sample per block)."""
    rng = np.random.default_rng(7 * w + f)
    bucket = 500
    tables = _fwd_tables(rng, cuda, f, bucket, w, dtype, offset=1)
    b = 8192
    ids = torch.from_numpy(rng.integers(0, bucket, (b, f))
                           .astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.random((b, f)).astype(np.float32)
                            + 0.5).to(cuda)
    w0 = torch.tensor(0.3, device=cuda)
    full = fused_fwd.fm_fused_scores(tables, ids, vals, w0=w0, compute_bf16=cd)
    for lo, hi in ((0, 64), (100, 107)):
        part = fused_fwd.fm_fused_scores(tables, ids[lo:hi], vals[lo:hi],
                                         w0=w0, compute_bf16=cd)
        for g, r in zip(part, full):
            assert torch.equal(g.view(torch.int32), r[lo:hi].view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("rank,fields", [(200, 5), (64, 70)])
def test_field_fm_scores_at_any_width_and_field_count_on_the_card(cuda, rank,
                                                                  fields):
    """FieldFMSpec.scores serves rank 200 and 70 fields through the
    kernel (one launch, no KernelUnavailable) and agrees with the CPU."""
    from fm_spark_tpu_torch import models

    spec = models.FieldFMSpec(num_features=fields * 40, rank=rank,
                              num_fields=fields, bucket=40,
                              init_std=0.3 * np.sqrt(40 / (rank * fields)))
    assert spec.kernel_unsupported() is None
    params = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    params["w0"].fill_(0.1)
    rng = np.random.default_rng(rank + fields)
    ids = torch.from_numpy(rng.integers(0, 40, (300, fields)).astype(np.int32))
    vals = torch.from_numpy(rng.random((300, fields)).astype(np.float32))
    before = fused_fwd.launches
    got = spec.scores(params, ids.to(cuda), vals.to(cuda))
    torch.cuda.synchronize()
    assert fused_fwd.launches == before + 1
    cpu = {"w0": params["w0"].cpu(), "vw": [t.cpu() for t in params["vw"]]}
    want = spec.scores(cpu, ids, vals)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


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
    # 8 + 8 + 4 rows: three replays of graphs that each recorded the
    # kernel once, launched past the wrapper's count.
    assert fused_fwd.launches == before
    assert eng.graph_replays == 3
    assert eng.kernel_runs() == {"fm_fused_scores": 3}
    cpu = {"w0": params["w0"].cpu(), "vw": [t.cpu() for t in params["vw"]]}
    want = spec.predict(cpu, torch.from_numpy(ids), torch.from_numpy(vals))
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-5, atol=1e-6)
    eng.close()


def _served_model(cuda, family, cd, num_fields=6, seed=0):
    from fm_spark_tpu_torch import models

    kw = dict(num_features=num_fields * 50, num_fields=num_fields, bucket=50,
              param_dtype=cd, compute_dtype=cd, init_std=0.2)
    spec = {"fm": lambda: models.FieldFMSpec(rank=64, **kw),
            "ffm": lambda: models.FieldFFMSpec(rank=16, **kw),
            "deepfm": lambda: models.FieldDeepFMSpec(rank=16, **kw)}[family]()
    params = spec.init(torch.Generator(device=cuda).manual_seed(seed), cuda)
    return spec, params


def _rows(n, num_fields=6, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 50, (n, num_fields)).astype(np.int32),
            rng.random((n, num_fields)).astype(np.float32))


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["fm", "ffm", "deepfm"])
def test_bucket_replay_equals_eager_bit_for_bit_on_the_card(cuda, family, cd):
    from fm_spark_tpu_torch.serve import PredictEngine

    spec, params = _served_model(cuda, family, cd)
    eng = PredictEngine(spec, params, buckets=(1, 8, 64, 512), device=cuda)
    warm = eng.warmup()
    assert warm["captures"] == 4 and warm["capture_s"] > 0
    for b in (1, 8, 64, 512):
        ids, vals = _rows(b, seed=b)
        got = eng.score(ids, vals)
        want = spec.predict(params, torch.from_numpy(ids).to(cuda),
                            torch.from_numpy(vals).to(cuda)).float().cpu()
        assert np.array_equal(got, want.numpy()), (family, cd, b)
    assert eng.graph_replays == 4
    eng.close()


@pytest.mark.gpu
@pytest.mark.parametrize("family", ["fm", "ffm", "deepfm"])
def test_a_swap_recaptures_and_no_answer_comes_from_the_old_generation(
        cuda, family):
    from fm_spark_tpu_torch.serve import PredictEngine

    spec, params = _served_model(cuda, family, "float32", seed=1)
    newer = {**params, "w0": params["w0"] + 1.0}
    eng = PredictEngine(spec, params, buckets=(8, 64), device=cuda)
    eng.warmup()
    ids, vals = _rows(50)
    old = eng.predict(ids, vals)
    gen = eng.swap_generation(newer, step=3)
    assert set(gen.graphs) == {8, 64} and gen.capture_s > 0
    new = eng.predict(ids, vals)
    want = spec.predict(newer, torch.from_numpy(ids).to(cuda),
                        torch.from_numpy(vals).to(cuda)).float().cpu().numpy()
    assert np.array_equal(new, want)
    assert not np.isclose(new, old, rtol=0, atol=1e-6).any()
    eng.close()


@pytest.mark.gpu
def test_deepfm_rows_are_batch_invariant_on_the_card(cuda):
    """A FieldDeepFM row served in each bucket equals the same row in a
    batch of 512, bit for bit, in bf16 and fp32 (the head's fixed row
    tiles; bf16 products with float32 sums)."""
    from fm_spark_tpu_torch.serve import PredictEngine

    for cd in ("float32", "bfloat16"):
        spec, params = _served_model(cuda, "deepfm", cd)
        eng = PredictEngine(spec, params, buckets=(1, 8, 64, 512),
                            device=cuda)
        eng.warmup()
        ids, vals = _rows(512, seed=3)
        full = eng.score(ids, vals)
        for n in (1, 5, 8, 33, 64, 300):
            assert np.array_equal(eng.score(ids[:n], vals[:n]), full[:n]), \
                (cd, n)
        eng.close()


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_a_capture_of_65_fields_replays_equal_to_the_plain_version(cuda, cd):
    """Above 64 fields the table pointers are staged once per set of
    addresses by the warm-up call, so each bucket captures and replays;
    the replay equals an eager call bit for bit and the plain version
    within the forward's tolerance, before and after a swap."""
    from fm_spark_tpu_torch.serve import PredictEngine

    spec, params = _served_model(cuda, "fm", cd, num_fields=65)
    eng = PredictEngine(spec, params, buckets=(4, 64), device=cuda)
    assert eng.warmup()["captures"] == 2
    for gen_params in (params, {**params, "w0": params["w0"] + 1.0}):
        if gen_params is not params:
            eng.swap_generation(gen_params, step=1)
        ids, vals = _rows(50, num_fields=65, seed=7)
        got = eng.predict(ids, vals)
        t_ids, t_vals = (torch.from_numpy(ids).to(cuda),
                         torch.from_numpy(vals).to(cuda))
        eager = spec.predict(gen_params, t_ids, t_vals).float().cpu()
        assert np.array_equal(got, eager.numpy())
        plain, _ = fused_fwd.fm_fused_scores_plain(
            [t.cpu() for t in gen_params["vw"]], t_ids.cpu(), t_vals.cpu(),
            w0=gen_params["w0"].cpu(), compute_bf16=cd == "bfloat16")
        np.testing.assert_allclose(got, torch.sigmoid(plain).numpy(),
                                   rtol=1e-5, atol=1e-5)
    eng.close()


def _sorted_ranks(rng, b, kind):
    """Non-decreasing dense ranks of B sorted lanes: Zipf (long head
    runs spanning many tiles), a few huge runs, or one segment."""
    if kind == "zipf":
        ids = np.sort(rng.zipf(1.3, b) % 5000)
    elif kind == "few":
        ids = np.sort(rng.integers(0, 3, b))
    else:
        ids = np.zeros(b, np.int64)
    return np.unique(ids, return_inverse=True)[1].astype(np.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("b,kind", [(1, "one"), (127, "zipf"), (129, "few"),
                                    (4100, "zipf"), (20000, "one"),
                                    (70000, "zipf")])
def test_segment_totals_kernel_matches_plain_on_the_card(cuda, b, kind):
    from fm_spark_tpu_torch.ops import segsum

    rng = np.random.default_rng(b)
    seg = _sorted_ranks(rng, b, kind)
    # A cap below the segment count: the last ranks are dropped.
    cap = max(1, int(seg.max()) + 1 - 2)
    x = torch.from_numpy(rng.normal(size=(b, 65)).astype(np.float32)).to(cuda)
    s = torch.from_numpy(seg).to(cuda)
    before = segsum.launches
    got = segsum.segment_totals(x, s, cap)
    again = segsum.segment_totals(x, s, cap)
    torch.cuda.synchronize()
    assert segsum.launches == before + 2
    assert torch.equal(got, again)                   # no atomics: same bits
    # Both sides sum fp32 in different orders (the kernel in runs of 128,
    # the plain version in atomic order): each must be within 1e-5 of the
    # segment's sum of |x| from the exact (float64) total.
    exact = segsum.segment_totals_plain(x.double(), s, cap)
    bound = 1e-5 * segsum.segment_totals_plain(x.abs().double(), s, cap)
    want = segsum.segment_totals_plain(x, s, cap)
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert bool(((want.double() - exact).abs() <= bound).all())


# Kernel A's cases: (B, ranks, cap, zero_tail, order). "dedup" is the
# device dedup's call (cap = B, rows past the last rank left unwritten, the
# unsorted delta read through the order); a Zipf head of ~5,000 lanes
# spans many 256-lane tiles.
_SEG_CASES = {
    "dedup": (20000, "zipf", "B", False, True),
    "compact": (20000, "zipf", "over", True, True),
    "dropped": (20000, "zipf", "under", True, False),
    "one": (5000, "one", "over", True, True),
    "gaps": (3000, "gaps", "over", True, False),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_SEG_CASES))
@pytest.mark.parametrize("w", [17, 65, 128, 129, 369])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_segment_totals_kernel_at_any_width_on_the_card(cuda, case, w, dtype):
    """Widths past the first design's 128 columns, cap = B and cap below
    the segment count, one segment over the whole batch, gapped ranks; the
    output is handed over full of NaN: every live row must match the
    float64 sums, every row no lane falls in must be 0, and with
    zero_tail=False the rows past the last rank are not looked at."""
    from fm_spark_tpu_torch.ops import segsum

    b, kind, capk, zero_tail, use_order = _SEG_CASES[case]
    rng = np.random.default_rng(w + b)
    seg = _sorted_ranks(rng, b, "one" if kind == "one" else "zipf")
    if kind == "gaps":
        seg = seg * 3 + 2
    last = int(seg.max())
    cap = {"B": b, "over": last + 40, "under": max(1, last - 5)}[capk]
    x = torch.from_numpy(rng.normal(size=(b, w)).astype(np.float32)).to(
        cuda, dtype)
    s = torch.from_numpy(seg).to(cuda)
    order = (torch.from_numpy(rng.permutation(b).astype(np.int32)).to(cuda)
             if use_order else None)
    nan = torch.full((cap, w), float("nan"), device=cuda)
    ptr = nan.data_ptr()
    del nan
    before = segsum.launches
    got = segsum.segment_totals(x, s, cap, order=order, zero_tail=zero_tail)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    again = segsum.segment_totals(x, s, cap, order=order, zero_tail=zero_tail)
    torch.cuda.synchronize()
    assert segsum.launches == before + 2
    rows = cap if zero_tail else min(cap, last + 1)
    assert torch.equal(got[:rows], again[:rows])     # no atomics: same bits
    exact = segsum.segment_totals_plain(x.double(), s, cap, order)[:rows]
    bound = 1e-5 * segsum.segment_totals_plain(x.abs().double(), s, cap,
                                               order)[:rows]
    assert not bool(got[:rows].isnan().any())
    assert bool(((got[:rows].double() - exact).abs() <= bound).all())
    hit = torch.zeros(rows, dtype=torch.bool, device=cuda)
    hit[s[s < rows].long()] = True
    assert bool((got[:rows][~hit] == 0).all())
    if kind == "gaps" or capk == "over":
        assert bool((~hit).any())


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 65, 369])
@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ddt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("u", ["0", "1", "B"])
def test_update_kernel_count_form_matches_plain_on_the_card(cuda, w, tdt,
                                                            ddt, u):
    """The dedup's call: per-segment lanes of which the first ``count``
    are live; the lanes past it hold ids that alias live ones and must be
    left alone. Bit for bit with the plain version."""
    from fm_spark_tpu_torch.ops import rows

    rng = np.random.default_rng(w)
    b, n = 3000, 5000
    count = {"0": 0, "1": 1, "B": b}[u]
    table = torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)).to(
        cuda, tdt)
    ids = rng.permutation(n)[:b].astype(np.int32)
    ids[count:] = ids[0]                  # dead lanes: never written
    valid = np.ones(b, np.int32)
    valid[::7] = 0
    ids_t, valid_t = (torch.from_numpy(a).to(cuda) for a in (ids, valid))
    delta = torch.from_numpy(rng.normal(size=(b, w)).astype(np.float32)
                             * 0.01).to(cuda, ddt)
    delta[count:] = float("nan")
    cnt = torch.tensor([count], dtype=torch.int32, device=cuda)
    t1, t2 = table.clone(), table.clone()
    before = rows.update_launches
    rows.update_rows_add(t1, ids_t, valid_t, delta, count=cnt)
    rows.update_rows_add(t2, ids_t, valid_t, delta, count=cnt)
    want = rows.update_rows_add_plain(table.cpu(), ids_t.cpu(), valid_t.cpu(),
                                      delta.cpu(), count=cnt.cpu())
    torch.cuda.synchronize()
    assert rows.update_launches == before + 2
    assert _bitwise(t1, t2)
    assert _bitwise(t1.cpu(), want)
    assert not bool(t1.isnan().any())


@pytest.mark.gpu
@pytest.mark.parametrize("w", [65, 369])
def test_pallas_dedup_add_repeats_bit_for_bit_on_the_card(cuda, w):
    """The use_pallas write, and the host-aux dedup write, on a Zipf batch
    whose head segment spans many of kernel A's tiles, each on two copies
    of one table: the same bits, and
    within 1e-5 of each row's sum of |term| (plus the table's rounding)
    of the float64 result."""
    from fm_spark_tpu_torch.ops import rows, scatter, segsum

    rng = np.random.default_rng(w)
    b, n = 40000, 5000
    ids = (rng.zipf(1.3, b) % n).astype(np.int32)
    assert np.bincount(ids).max() > 1000
    table = torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)).to(
        cuda)
    delta = torch.from_numpy(rng.normal(size=(b, w)).astype(np.float32)
                             * 0.01).to(cuda)
    ids_t = torch.from_numpy(ids).to(cuda)
    t1, t2 = table.clone(), table.clone()
    before = (segsum.launches, rows.update_launches)
    scatter._pallas_dedup_add(t1, ids_t, delta)
    scatter._pallas_dedup_add(t2, ids_t, delta)
    torch.cuda.synchronize()
    assert (segsum.launches - before[0], rows.update_launches - before[1]) \
        == (2, 2)
    assert _bitwise(t1, t2)
    # The host dedup_aux form of the dedup write sums through kernel A too.
    aux = tuple(torch.from_numpy(a).to(cuda) for a in scatter.dedup_aux(ids))
    t3, t4 = table.clone(), table.clone()
    for t in (t3, t4):
        scatter.apply_row_updates(t, ids_t, delta, "dedup", aux=aux)
    torch.cuda.synchronize()
    assert segsum.launches - before[0] == 4
    assert _bitwise(t3, t4)
    idx = ids_t.long()
    exact = table.double().index_add_(0, idx, delta.double())
    bound = (1e-5 * torch.zeros_like(exact).index_add_(0, idx,
                                                       delta.abs().double())
             + 2.0 ** -24 * exact.abs())
    for got in (t1, t3):
        assert bool(((got.double() - exact).abs() <= bound).all())


@pytest.mark.gpu
@pytest.mark.parametrize("w", [2, 33, 65, 128])
@pytest.mark.parametrize("store", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rv", [None, (1e-3, 2e-3)])
def test_fm_bwd_kernel_matches_plain_on_the_card(cuda, w, store, cd, rv):
    """Rows of 2 to 128 columns; B = 3000, not a multiple of the 128-lane
    tile; field 0 one segment over every tile; field 1 a Zipf head over
    several tiles; a cap below the largest field's distinct count, so
    that field has lanes with inv >= cap (summed, never written)."""
    from fm_spark_tpu_torch.ops import fused_bwd, segsum
    from fm_spark_tpu_torch.ops.scatter import compact_aux

    rng = np.random.default_rng(3 + w)
    b, f, bucket = 3000, 5, 400
    ids = (rng.zipf(1.3, (b, f)) % bucket).astype(np.int32)
    ids[:, 0] = 7
    aux = compact_aux(ids, bucket)
    distinct = [len(np.unique(ids[:, j])) for j in range(f)]
    cap = max(distinct) - 20
    assert max(distinct) > cap > 1 and b % 128
    order, inv = (torch.from_numpy(a).to(cuda) for a in (aux[3], aux[4]))
    assert bool((inv >= cap).any())
    urows = [torch.from_numpy(rng.normal(size=(cap, w)) * 0.1)
             .to(cuda, store) for _ in range(f)]
    s1 = torch.from_numpy(rng.normal(size=(b, w))).to(cuda, cd)
    ds = torch.from_numpy(rng.normal(size=b) * 0.1).to(cuda, cd)
    vals = torch.from_numpy(rng.uniform(0.5, 1.5, (b, f))).to(cuda, torch.float32)
    weights = torch.from_numpy((rng.random(b) > 0.1).astype(np.float32)).to(cuda)
    before = fused_bwd.launches
    args = (urows, s1, ds, vals, weights, order, inv, -0.05, rv)
    got = fused_bwd.fm_bwd_segment_totals(*args, cap=cap)
    again = fused_bwd.fm_bwd_segment_totals(*args, cap=cap)
    torch.cuda.synchronize()
    assert fused_bwd.launches == before + 2
    assert torch.equal(got, again)
    want = fused_bwd.fm_bwd_segment_totals_plain(*args, cap=cap)
    # Elementwise the same roundings; only the order of each segment's
    # fp32 sum differs (the plain version's in atomic order): each within
    # 1e-5 of the segment's sum of |term| from the exact (float64) total.
    terms = fused_bwd.fm_bwd_sorted_deltas(*args, cap=cap)
    exact = torch.stack([segsum.segment_totals_plain(d.double(), s, cap)
                         for d, s in terms])
    bound = 1e-5 * torch.stack([segsum.segment_totals_plain(d.abs().double(),
                                                            s, cap)
                                for d, s in terms])
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert bool(((want.double() - exact).abs() <= bound).all())
    # Field 0's one segment holds every lane's term.
    assert bool((got[0, 1:] == 0).all()) and bool((got[0, 0] != 0).any())


@pytest.mark.gpu
@pytest.mark.parametrize("gaps", [False, True], ids=["dense", "gaps"])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_fm_bwd_kernel_writes_every_row_of_its_output(cuda, gaps, cd):
    """The kernel zeroes the rows no lane writes itself: its output gets a
    freed block full of NaN. Dense segments leave the rows past each
    field's last segment; doubled ones also leave a row between every two
    and put the upper half at or past cap."""
    from fm_spark_tpu_torch.ops import fused_bwd, segsum
    from fm_spark_tpu_torch.ops.scatter import compact_aux

    rng = np.random.default_rng(11)
    b, f, bucket, cap, w = 5000, 4, 3000, 1200, 65
    ids = (rng.zipf(1.3, (b, f)) % bucket).astype(np.int32)
    aux = compact_aux(ids, bucket)
    order, inv = (torch.from_numpy(a).to(cuda) for a in (aux[3], aux[4]))
    if gaps:
        inv = inv * 2
    urows = [torch.from_numpy(rng.normal(size=(cap, w)) * 0.1)
             .to(cuda, torch.bfloat16) for _ in range(f)]
    s1 = torch.from_numpy(rng.normal(size=(b, w))).to(cuda, cd)
    ds = torch.from_numpy(rng.normal(size=b) * 0.1).to(cuda, cd)
    vals = torch.from_numpy(rng.uniform(0.5, 1.5, (b, f))).to(cuda, torch.float32)
    weights = torch.ones(b, device=cuda)
    args = (urows, s1, ds, vals, weights, order, inv, -0.05, None)
    nan = torch.full((f, cap, w), float("nan"), device=cuda)
    ptr = nan.data_ptr()
    del nan
    got = fused_bwd.fm_bwd_segment_totals(*args, cap=cap)
    torch.cuda.synchronize()
    assert got.data_ptr() == ptr
    terms = fused_bwd.fm_bwd_sorted_deltas(*args, cap=cap)
    exact = torch.stack([segsum.segment_totals_plain(d.double(), s, cap)
                         for d, s in terms])
    bound = 1e-5 * torch.stack([segsum.segment_totals_plain(d.abs().double(),
                                                            s, cap)
                                for d, s in terms])
    assert not bool(got.isnan().any())
    assert bool(((got.double() - exact).abs() <= bound).all())
    hit = torch.zeros(f, cap, dtype=torch.bool, device=cuda)
    for j in range(f):
        s = inv[j][inv[j] < cap].long()
        hit[j, s] = True
    assert bool((~hit).any()) and bool((got[~hit] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("lever", [dict(gfull_fused=True, segtotal_pallas=True),
                                   dict(fused_embed="require")])
def test_training_step_runs_through_the_kernels_on_the_card(cuda, lever):
    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.ops import fused_bwd, scatter, segsum
    from fm_spark_tpu_torch.train import TrainConfig

    rng = np.random.default_rng(0)
    b, f, bucket, cap = 2048, 6, 500, 512
    spec = models.FieldFMSpec(num_features=f * bucket, rank=64, num_fields=f,
                              bucket=bucket, param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    cfg = TrainConfig(learning_rate=0.05, lr_schedule="constant",
                      reg_factors=1e-4, sparse_update="dedup_sr",
                      host_dedup=True, compact_cap=cap, **lever)
    ids = (rng.zipf(1.3, (b, f)) % bucket).astype(np.int32)
    batch = [torch.from_numpy(a) for a in (
        ids, np.ones((b, f), np.float32),
        rng.integers(0, 2, b).astype(np.float32), np.ones(b, np.float32))]
    aux = [torch.from_numpy(a) for a in scatter.compact_aux(ids, cap)]
    noise = lambda step, fld, shape: torch.from_numpy(
        np.random.default_rng((step, fld)).integers(0, 1 << 16, shape)
        .astype(np.int32))
    p_card = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    p_cpu = {"w0": p_card["w0"].cpu(), "vw": [t.cpu() for t in p_card["vw"]]}
    counts = (segsum.launches, fused_bwd.launches)
    step = sparse.make_field_sparse_sgd_body(
        spec, cfg, sr_noise=lambda *a: noise(*a).to(cuda))
    p_card, loss_card = step(p_card, 0, *[t.to(cuda) for t in batch],
                             tuple(a.to(cuda) for a in aux))
    torch.cuda.synchronize()
    launched = (segsum.launches - counts[0], fused_bwd.launches - counts[1])
    assert launched == ((f, 0) if "segtotal_pallas" in lever else (0, 1))
    p_cpu, loss_cpu = sparse.make_field_sparse_sgd_body(
        spec, cfg, sr_noise=noise)(p_cpu, 0, *batch, tuple(aux))
    assert abs(float(loss_card) - float(loss_cpu)) < 1e-3
    for a, c in zip(p_card["vw"], p_cpu["vw"]):
        torch.testing.assert_close(a.cpu().float(), c.float(), rtol=0, atol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("f,k", [(6, 64), (70, 200)])
def test_forward_kernel_bf16_compute_matches_plain_on_the_card(cuda, dtype,
                                                               f, k):
    rng = np.random.default_rng(1)
    bucket, b = 80, 500
    scale = 0.3 * np.sqrt(6 * 64 / (f * k))
    tables = [torch.from_numpy(rng.normal(size=(bucket, k + 1)) * scale)
              .to(cuda, dtype) for _ in range(f)]
    ids = torch.from_numpy(rng.integers(0, bucket, (b, f)).astype(np.int32)).to(cuda)
    vals = torch.from_numpy(rng.random((b, f)).astype(np.float32) + 0.5).to(cuda)
    w0 = torch.tensor(0.3, device=cuda)
    got = fused_fwd.fm_fused_scores(tables, ids, vals, w0=w0, compute_bf16=True)
    torch.cuda.synchronize()
    want = fused_fwd.fm_fused_scores_plain(tables, ids, vals, w0=w0,
                                           compute_bf16=True)
    # Products rounded the same way on both sides; fp32 sums in another
    # order.
    for g, r in zip(got, want):
        torch.testing.assert_close(g, r, rtol=1e-5, atol=1e-4)


def _ffm_operands(cuda, b, f, k, dtype, seed=0):
    rng = np.random.default_rng(seed)
    rows = torch.from_numpy(rng.normal(size=(b, f, f * k)) * 0.5).to(cuda, dtype)
    vals = torch.from_numpy(rng.uniform(0.5, 1.5, (b, f))).to(cuda, dtype)
    ds = torch.from_numpy(rng.normal(size=b) * 0.1).to(cuda, dtype)
    return rows, vals, ds


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,f,k", [(1, 23, 16), (127, 23, 16), (8192, 23, 16),
                                   (300, 5, 6), (300, 5, 8)])
def test_ffm_sel_kernels_match_plain_on_the_card(cuda, b, f, k, dtype):
    from fm_spark_tpu_torch.ops import ffm_sel

    rows, vals, ds = _ffm_operands(cuda, b, f, k, dtype, seed=b + k)
    before = (ffm_sel.scores_launches, ffm_sel.bwd_launches)
    acc = ffm_sel.ffm_sel_scores(rows, vals)
    acc2 = ffm_sel.ffm_sel_scores(rows, vals)
    dvs = ffm_sel.ffm_sel_bwd(rows, vals, ds)
    dvs2 = ffm_sel.ffm_sel_bwd(rows, vals, ds)
    torch.cuda.synchronize()
    assert (ffm_sel.scores_launches - before[0],
            ffm_sel.bwd_launches - before[1]) == (2, 2)
    assert torch.equal(acc, acc2) and torch.equal(dvs, dvs2)   # same bits
    # The same roundings in the same order, sums in index order on both
    # sides: the kernels equal their plain versions bit for bit.
    assert torch.equal(acc, ffm_sel.ffm_sel_scores_plain(rows, vals))
    assert torch.equal(dvs, ffm_sel.ffm_sel_bwd_plain(rows, vals, ds))


@pytest.mark.gpu
def test_ffm_sel_library_stages_what_the_wrapper_expects(cuda):
    from fm_spark_tpu_torch.ops import ffm_sel

    lib = build.load("ffm_sel")
    for f, k in ((23, 16), (5, 6), (39, 64), (1, 1)):
        for elem in (2, 4):
            assert lib.ffm_sel_smem_bytes(f, k, elem) == \
                ffm_sel.smem_bytes(f, k, elem)


def _ffm_spec(models, cd, f=6, bucket=40, k=16):
    return models.FieldFFMSpec(num_features=f * bucket, rank=k, num_fields=f,
                               bucket=bucket, init_std=0.2, compute_dtype=cd)


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_ffm_training_step_runs_through_the_kernels_on_the_card(cuda, cd):
    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.ops import ffm_sel
    from fm_spark_tpu_torch.train import TrainConfig

    rng = np.random.default_rng(0)
    b, f, bucket = 1024, 6, 40
    spec = _ffm_spec(models, cd, f, bucket)
    cfg = TrainConfig(learning_rate=0.05, lr_schedule="constant",
                      reg_factors=1e-4, reg_linear=1e-5, sel_blocked=True,
                      fused_embed="require")
    batch = [torch.from_numpy(a) for a in (
        (rng.zipf(1.3, (b, f)) % bucket).astype(np.int32),
        rng.uniform(0.5, 1.5, (b, f)).astype(np.float32),
        rng.integers(0, 2, b).astype(np.float32), np.ones(b, np.float32))]
    p_card = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    p_cpu = {"w0": p_card["w0"].cpu(), "vw": [t.cpu() for t in p_card["vw"]]}
    before = (ffm_sel.scores_launches, ffm_sel.bwd_launches)
    step = sparse.make_field_ffm_sparse_sgd_body(spec, cfg)
    p_card, loss_card = step(p_card, 0, *[t.to(cuda) for t in batch])
    torch.cuda.synchronize()
    assert (ffm_sel.scores_launches - before[0],
            ffm_sel.bwd_launches - before[1]) == (1, 1)
    p_cpu, loss_cpu = step(p_cpu, 0, *batch)
    # index_add_ on the card adds atomically, in no fixed order: the
    # reference's tolerances (tests/test_sel_blocked.py).
    tol = dict(rtol=2e-5, atol=2e-6) if cd == "float32" else \
        dict(rtol=3e-2, atol=3e-3)
    assert abs(float(loss_card) - float(loss_cpu)) < 1e-5
    for a, c in zip(p_card["vw"], p_cpu["vw"]):
        torch.testing.assert_close(a.cpu(), c, **tol)
    torch.testing.assert_close(p_card["w0"].cpu(), p_cpu["w0"], **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("cd", ["float32", "bfloat16"])
def test_engine_serves_ffm_through_the_kernel(cuda, cd):
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.ops import ffm_sel
    from fm_spark_tpu_torch.serve import PredictEngine

    spec = _ffm_spec(models, cd)
    params = spec.init(torch.Generator(device=cuda).manual_seed(1), cuda)
    for t in params["vw"]:
        t[:, -1] = 0.1
    eng = PredictEngine(spec, params, buckets=(1, 8), device=cuda)
    eng.warmup()
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 40, (20, 6)).astype(np.int32)
    vals = rng.random((20, 6)).astype(np.float32)
    before = ffm_sel.scores_launches
    got = eng.predict(ids, vals)
    assert ffm_sel.scores_launches == before      # replays: 8 + 8 + 4 rows
    assert eng.kernel_runs() == {"ffm_sel_scores": 3}
    cpu = {"w0": params["w0"].cpu(), "vw": [t.cpu() for t in params["vw"]]}
    want = spec.predict(cpu, torch.from_numpy(ids), torch.from_numpy(vals))
    # The card scores by the owner loop, the CPU by the reference's sel
    # tensor: fp32 sums in another order, or bf16 rounding at other places.
    tol = dict(rtol=1e-5, atol=1e-6) if cd == "float32" else \
        dict(rtol=3e-2, atol=3e-3)
    np.testing.assert_allclose(got, want.float().numpy(), **tol)
    eng.close()


def _bitwise(a, b):
    if a.dtype == torch.bfloat16:
        return torch.equal(a.view(torch.int16), b.view(torch.int16))
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.gpu
@pytest.mark.parametrize("w", [1, 3, 4, 8, 17, 65, 128, 369])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 255, 16384, 131072])
def test_row_kernels_match_plain_on_the_card(cuda, w, dtype, b):
    from fm_spark_tpu_torch.ops import rows

    rng = np.random.default_rng(b + w)
    n = max(2 * b, 1000)
    table = torch.from_numpy(rng.normal(size=(n, w)).astype(np.float32)).to(
        cuda, dtype)
    # Gather: duplicates and ids outside the table (clamped).
    gids = torch.from_numpy(rng.integers(-5, n + 5, b).astype(np.int32)).to(cuda)
    before = (rows.gather_launches, rows.update_launches)
    got = rows.gather_rows(table, gids)
    again = rows.gather_rows(table, gids)
    # Update: unique ids among the valid lanes, invalid lanes aimed at row
    # 0, fp32 and bf16 deltas.
    ids = rng.permutation(n)[:b].astype(np.int32)
    valid = (rng.random(b) < 0.7).astype(np.int32)
    ids = np.where(valid == 1, ids, 0).astype(np.int32)
    ids_t, valid_t = (torch.from_numpy(a).to(cuda) for a in (ids, valid))
    for ddt in (torch.float32, torch.bfloat16):
        delta = torch.from_numpy(rng.normal(size=(b, w)).astype(np.float32)
                                 * 0.01).to(cuda, ddt)
        t1, t2 = table.clone(), table.clone()
        rows.update_rows_add(t1, ids_t, valid_t, delta)
        rows.update_rows_add(t2, ids_t, valid_t, delta)
        want = rows.update_rows_add_plain(table.cpu(), ids_t.cpu(),
                                          valid_t.cpu(), delta.cpu())
        torch.cuda.synchronize()
        assert _bitwise(t1, t2)                       # a repeat: same bits
        assert _bitwise(t1.cpu(), want)
    torch.cuda.synchronize()
    assert (rows.gather_launches - before[0],
            rows.update_launches - before[1]) == (2, 4)
    assert _bitwise(got, again)
    assert _bitwise(got.cpu(), rows.gather_rows_plain(table.cpu(),
                                                      gids.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("offset", [1, 3, 4, 8])
@pytest.mark.parametrize("w", [4, 8, 65])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_kernel_takes_a_table_at_a_storage_offset(cuda, offset, w,
                                                        dtype):
    """A contiguous view at a storage offset, aligned to 16 bytes or not:
    bit for bit either way."""
    from fm_spark_tpu_torch.ops import rows

    rng = np.random.default_rng(offset * w)
    n, b = 3000, 4097
    base = torch.from_numpy(rng.normal(size=n * w + 8).astype(np.float32)).to(
        cuda, dtype)
    table = base[offset:offset + n * w].view(n, w)
    assert table.is_contiguous() and table.storage_offset() == offset
    ids = torch.from_numpy(rng.integers(-3, n + 3, b).astype(np.int32)).to(cuda)
    before = rows.gather_launches
    got = rows.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert rows.gather_launches == before + 1
    assert _bitwise(got.cpu(), rows.gather_rows_plain(table.cpu(), ids.cpu()))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,w,b", [(torch.bfloat16, 3, 715_827_883),
                                       (torch.float32, 2, (1 << 30) + 1)])
def test_gather_kernel_indexes_past_2_31_elements(cuda, dtype, w, b):
    """An output of just over 2^31 elements, where the kernel finds rows
    by 64-bit division (4.3 or 8.6 GB of output on the card)."""
    from fm_spark_tpu_torch.ops import rows

    assert b * w > 1 << 31
    n = 1000
    g = torch.Generator(device=cuda).manual_seed(w)
    table = torch.randn(n, w, generator=g, device=cuda).to(dtype)
    ids = torch.randint(-3, n + 3, (b,), generator=g, device=cuda,
                        dtype=torch.int32)
    before = rows.gather_launches
    got = rows.gather_rows(table, ids)
    torch.cuda.synchronize()
    assert rows.gather_launches == before + 1
    assert _bitwise(got, rows.gather_rows_plain(table, ids))
    del got
    torch.cuda.empty_cache()


@pytest.mark.gpu
@pytest.mark.parametrize("ffm", [False, True], ids=["fm", "ffm"])
def test_use_pallas_step_runs_through_the_row_kernels_on_the_card(cuda, ffm):
    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.ops import ffm_sel, rows
    from fm_spark_tpu_torch.train import TrainConfig

    rng = np.random.default_rng(0)
    b, f, bucket = 2048, 6, 500
    if ffm:
        spec = models.FieldFFMSpec(num_features=f * bucket, rank=16,
                                   num_fields=f, bucket=bucket, init_std=0.1,
                                   compute_dtype="bfloat16")
        lever = dict(sel_blocked=True, fused_embed="require")
    else:
        spec = models.FieldFMSpec(num_features=f * bucket, rank=64,
                                  num_fields=f, bucket=bucket, init_std=0.1)
        lever = {}
    cfg = TrainConfig(learning_rate=0.05, lr_schedule="constant",
                      reg_factors=1e-4, sparse_update="scatter_add",
                      use_pallas=True, **lever)
    batch = [torch.from_numpy(a) for a in (
        (rng.zipf(1.3, (b, f)) % bucket).astype(np.int32),
        rng.uniform(0.5, 1.5, (b, f)).astype(np.float32),
        rng.integers(0, 2, b).astype(np.float32), np.ones(b, np.float32))]
    p_card = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    p_cpu = {"w0": p_card["w0"].cpu(), "vw": [t.cpu() for t in p_card["vw"]]}
    before = (rows.gather_launches, rows.update_launches,
              ffm_sel.scores_launches)
    step = (sparse.make_field_ffm_sparse_sgd_body if ffm
            else sparse.make_field_sparse_sgd_body)(spec, cfg)
    p_card, loss_card = step(p_card, 0, *[t.to(cuda) for t in batch])
    torch.cuda.synchronize()
    assert (rows.gather_launches - before[0],
            rows.update_launches - before[1]) == (f, f)
    assert ffm_sel.scores_launches - before[2] == (1 if ffm else 0)
    p_cpu, loss_cpu = step(p_cpu, 0, *batch)
    # The same kernels' arithmetic; the device dedup's segment sums add in
    # kernel A's order on the card and in lane order on the CPU: the
    # reference's tolerances (fp32 for FM, the bf16 compute ones for FFM).
    tol = (dict(rtol=3e-2, atol=3e-3) if ffm else dict(rtol=1e-4, atol=1e-6))
    assert abs(float(loss_card) - float(loss_cpu)) <= (
        1e-3 if ffm else 1e-5 * abs(float(loss_cpu)))
    for a, c in zip(p_card["vw"], p_cpu["vw"]):
        torch.testing.assert_close(a.cpu(), c, **tol)
    torch.testing.assert_close(p_card["w0"].cpu(), p_cpu["w0"], **tol)


@pytest.mark.gpu
def test_native_aux_equals_numpy_on_the_bench_batch(cuda):
    from fm_spark_tpu_torch.ops import scatter

    ids = (np.random.default_rng(0).zipf(1.3, (131072, 39))
           % (1 << 18)).astype(np.int32)
    for g, p in zip(scatter.dedup_aux(ids), scatter.dedup_aux_plain(ids)):
        np.testing.assert_array_equal(g, p)
    for g, p in zip(scatter.compact_aux(ids, 12288),
                    scatter.compact_aux_plain(ids, 12288)):
        np.testing.assert_array_equal(g, p)


# ------------------------------------------------------ the captured step


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1,), (7, 3), (12288, 65), (300, 250),
                                   (5000, 369)])
@pytest.mark.parametrize("step", [0, 9, 10**7])
def test_sr_bits_kernel_matches_plain_on_the_card(cuda, shape, step):
    from fm_spark_tpu_torch.ops import srbits

    before = srbits.launches
    got = srbits.sr_bits(3 + 0x5EED, step, 38, shape, cuda)
    from_tensor = srbits.sr_bits(
        3 + 0x5EED, torch.tensor(step, dtype=torch.int32, device=cuda), 38,
        shape, cuda)
    torch.cuda.synchronize()
    assert srbits.launches == before + 2
    want = srbits.sr_bits_plain(3 + 0x5EED, step, 38, shape)
    assert torch.equal(got.cpu(), want) and torch.equal(from_tensor.cpu(), want)


@pytest.mark.gpu
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_fm_bwd_kernel_with_the_device_aux_past_its_cap_on_the_card(cuda, cd):
    """Kernel B on the device-built aux of a batch with fields past the cap
    (compact_device, 'drop'): the lanes with inv >= cap read a zero row
    and write nothing; kernel and plain version each within 1e-5 of the
    segment's sum of |term| from the exact total, the rows past the cap
    untouched by them."""
    from fm_spark_tpu_torch.ops import fused_bwd, scatter, segsum

    rng = np.random.default_rng(7)
    b, f, cap, w = 4000, 5, 700, 65
    ids = (rng.zipf(1.3, (b, f)) % 3000).astype(np.int32)
    ids[:, 2] = rng.permutation(b)                  # far past the cap
    aux, nseg = scatter.device_compact_aux(torch.from_numpy(ids).to(cuda), cap)
    order, inv = aux[3], aux[4]
    assert int(nseg.max()) > cap and bool((inv >= cap).any())
    urows = [torch.from_numpy(rng.normal(size=(cap, w)) * 0.1)
             .to(cuda, torch.bfloat16) for _ in range(f)]
    s1 = torch.from_numpy(rng.normal(size=(b, w))).to(cuda, cd)
    ds = torch.from_numpy(rng.normal(size=b) * 0.1).to(cuda, cd)
    vals = torch.from_numpy(rng.uniform(0.5, 1.5, (b, f))).to(cuda,
                                                              torch.float32)
    weights = torch.ones(b, device=cuda)
    neg_lr = torch.tensor(-0.05, device=cuda)
    args = (urows, s1, ds, vals, weights, order, inv, neg_lr, (1e-4, 1e-5))
    got = fused_bwd.fm_bwd_segment_totals(*args, cap=cap)
    torch.cuda.synchronize()
    want = fused_bwd.fm_bwd_segment_totals_plain(*args, cap=cap)
    terms = fused_bwd.fm_bwd_sorted_deltas(*args, cap=cap)
    exact = torch.stack([segsum.segment_totals_plain(d.double(), s, cap)
                         for d, s in terms])
    bound = 1e-5 * torch.stack([segsum.segment_totals_plain(d.abs().double(),
                                                            s, cap)
                                for d, s in terms])
    assert bool(((got.double() - exact).abs() <= bound).all())
    assert bool(((want.double() - exact).abs() <= bound).all())


def _captured_case(cuda, form):
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.train import TrainConfig

    family, dtype, mode, lever, b, f, bucket, cap = _CAPTURED_FORMS[form]
    kw = dict(num_features=f * bucket, num_fields=f, bucket=bucket,
              init_std=0.05, param_dtype=dtype, compute_dtype="bfloat16")
    spec = (models.FieldFFMSpec(rank=16, **kw) if family == "ffm"
            else models.FieldFMSpec(rank=64, **kw))
    lever = dict(lever)
    if "compact_cap" in lever:
        lever["compact_cap"] = cap
    cfg = TrainConfig(learning_rate=0.05, reg_factors=1e-4, reg_linear=1e-5,
                      reg_bias=1e-6, sparse_update=mode, **lever)
    return spec, cfg


_CAPTURED_FORMS = {
    # family, tables, sparse_update, levers, B, F, bucket, cap
    "compact-segtotal": ("fm", "bfloat16", "dedup_sr", dict(
        host_dedup=True, compact_cap=0, gfull_fused=True,
        segtotal_pallas=True), 4096, 6, 3000, 1500),
    "compact-fusedbwd": ("fm", "bfloat16", "dedup_sr", dict(
        host_dedup=True, compact_cap=0, fused_embed="require"),
        4096, 6, 3000, 1500),
    "compact-plain": ("fm", "bfloat16", "dedup_sr", dict(
        host_dedup=True, compact_cap=0), 4096, 6, 3000, 1500),
    "devaux": ("fm", "bfloat16", "dedup_sr", dict(
        compact_device=True, compact_cap=0, gfull_fused=True,
        segtotal_pallas=True), 4096, 6, 3000, 1500),
    "devaux-drop-fusedbwd": ("fm", "bfloat16", "dedup_sr", dict(
        compact_device=True, compact_cap=0, compact_overflow="drop",
        fused_embed="require"), 4096, 6, 3000, 300),
    "lane-dedup-sr": ("fm", "bfloat16", "dedup_sr", {}, 4096, 6, 3000, 0),
    "fm-pallas": ("fm", "float32", "scatter_add", dict(use_pallas=True),
                  4096, 6, 3000, 0),
    "ffm-selblk-pallas-rows": ("ffm", "float32", "scatter_add", dict(
        use_pallas=True, sel_blocked=True, fused_embed="require"),
        2048, 5, 500, 0),
}


def _captured_batches(cuda, form, n, cfg):
    from fm_spark_tpu_torch.ops import scatter

    _, _, _, _, b, f, bucket, cap = _CAPTURED_FORMS[form]
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        ids = (rng.zipf(1.3, (b, f)) % bucket).astype(np.int32)
        batch = [torch.from_numpy(a).to(cuda) for a in (
            ids, rng.uniform(0.5, 1.5, (b, f)).astype(np.float32),
            rng.integers(0, 2, b).astype(np.float32),
            (rng.random(b) > 0.05).astype(np.float32))]
        aux = None
        if cfg.host_dedup:
            aux = tuple(torch.from_numpy(a).to(cuda)
                        for a in scatter.compact_aux(ids, cap))
        out.append((*batch, aux))
    return out


def _same_params(a, b):
    def bits(t):
        return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                                   else torch.int32)

    return (torch.equal(bits(a["w0"]), bits(b["w0"]))
            and all(torch.equal(bits(x), bits(y))
                    for x, y in zip(a["vw"], b["vw"])))


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(_CAPTURED_FORMS))
def test_captured_step_equals_the_eager_step_on_the_card(cuda, form):
    """Three steps of the captured step (one CUDA graph, replayed) against
    the eager body on a copy of the same params: the same bits after every
    step; a call with other params tensors captures anew."""
    from fm_spark_tpu_torch import sparse

    spec, cfg = _captured_case(cuda, form)
    ffm = _CAPTURED_FORMS[form][0] == "ffm"
    body = (sparse.make_field_ffm_sparse_sgd_body if ffm
            else sparse.make_field_sparse_sgd_body)(spec, cfg)
    step = (sparse.make_field_ffm_sparse_sgd_step if ffm
            else sparse.make_field_sparse_sgd_step)(spec, cfg)
    eager = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    graphed = {"w0": eager["w0"].clone(),
               "vw": [t.clone() for t in eager["vw"]]}
    for i, batch in enumerate(_captured_batches(cuda, form, 3, cfg)):
        eager, le = body(eager, i, *batch)
        graphed, lc = step(graphed, i, *batch)
        torch.cuda.synchronize()
        assert torch.equal(le.view(torch.int32), lc.view(torch.int32)), i
        assert _same_params(eager, graphed), i
    assert len(step.captured.capture_s) == 1
    other = {"w0": eager["w0"].clone(), "vw": [t.clone() for t in eager["vw"]]}
    batch = _captured_batches(cuda, form, 1, cfg)[0]
    eager, le = body(eager, 3, *batch)
    other, lc = step(other, 3, *batch)
    torch.cuda.synchronize()
    assert len(step.captured.capture_s) == 2
    assert torch.equal(le, lc) and _same_params(eager, other)


@pytest.mark.gpu
def test_counters_count_the_warm_up_and_no_replay_on_the_card(cuda):
    """A captured step's first call launches its kernels once, in the
    warm-up on clones of the params; the capture records them and the
    replays launch them past the wrappers, so neither counts."""
    from fm_spark_tpu_torch import ops, sparse

    form = "compact-segtotal"
    spec, cfg = _captured_case(cuda, form)
    step = sparse.make_field_sparse_sgd_step(spec, cfg)
    params = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    batches = _captured_batches(cuda, form, 3, cfg)
    before = ops.kernel_launches()
    params, _ = step(params, 0, *batches[0])
    torch.cuda.synchronize()
    first = ops.kernel_launches()
    for i, batch in enumerate(batches[1:], 1):
        params, _ = step(params, i, *batch)
    torch.cuda.synchronize()
    f = spec.num_fields
    assert first["segment_totals"] - before["segment_totals"] == f
    assert first["sr_bits"] - before["sr_bits"] == f
    assert ops.kernel_launches() == first


@pytest.mark.gpu
@pytest.mark.parametrize("shape, dim", [((256, 512, 65), 1), ((256, 65), 0),
                                        ((40, 3), 0), ((7, 33, 2), 1)])
def test_xla_order_prefix_on_the_card_equals_the_cpu(cuda, shape, dim):
    """The compact update's blocked prefix (``scatter._prefix_f32``): its
    runs of 16 are one cumsum on the card and sequential adds on the CPU,
    the same float32 sums bit for bit, a −0.0 first element kept."""
    from fm_spark_tpu_torch.ops import scatter

    rng = np.random.default_rng(11)
    x = rng.normal(size=shape).astype(np.float32)
    x[(0,) * len(shape)] = -0.0
    x.reshape(-1)[::5] *= 1e-6
    want = scatter._prefix_f32(torch.from_numpy(x), dim)
    got = scatter._prefix_f32(torch.from_numpy(x).to(cuda), dim)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))


@pytest.mark.gpu
def test_captured_roll_equals_the_eager_steps_on_the_card(cuda):
    """A roll of n = 4 over 7 steps: a graph of 4 steps and one of the tail
    of 3, against 7 eager steps, the same bits."""
    from fm_spark_tpu_torch import sparse

    form = "compact-fusedbwd"
    spec, cfg = _captured_case(cuda, form)
    body = sparse.make_field_sparse_sgd_body(spec, cfg)
    mstep = sparse.make_field_sparse_multistep(spec, cfg, 4)
    eager = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    graphed = {"w0": eager["w0"].clone(),
               "vw": [t.clone() for t in eager["vw"]]}
    batches = _captured_batches(cuda, form, 7, cfg)
    losses = []
    for i, batch in enumerate(batches):
        eager, loss = body(eager, 2 + i, *batch)
        losses.append(loss)
    got = []
    for lo, hi in ((0, 4), (4, 7)):
        group = batches[lo:hi]
        stacked = [torch.stack(parts) for parts in zip(*[g[:4] for g in group])]
        aux = tuple(torch.stack(a) for a in zip(*[g[4] for g in group]))
        graphed, loss = mstep(graphed, 2 + lo, hi - lo, *stacked, aux)
        got.append(loss)
    torch.cuda.synchronize()
    assert len(mstep.captured.capture_s) == 2
    assert torch.equal(got[0], losses[3]) and torch.equal(got[1], losses[6])
    assert _same_params(eager, graphed)


@pytest.mark.gpu
@pytest.mark.parametrize("form, steps_per_call, stop", [
    ("compact-fusedbwd", 1, 3), ("compact-segtotal", 2, 2),
    ("ffm-selblk-pallas-rows", 1, 3)])
def test_captured_resume_equals_the_uninterrupted_run_on_the_card(
        cuda, tmp_path, form, steps_per_call, stop):
    """fit_field_sparse with a checkpoint chain: 6 steps uninterrupted,
    against ``stop`` steps into a fresh chain and the same call at 6,
    which resumes; the resumed run's steps are replays of graphs it
    captured after the restore, and its losses and final params equal the
    uninterrupted run's bit for bit (the witness that those graphs read
    the restored tensors)."""
    import dataclasses

    from fm_spark_tpu_torch import data
    from fm_spark_tpu_torch.checkpoint import Checkpointer
    from fm_spark_tpu_torch.train import fit_field_sparse

    spec, cfg = _captured_case(cuda, form)
    _, _, _, _, b, f, bucket, _ = _CAPTURED_FORMS[form]
    rng = np.random.default_rng(5)
    n = 5 * b // 2                        # an epoch of 2.5 batches
    ids = (rng.zipf(1.3, (n, f)) % bucket).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, (n, f)).astype(np.float32)
    labels = rng.integers(0, 2, n).astype(np.float32)

    def fit(steps, chain):
        stats = {}
        params = fit_field_sparse(
            spec, dataclasses.replace(cfg, num_steps=steps, batch_size=b),
            data.Batches(ids, vals, labels, b, seed=3), device=cuda,
            steps_per_call=steps_per_call, stats=stats,
            checkpointer=Checkpointer(str(tmp_path / chain), save_every=2))
        return params, stats

    full, s_full = fit(6, "full")
    _, s_part = fit(stop, "resumed")
    rest, s_rest = fit(6, "resumed")
    assert s_part["resumed"] is None and s_rest["resumed"]["step"] == stop
    assert len(s_rest["capture_s"]) >= 1
    calls = len(s_rest["loss"])
    assert s_rest["loss"] == s_full["loss"][-calls:]
    assert _same_params(full, rest)


# FieldDeepFM (config 5): the hybrid step's forms, with B, F, bucket, cap.
_DEEPFM_FORMS = {
    "recipe": ("bfloat16", dict(sparse_update="dedup_sr", host_dedup=True,
                                compact_cap=2048)),
    "segtotal": ("bfloat16", dict(sparse_update="dedup_sr", host_dedup=True,
                                  compact_cap=2048, gfull_fused=True,
                                  segtotal_pallas=True)),
    "use-pallas": ("bfloat16", dict(sparse_update="dedup_sr",
                                    use_pallas=True)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("form", list(_DEEPFM_FORMS))
def test_deepfm_captured_step_and_roll_equal_eager_on_the_card(cuda, form):
    """Three steps of FieldDeepFM's captured step (one CUDA graph over the
    params and Adam's state) against the eager body on a copy: the loss,
    the params and Adam's moments and count the same bits after every
    step; then the roll of n = 2 over three steps the same."""
    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.graphs import _clone
    from fm_spark_tpu_torch.models.io import flatten
    from fm_spark_tpu_torch.ops import scatter
    from fm_spark_tpu_torch.train import TrainConfig

    dt, lever = _DEEPFM_FORMS[form]
    b, f, bucket = 4096, 6, 3000
    spec = models.FieldDeepFMSpec(
        num_features=f * bucket, rank=16, num_fields=f, bucket=bucket,
        mlp_dims=(64, 64, 64), param_dtype=dt, compute_dtype=dt)
    cfg = TrainConfig(learning_rate=1e-3, lr_schedule="constant",
                      optimizer="adam", reg_factors=1e-6, **lever)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(3):
        ids = (rng.zipf(1.3, (b, f)) % bucket).astype(np.int32)
        aux = (tuple(torch.from_numpy(a).to(cuda) for a in
                     scatter.compact_aux(ids, cfg.compact_cap))
               if cfg.host_dedup else None)
        batches.append((*(torch.from_numpy(a).to(cuda) for a in (
            ids, np.ones((b, f), np.float32),
            (rng.random(b) < 0.25).astype(np.float32),
            np.ones(b, np.float32))), aux))

    def bits(tree):
        return [t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16
                                    else torch.int32)
                for t in flatten(tree).values()]

    def same(a, c):
        return all(torch.equal(x, y) for x, y in zip(bits(a), bits(c)))

    body, init = sparse.make_field_deepfm_sparse_body(spec, cfg)
    step = sparse.make_field_deepfm_sparse_step(spec, cfg)
    eager = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    graphed, rolled = _clone(eager), _clone(eager)
    oe, og = init(eager), step.init_opt_state(graphed)
    for i, batch in enumerate(batches):
        eager, oe, le = body(eager, oe, i, *batch)
        graphed, og, lc = step(graphed, og, i, *batch)
        torch.cuda.synchronize()
        assert torch.equal(le.view(torch.int32), lc.view(torch.int32)), i
        assert same(eager, graphed) and same(oe, og), i
    assert len(step.captured.capture_s) == 1 and int(og["count"]) == 3
    # The roll from the start: a graph of 2 steps and one of the tail.
    mstep = sparse.make_field_deepfm_multistep(spec, cfg, 2)
    orl = mstep.init_opt_state(rolled)
    losses = []
    for lo, hi in ((0, 2), (2, 3)):
        group = batches[lo:hi]
        stacked = [torch.stack(p) for p in zip(*[g[:4] for g in group])]
        aux = (tuple(torch.stack(a) for a in zip(*[g[4] for g in group]))
               if cfg.host_dedup else None)
        rolled, orl, loss = mstep(rolled, orl, lo, hi - lo, *stacked, aux)
        losses.append(loss)
    torch.cuda.synchronize()
    assert torch.equal(losses[-1], le)
    assert same(rolled, eager) and same(orl, oe)


def _flat_fm_case(cuda, pd, seed=0):
    from fm_spark_tpu_torch import models

    spec = models.FMSpec(num_features=3000, rank=32, param_dtype=pd,
                         compute_dtype="float32", init_std=0.1)
    rng = np.random.default_rng(seed)
    batches = []
    for _ in range(3):
        ids = (np.arange(39) * 70 + rng.zipf(1.3, (1024, 39)) % 70)
        ids[0, 0], ids[1, 1] = -5, 3007            # JAX's index rules
        batches.append([torch.from_numpy(a).to(cuda) for a in (
            ids.astype(np.int32), np.ones((1024, 39), np.float32),
            rng.integers(0, 2, 1024).astype(np.float32),
            (rng.random(1024) > 0.1).astype(np.float32))])
    params = spec.init(torch.Generator(device=cuda).manual_seed(seed), cuda)
    return spec, params, batches


def _clone_tree(tree):
    return {k: v.clone() for k, v in tree.items()}


@pytest.mark.gpu
@pytest.mark.parametrize("pd", ["float32", "bfloat16"])
@pytest.mark.parametrize("form", ["dense", "flat-sparse"])
def test_flat_fm_step_repeats_and_captures_bit_for_bit_on_the_card(cuda, form,
                                                                   pd):
    """The flat FM's dense step (and its sparse step) on the card: the
    eager body run twice on copies of the same params gives the same bits
    (the dedup's sums by kernel A, no atomics), the captured step equals
    the eager one bit for bit, each eager step launches kernel A once and
    the replays none past the wrapper; and the card's params stay within
    float32 reassociation of the plain CPU run."""
    from fm_spark_tpu_torch import sparse, train
    from fm_spark_tpu_torch.ops import segsum

    spec, p0, batches = _flat_fm_case(cuda, pd)
    cfg = train.TrainConfig(learning_rate=0.05, reg_bias=1e-3,
                            reg_linear=1e-5, reg_factors=1e-4)
    runs = {}
    for name in ("eager1", "eager2", "captured", "cpu"):
        dev = torch.device("cpu") if name == "cpu" else cuda
        params = {k: v.to(dev) for k, v in _clone_tree(p0).items()}
        losses = []
        if form == "dense":
            opt = train.make_optimizer(cfg)
            state = opt.init(params)
            step = train.make_train_step(spec, cfg, opt)
            for b in batches:
                b = [t.to(dev) for t in b]
                if name.startswith("eager"):
                    before = segsum.launches
                    losses.append(step.body(params, state, *b)[0])
                    assert segsum.launches == before + 1
                else:
                    losses.append(step(params, state, *b)[2]["loss"])
        else:
            step = sparse.make_sparse_sgd_step(spec, cfg)
            for i, b in enumerate(batches):
                b = [t.to(dev) for t in b]
                fn = step.body if name.startswith("eager") else step
                losses.append(fn(params, i, *b)[1])
        if name == "captured":
            before = segsum.launches
            losses.append((step(params, state, *batches[0])[2]["loss"]
                           if form == "dense" else
                           step(params, 3, *batches[0])[1]))
            assert segsum.launches == before         # replays only
            assert len(step.captured.capture_s) == 1
        else:
            losses.append((step.body(params, state, *[
                t.to(dev) for t in batches[0]])[0] if form == "dense" else
                step.body(params, 3, *[t.to(dev) for t in batches[0]])[1]))
        torch.cuda.synchronize()
        runs[name] = (params, torch.stack(losses).cpu())
    for name in ("eager2", "captured"):
        assert torch.equal(runs[name][1], runs["eager1"][1]), name
        for key in ("w0", "w", "v"):
            assert torch.equal(runs[name][0][key], runs["eager1"][0][key]), \
                (name, key)
    if pd == "float32":
        for key in ("w0", "w", "v"):
            torch.testing.assert_close(runs["eager1"][0][key].cpu(),
                                       runs["cpu"][0][key], rtol=1e-5,
                                       atol=1e-6)


def _native_stream_batches(tmp_path, n_batches, b, bucket):
    """``n_batches`` batches of ``b`` rows of a small dirty Criteo TSV
    parsed by the native stream (quarantine), with field-local ids."""
    from fm_spark_tpu_torch.cli import _field_local_rows
    from fm_spark_tpu_torch.data import criteo
    from fm_spark_tpu_torch.data.native_stream import NativeStreamBatches
    from fm_spark_tpu_torch.data.stream import RecordGuard, ShardReader

    path = str(tmp_path / "day.tsv")
    criteo.synthesize_tsv(path, n_batches * b + 40, seed=3)
    with open(path, "rb") as f:
        lines = f.read().splitlines()
    for i in range(5, len(lines), 97):
        lines[i] = b"x" + lines[i][1:]                # a bad label
    with open(path, "wb") as f:
        f.write(b"\n".join(lines) + b"\n")
    src = NativeStreamBatches(
        ShardReader([path]), "criteo", b, 39,
        guard=RecordGuard("quarantine", str(tmp_path / "q")),
        num_features=39 * bucket, bucket=bucket)
    out = [_field_local_rows(src.next_batch(), bucket)
           for _ in range(n_batches)]
    assert src.guard.n_bad > 0
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["fusedbwd", "col-segtotal", "unfused"])
def test_native_parsed_batches_train_on_the_card_as_the_plain_versions(
        cuda, tmp_path, form):
    """Batches parsed by the native stream trained by FieldFM's step on
    the card: the captured step equals the eager one bit for bit, the
    eager step launches the form's kernel, and the card's params stay
    within float32 reassociation of the CPU run (the kernels' plain
    versions)."""
    from fm_spark_tpu_torch import models, ops, sparse, train
    from fm_spark_tpu_torch.ops import scatter

    bucket, b, cap = 64, 512, 64
    batches = _native_stream_batches(tmp_path, 3, b, bucket)
    spec_kw = {"fusedbwd": {}, "col-segtotal": dict(table_layout="col"),
               "unfused": dict(fused_linear=False)}[form]
    cfg_kw = {"fusedbwd": dict(sparse_update="dedup", host_dedup=True,
                               compact_cap=cap, fused_embed="require"),
              "col-segtotal": dict(sparse_update="dedup", host_dedup=True,
                                   compact_cap=cap, segtotal_pallas=True),
              "unfused": dict(sparse_update="scatter_add")}[form]
    kernel = {"fusedbwd": "fm_bwd_segment_totals"}.get(form,
                                                       "segment_totals")
    spec = models.FieldFMSpec(num_features=39 * bucket, rank=8,
                              num_fields=39, bucket=bucket, init_std=0.1,
                              **spec_kw)
    cfg = train.TrainConfig(learning_rate=0.05, reg_factors=1e-4,
                            reg_linear=1e-5, reg_bias=1e-6, **cfg_kw)
    p0 = spec.init(torch.Generator().manual_seed(0), device="cpu")
    runs = {}
    for name in ("eager", "captured", "cpu"):
        dev = torch.device("cpu") if name == "cpu" else cuda
        params = {k: ([t.to(dev).clone() for t in v] if isinstance(v, list)
                      else v.to(dev).clone()) for k, v in p0.items()}
        body = sparse.make_field_sparse_sgd_body(spec, cfg)
        step = sparse.make_field_sparse_sgd_step(spec, cfg)
        losses = []
        for i, batch in enumerate(batches):
            aux = (tuple(torch.from_numpy(a).to(dev)
                         for a in scatter.compact_aux(batch[0], cap))
                   if cfg.host_dedup else None)
            args = [torch.from_numpy(a).to(dev) for a in batch]
            before = ops.kernel_launches()[kernel]
            fn = step if name == "captured" else body
            params, loss = fn(params, i, *args, aux)
            if name == "eager":
                assert ops.kernel_launches()[kernel] > before
            losses.append(loss)
        torch.cuda.synchronize()
        runs[name] = (params, torch.stack(losses).cpu())
    assert torch.equal(runs["captured"][1], runs["eager"][1])
    assert _same_tree(runs["captured"][0], runs["eager"][0])
    torch.testing.assert_close(runs["eager"][1], runs["cpu"][1], rtol=1e-5,
                               atol=1e-6)
    from fm_spark_tpu_torch.graphs import _leaves

    for got, want in zip(_leaves(runs["eager"][0]), _leaves(runs["cpu"][0])):
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("form", [dict(table_layout="col"),
                                  dict(fused_linear=False)])
def test_library_path_scores_on_the_card(cuda, form):
    """FieldFM's col and unfused scores on the card: the library path
    (counted under its name, never under the kernel's) within the
    forward's tolerance of the CPU."""
    from fm_spark_tpu_torch import models, ops
    from fm_spark_tpu_torch.ops import fused_fwd

    spec = models.FieldFMSpec(num_features=39 * 64, rank=8, num_fields=39,
                              bucket=64, init_std=0.1, **form)
    params = spec.init(torch.Generator().manual_seed(1), device="cpu")
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, 64, (300, 39)).astype(np.int32))
    vals = torch.from_numpy(rng.random((300, 39)).astype(np.float32))
    want = spec.scores(params, ids, vals)
    on = {k: ([t.to(cuda) for t in v] if isinstance(v, list) else v.to(cuda))
          for k, v in params.items()}
    lib0 = ops.library_calls()["field_fm_scores_library"]
    launches0 = fused_fwd.launches
    got = spec.scores(on, ids.to(cuda), vals.to(cuda)).cpu()
    assert ops.library_calls()["field_fm_scores_library"] == lib0 + 1
    assert fused_fwd.launches == launches0
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------ the tiered store on the card


def _tier_case(cuda, optimizer, n_steps, window=8):
    """A tiered trainer on the card (4,096 rows in buckets of 64, a hot
    tier of 16 buckets) and ``n_steps`` churned batches of 512 rows × 8
    ids over a ``window``-bucket window drifting one bucket a step: 4,096
    lanes a step, ~8 per distinct id, so kernel A's tiles cut through
    many segments."""
    from fm_spark_tpu_torch import models
    from fm_spark_tpu_torch.embed import TieredTrainer
    from fm_spark_tpu_torch.train import TrainConfig

    spec = models.FMSpec(num_features=4096, rank=8, init_std=0.05)
    cfg = TrainConfig(batch_size=512, learning_rate=0.05,
                      lr_schedule="constant", optimizer=optimizer,
                      embed_tier="require", hot_rows=16 * 64,
                      embed_bucket_rows=64, seed=3)
    rng = np.random.default_rng(5)
    batches = []
    for i in range(n_steps):
        b = rng.integers(0, window, (512, 8)) + i % (64 - window)
        batches.append(((b * 64 + rng.integers(0, 64, (512, 8))).astype(
            np.int64), rng.standard_normal((512, 8)).astype(np.float32),
            (rng.random(512) < 0.3).astype(np.float32),
            np.ones(512, np.float32)))
    return spec, cfg, TieredTrainer(spec, cfg, device=cuda), batches


def _untiered(cuda, spec, cfg, trainer, batches):
    """The captured in-memory step over the same batches from the tiered
    trainer's init (its dense cold planes): ``(losses, planes)``."""
    import dataclasses

    from fm_spark_tpu_torch import optim, sparse

    off = dataclasses.replace(cfg, embed_tier="off")
    cold = trainer.store.cold
    params = {"w0": torch.zeros((), device=cuda),
              "w": torch.from_numpy(cold.dense_plane("w").copy()).to(cuda),
              "v": torch.from_numpy(cold.dense_plane("v").copy()).to(cuda)}
    losses = []
    if cfg.optimizer == "sgd":
        step = sparse.make_sparse_sgd_step(spec, off)
        for i, b in enumerate(batches):
            losses.append(float(step(params, i, *[
                torch.from_numpy(a).to(cuda) for a in b])[1]))
        return losses, {k: v.cpu().numpy() for k, v in params.items()}
    slots = optim.init_adaptive_slots(cfg.optimizer, spec, params)
    if cfg.optimizer == "ftrl":
        optim.seed_ftrl_slots(slots, params, cfg.learning_rate, 1.0)
    step = optim.make_sparse_adaptive_step(spec, off)
    for b in batches:
        losses.append(float(step(params, slots, *[
            torch.from_numpy(a).to(cuda) for a in b])[2]))
    planes = {k: v.cpu().numpy() for k, v in params.items()}
    for table, d in slots.items():
        for key, t in d.items():
            planes[f"{table}_{key}"] = t.cpu().numpy()
    return losses, planes


@pytest.mark.gpu
@pytest.mark.parametrize("optimizer", ["sgd", "ftrl"])
def test_tiered_step_needs_the_global_dedup_keys_on_the_card(cuda, optimizer):
    """Kernel A adds each id's lanes in an order set by where its segment
    sits among the sorted lanes. Keyed by the hot-local ids (the reference's
    relabelling) the tiered step's sums round otherwise than the untiered
    step's: the fault. Keyed by the global ids (the port's design) the
    tiered run equals the untiered one bit for bit: losses, the merged
    planes and the slot planes."""
    spec, cfg, trainer, batches = _tier_case(cuda, optimizer, 12)
    want_losses, want = _untiered(cuda, spec, cfg, trainer, batches)
    # The tiered step by hand with local keys: the dedup sorts by the
    # hot-local ids.
    _, _, local_tr, _ = _tier_case(cuda, optimizer, 0)
    local_losses = []
    for b in batches:
        local_ids, _ = local_tr.store.begin_batch(b[0], local_tr.hot)
        args = [local_tr._tensor(a) for a in (local_ids, *b[1:])]
        if optimizer == "sgd":
            out = local_tr._step(local_tr._params, len(local_losses), *args)
        else:
            out = local_tr._step(local_tr._params, local_tr._slots, *args)
        local_losses.append(float(out[-1]))
    local = local_tr.merged_params()
    assert local_losses != want_losses or any(
        not np.array_equal(local[k], want[k]) for k in ("w", "v"))
    got_losses = [trainer.step_batch(*b) for b in batches]
    assert trainer.store.stats()["evictions"] > 0
    assert got_losses == want_losses
    got = {**trainer.merged_params(), **{
        f"{t}_{k}": v for t, d in (trainer.merged_slots() or {}).items()
        for k, v in d.items()}}
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.gpu
def test_hot_planes_keep_their_storage_and_one_capture_on_the_card(cuda):
    """40 churned steps through the prefetcher: every hot plane keeps its
    storage and the step is captured once (installs, flushes and the
    restore work in place)."""
    _, _, trainer, batches = _tier_case(cuda, "ftrl", 40)
    ptrs = {p: t.data_ptr() for p, t in trainer.hot.items()}
    trainer.fit(iter(batches), num_steps=40, prefetch=2)
    st = trainer.store.stats()
    assert st["evictions"] > 0 and st["staged_hits"] > 0
    assert {p: t.data_ptr() for p, t in trainer.hot.items()} == ptrs
    assert len(trainer._step.captured.capture_s) == 1
    trainer.store.restore_cold({p: trainer.store.cold.dense_plane(p).copy()
                                for p in trainer.store.cold.plane_names})
    trainer.step_batch(*batches[0])
    assert {p: t.data_ptr() for p, t in trainer.hot.items()} == ptrs
    assert len(trainer._step.captured.capture_s) == 1


@pytest.mark.gpu
def test_staged_copy_lands_only_after_its_event_on_the_card(cuda):
    """A staged bucket whose copy is held back on the staging stream (a
    sleep queued before it) is installed only after the copy's event: the
    hot rows read the cold rows, never the device buffer's old bytes."""
    from fm_spark_tpu_torch.embed import ColdStore, TieredStore

    rows = np.arange(64 * 8 * 4, dtype=np.float32).reshape(-1, 4)
    cold = ColdStore.dense({"v": rows.copy()}, 64)
    store = TieredStore(cold, 2, device=cuda)
    hot = store.init_hot()
    hot["v"].fill_(-1.0)
    side = store._stream("stage")
    with torch.cuda.stream(side):
        torch.cuda._sleep(200_000_000)          # ~0.1 s of the side stream
    assert store.stage(np.array([3 * 64 + 5])) == 1
    local, hot = store.begin_batch(np.array([3 * 64 + 5, 3 * 64]), hot)
    assert store.stats()["staged_hits"] == 1
    got = hot["v"][torch.from_numpy(local).to(cuda)].cpu().numpy()
    assert np.array_equal(got, rows[[3 * 64 + 5, 3 * 64]])


# ----------------------------------------- the obs plane on the card


#: The kernel symbols of config 3's captured step (``chip_smoke.py``'s
#: ``KERNEL_SYMBOLS``): kernel B's first pass and the SR bits.
_STEP_SYMBOLS = ("bwd_first_pass", "sr_bits_kernel")


@pytest.mark.gpu
def test_the_profiled_train_run_names_its_kernels_on_the_card(cuda, tmp_path,
                                                              capsys):
    """``fmtorch train --profile`` of a narrow config 3 (bf16, dedup_sr,
    the compact host aux, kernel B): the Chrome trace names the captured
    step's kernels by symbol, the loss lines are finite, and the run dir
    holds the window spans."""
    import json

    from fm_spark_tpu_torch import cli

    prof = str(tmp_path / "prof")
    assert cli.main([
        "train", "--config", "criteo1tb_fm_r64", "--bucket", "1024",
        "--synthetic", "8192", "--steps", "4", "--batch-size", "2048",
        "--param-dtype", "bfloat16", "--compute-dtype", "bfloat16",
        "--sparse-update", "dedup_sr", "--host-dedup", "--compact-cap",
        "1024", "--fused-embed", "require", "--test-fraction", "0",
        "--obs-dir", str(tmp_path / "obs"), "--profile", prof]) == 0
    out = [json.loads(x) for x in capsys.readouterr().out.splitlines()
           if x.startswith("{")]
    losses = [x["loss"] for x in out if "loss" in x]
    assert len(losses) == 4 and np.isfinite(losses).all()
    with open(os.path.join(prof, "trace.json")) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    for sym in _STEP_SYMBOLS:
        assert any(sym in n for n in names), sym


@pytest.mark.gpu
def test_the_slo_trigger_fires_on_a_replay_on_the_card(cuda, tmp_path):
    """A ``serve_request`` deadline below one replay's time: the batch
    replayed through its graph fails with ``HangDetected``, the overrun
    is counted and its capture bundle is written; with the deadline
    cleared the same graph answers as before."""
    from fm_spark_tpu_torch import models, obs
    from fm_spark_tpu_torch.obs import introspect
    from fm_spark_tpu_torch.resilience import watchdog
    from fm_spark_tpu_torch.serve import PredictEngine

    spec = models.FieldFMSpec(num_features=39 * 4096, rank=64,
                              num_fields=39, bucket=4096)
    params = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    run = str(tmp_path / "run")
    obs.configure(run)
    introspect.configure(run, profile=False)
    eng = PredictEngine(spec, params, buckets=(64,), latency_budget_ms=0.0,
                        device=cuda)
    try:
        eng.warmup()
        rng = np.random.default_rng(0)
        ids = rng.integers(0, 4096, (64, 39)).astype(np.int32)
        vals = np.ones((64, 39), np.float32)
        want = eng.predict(ids, vals)
        watchdog.configure({"serve_request": 1e-7}, action="raise")
        with pytest.raises(watchdog.HangDetected):
            eng.predict(ids, vals)
        watchdog.clear()
        assert np.array_equal(eng.predict(ids, vals), want)
        assert eng.graph_replays == 3
        assert obs.counter("serve.slo_overruns_total").value == 1
        caps = introspect.list_captures(run)
        assert [c["trigger"] for c in caps] == ["serve_slo_overrun"]
    finally:
        watchdog.clear()
        eng.close()
        obs.shutdown()


@pytest.mark.gpu
def test_a_step_captures_under_the_profiler_on_the_card(cuda):
    """A training step captured while a ``torch.profiler`` session (CPU
    and CUDA activity, as ``--profile`` runs it) is active gives the same
    bits as one captured without it, and its replays run the step's
    kernels by symbol in the trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from fm_spark_tpu_torch import models, train
    from fm_spark_tpu_torch.graphs import _clone

    spec = models.FMSpec(num_features=20000, rank=8, init_std=0.1)
    rng = np.random.default_rng(1)
    batches = [[torch.from_numpy(a).to(cuda) for a in (
        (rng.zipf(1.3, (2048, 39)) % 20000).astype(np.int32),
        np.ones((2048, 39), np.float32),
        rng.integers(0, 2, 2048).astype(np.float32),
        np.ones(2048, np.float32))] for _ in range(3)]
    p0 = spec.init(torch.Generator(device=cuda).manual_seed(0), cuda)
    runs = []
    for profiled in (False, True):
        cfg = train.TrainConfig(learning_rate=0.05)
        step = train.make_train_step(spec, cfg)
        p = _clone(p0)
        s = train.make_optimizer(cfg).init(p)
        ctx = (profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
               if profiled else None)
        if ctx is not None:
            ctx.__enter__()
        try:
            losses = [step(p, s, *b)[2]["loss"] for b in batches]
            torch.cuda.synchronize()
        finally:
            if ctx is not None:
                ctx.__exit__(None, None, None)
        assert len(step.captured.capture_s) == 1
        runs.append((p, torch.stack(losses).cpu()))
    assert torch.equal(runs[0][1], runs[1][1])
    assert _same_tree(runs[0][0], runs[1][0])
    names = [e.name for e in ctx.events() if e.device_type == DeviceType.CUDA]
    assert sum("first_pass" in n for n in names) >= 2   # kernel A, replayed


# ------------------------------------------ torch.distributed at world 1


@pytest.fixture
def nccl_world_1(cuda):
    """An NCCL process group of one rank on the card, left after the
    test."""
    import socket

    import torch.distributed as dist

    from fm_spark_tpu_torch import parallel

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    parallel.init_distributed(cuda, coordinator=f"127.0.0.1:{port}",
                              num_processes=1, process_id=0, timeout_s=120)
    yield cuda
    dist.destroy_process_group()


@pytest.mark.gpu
@pytest.mark.parametrize("form", ["device-compact-sr", "lane-dedup",
                                  "score-sharded-bf16-wire"])
def test_sharded_step_replays_equal_eager_on_the_card(nccl_world_1, form):
    """The field-sharded FieldFM step at world 1 under NCCL: its captured
    replays (the all_to_all, gathers and all_reduce recorded in the graph)
    equal its eager body on a copy of the params bit for bit, and equal
    the single-card captured step (but the bf16 wire's rounding)."""
    from fm_spark_tpu_torch import graphs, models, parallel, sparse
    from fm_spark_tpu_torch.train import TrainConfig

    dev = nccl_world_1
    lever = {"device-compact-sr": dict(
        sparse_update="dedup_sr", compact_device=True, compact_cap=512,
        segtotal_pallas=True, gfull_fused=True),
        "lane-dedup": dict(sparse_update="dedup"),
        "score-sharded-bf16-wire": dict(sparse_update="dedup",
                                        score_sharded=True,
                                        collective_dtype="bfloat16")}[form]
    spec = models.FieldFMSpec(num_features=7 * 1024, num_fields=7,
                              bucket=1024, rank=16, init_std=0.05,
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    cfg = TrainConfig(learning_rate=0.05, **lever)
    mesh = parallel.make_field_mesh(device=dev)
    p0 = spec.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    p1 = parallel.shard_field_params(parallel.stack_field_params(spec, p0, 1),
                                     mesh)
    p2 = graphs._clone(p1)
    step = parallel.make_field_sharded_sgd_step(spec, cfg, mesh)
    single = sparse.make_field_sparse_sgd_step(
        spec, TrainConfig(learning_rate=0.05, **{
            k: v for k, v in lever.items()
            if k not in ("score_sharded", "collective_dtype")}))
    rng = np.random.default_rng(1)
    for i in range(4):
        b = [torch.from_numpy(a).to(dev) for a in (
            (rng.zipf(1.3, (512, 7)) % 1024).astype(np.int32),
            np.ones((512, 7), np.float32),
            (rng.random(512) < 0.3).astype(np.float32),
            np.ones(512, np.float32))]
        _, l1 = step(p1, i, *b)
        _, l2 = step.body(p2, i, *b)
        _, l0 = single(p0, i, *b)
        assert torch.equal(l1, l2)
        assert torch.equal(p1["vw"], p2["vw"])
        if form != "score-sharded-bf16-wire":
            assert torch.equal(l0, l1)
            assert all(torch.equal(p0["vw"][f], p1["vw"][f])
                       for f in range(7))
    assert step.captured.capture_s
    # The canonical tables by the all-gather and by NCCL's gather to rank
    # 0's host memory.
    full = parallel.gather_field_params(spec, p1, mesh)
    host = parallel.gather_field_params(spec, p1, mesh, root=0)
    assert all(torch.equal(full["vw"][f], p1["vw"][f])
               and torch.equal(host["vw"][f], p1["vw"][f].cpu())
               for f in range(7))


@pytest.mark.gpu
def test_bf16_tier_equals_untiered_on_the_card(cuda):
    """The tier's bf16 planes against the untiered bf16 step on the card,
    12 churned steps of SGD: losses and merged planes bit for bit."""
    import dataclasses

    from fm_spark_tpu_torch.embed import TieredTrainer
    from fm_spark_tpu_torch.embed.store import to_host

    spec, cfg, _, batches = _tier_case(cuda, "sgd", 12)
    spec = dataclasses.replace(spec, param_dtype="bfloat16")
    trainer = TieredTrainer(spec, cfg, device=cuda)
    from fm_spark_tpu_torch import sparse

    off = dataclasses.replace(cfg, embed_tier="off")
    cold = trainer.store.cold
    from fm_spark_tpu_torch.embed.store import from_host

    params = {"w0": torch.zeros((), device=cuda),
              "w": from_host(cold.dense_plane("w").copy()).to(cuda),
              "v": from_host(cold.dense_plane("v").copy()).to(cuda)}
    step = sparse.make_sparse_sgd_step(spec, off)
    want = [float(step(params, i, *[torch.from_numpy(a).to(cuda)
                                    for a in b])[1])
            for i, b in enumerate(batches)]
    got = [trainer.step_batch(*b) for b in batches]
    assert trainer.store.stats()["evictions"] > 0
    assert got == want
    merged = trainer.merged_params()
    for k in ("w", "v"):
        assert np.array_equal(merged[k], to_host(params[k].cpu())), k
