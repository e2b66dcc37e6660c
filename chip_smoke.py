"""Smoke run of the PyTorch/CUDA port (``fm_spark_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card::

    python3 chip_smoke.py

Phases (any failure exits non-zero before the last line is printed):

1. the card's name and power limit, and the torch/CUDA versions;
2. build every kernel from ``fm_spark_tpu_torch/csrc`` (timed);
3. each kernel against its plain PyTorch version at config 3's full
   width (39 fields x 262,144 buckets x 65 columns), fp32 and bf16
   storage, B in {1, 8, 64, 512, 131072}: max errors, kernel and plain
   times (CUDA events, median of 20 warm calls over 20 distinct id sets;
   device time with the host's issue hidden behind a sleep kernel, and
   the kernel's call time on an idle card) and the byte bound at 3.35 TB/s;
4. serving: a config-3 FieldFM made on the card from a seeded generator,
   ``PredictEngine(buckets=(1, 8, 64, 512))``, 4 threads submitting 400
   requests of 1-512 Zipf rows with one generation swap mid-run; every
   request must be answered once, by one generation, matching the plain
   version; the kernel's launch count over this phase must be > 0;
5. the CLI: ``python -m fm_spark_tpu_torch predict`` on a saved model
   dir (16,384 buckets per field, to keep the npz short), checked line
   by line against the plain version.

It prints the kernels' JSON line, then the card line, then, last,
``{"ok": true, "device": {...}}``; details go to
``chiprun_out/chip_smoke.json``. It needs one card and imports nothing
of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))

F, BUCKET, RANK = 39, 1 << 18, 64        # config 3, criteo1tb_fm_r64
WIDTH = RANK + 1
BATCHES = (1, 8, 64, 512, 131072)
HBM_BYTES_PER_S = 3.35e12                # H100 SXM, NVIDIA data sheet
REPS = 20
# fp32 accumulation in another order than the plain version: the two
# cancelling terms sum s^2 and ssq are each ~25 at N(0, 0.1) rows, so
# their rounding differences reach ~1e-5 absolute.
ATOL, RTOL = 1e-4, 1e-5


def _check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"chip_smoke FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def _median_ms(fn, reps: int = REPS, hide_host_ms: float = 0.0) -> float:
    """Median over ``reps`` warm calls of the CUDA-event time around one
    ``fn(r)``. With ``hide_host_ms`` > 0 a sleep kernel that long runs
    first, so the host has enqueued the whole call before the start
    event fires: the span is then device time alone. Without it the span
    also holds the host's time to issue the call (the idle-card latency
    a caller sees)."""
    import torch

    fn(0)
    fn(1)
    torch.cuda.synchronize()
    # At most ~2e6 SM cycles per ms (H100 boost clock 1.98 GHz), so the
    # sleep lasts at least hide_host_ms.
    cycles = int(hide_host_ms * 2e6)
    times = []
    for r in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if cycles:
            torch.cuda._sleep(cycles)
        start.record()
        fn(r)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _close(got, want) -> bool:
    return bool(((got - want).abs() <= ATOL + RTOL * want.abs()).all())


def _rel_err(got, want) -> float:
    """Largest |got - want| / |want| over entries with |want| >= 1e-2."""
    big = want.abs() >= 1e-2
    if not bool(big.any()):
        return 0.0
    return float(((got - want).abs()[big] / want.abs()[big]).max())


def kernel_phase(dev, report):
    import torch

    from fm_spark_tpu_torch.ops import fused_fwd

    rows = []
    g = torch.Generator(device=dev).manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        tables = [(torch.randn(BUCKET, WIDTH, generator=g, device=dev) * 0.1)
                  .to(dtype) for _ in range(F)]
        w0 = torch.tensor(0.25, device=dev)
        sb = tables[0].element_size()
        for b in BATCHES:
            ids = [torch.randint(0, BUCKET, (b, F), generator=g, device=dev,
                                 dtype=torch.int32) for _ in range(REPS)]
            vals = [torch.rand(b, F, generator=g, device=dev) + 0.5
                    for _ in range(REPS)]
            got_s, got_a = fused_fwd.fm_fused_scores(tables, ids[0], vals[0],
                                                     w0=w0)
            torch.cuda.synchronize()
            ref_s, ref_a = fused_fwd.fm_fused_scores_plain(tables, ids[0],
                                                           vals[0], w0=w0)
            name = f"{str(dtype).removeprefix('torch.')} B={b}"
            _check(bool(torch.isfinite(got_s).all()), f"{name}: non-finite scores")
            _check(_close(got_s, ref_s) and _close(got_a, ref_a),
                   f"{name}: kernel disagrees with plain version")

            def kernel(r):
                fused_fwd.fm_fused_scores(tables, ids[r], vals[r], w0=w0)

            def plain(r):
                fused_fwd.fm_fused_scores_plain(tables, ids[r], vals[r], w0=w0)

            ms = _median_ms(kernel, hide_host_ms=2.0)
            call_ms = _median_ms(kernel)
            plain_ms = _median_ms(plain, hide_host_ms=30.0)
            # Bytes this run's data needs: each distinct (field, id) row
            # once, ids + vals once, scores + acc written once.
            offs = torch.arange(F, device=dev, dtype=torch.int64) * BUCKET
            uniq = statistics.mean(
                int(torch.unique(i.long() + offs).numel()) for i in ids)
            nbytes = uniq * WIDTH * sb + b * F * 8 + b * 4 + b * WIDTH * 4 + 4
            row = {
                "dtype": str(dtype).removeprefix("torch."), "B": b,
                "max_abs_err": float((got_s - ref_s).abs().max()),
                "max_abs_err_acc": float((got_a - ref_a).abs().max()),
                "max_rel_err": _rel_err(got_s, ref_s),
                "ms": ms, "call_ms": call_ms, "plain_ms": plain_ms,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "bytes": nbytes, "unique_rows": uniq,
            }
            row["achieved_GBps"] = nbytes / (ms * 1e-3) / 1e9
            rows.append(row)
            print("kernel", json.dumps(row), flush=True)
        del tables
        torch.cuda.empty_cache()
    report["kernel_vs_plain"] = rows
    return rows


def _config3_model(dev, seed: int, bucket: int = BUCKET):
    """A config-3 FieldFM with random weights from ``seed``; the linear
    column and bias are filled too, as a trained model's would be."""
    import torch

    from fm_spark_tpu_torch import models

    spec = models.FieldFMSpec(num_features=F * bucket, rank=RANK,
                              num_fields=F, bucket=bucket, init_std=0.1)
    g = torch.Generator(device=dev).manual_seed(seed)
    params = spec.init(g, device=dev)
    for t in params["vw"]:
        t[:, RANK] = torch.randn(bucket, generator=g, device=dev) * 0.1
    params["w0"].fill_(0.05)
    return spec, params


def _plain_predict(spec, params, ids, vals, dev):
    import torch

    from fm_spark_tpu_torch.models import predict_from_scores
    from fm_spark_tpu_torch.ops import fused_fwd

    s, _ = fused_fwd.fm_fused_scores_plain(
        params["vw"], torch.from_numpy(ids).to(dev),
        torch.from_numpy(vals).to(dev), use_linear=spec.use_linear,
        w0=params["w0"])
    return predict_from_scores(spec, s).cpu()


def serve_phase(dev, report):
    import numpy as np
    import torch

    from fm_spark_tpu_torch import data, obs
    from fm_spark_tpu_torch.ops import fused_fwd
    from fm_spark_tpu_torch.serve import PredictEngine

    spec, params = _config3_model(dev, seed=5)
    params1 = {"w0": params["w0"] + 0.5, "vw": params["vw"]}
    engine = PredictEngine(spec, params, buckets=(1, 8, 64, 512),
                           latency_budget_ms=2.0, device=dev)
    warm = engine.warmup()
    print(f"serve warmup {warm['seconds']:.3f} s", flush=True)

    ids_pool, vals_pool, _ = data.synthetic_ctr(20000, spec.num_features, F,
                                                seed=2)
    ids_pool = data.field_local(ids_pool, BUCKET)
    rng = np.random.default_rng(7)
    sizes = rng.choice([1, 1, 2, 3, 8, 17, 64, 100, 255, 512], size=400)
    starts = rng.integers(0, len(ids_pool) - 512, size=400)
    reqs = [(int(s), int(o)) for s, o in zip(sizes, starts)]
    futures: list = [None] * len(reqs)
    half_done = threading.Event()
    errors = []

    def client(t):
        pace = np.random.default_rng(100 + t)
        try:
            for i in range(t, len(reqs), 4):
                if i >= len(reqs) // 2:     # the second half follows the swap
                    half_done.wait(60)
                n, o = reqs[i]
                futures[i] = engine.submit(ids_pool[o:o + n], vals_pool[o:o + n])
                time.sleep(float(pace.random()) * 1e-3)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    # Counts start at 0 just before the main path and are read just after.
    obs.registry().reset()
    fused_fwd.launches = 0
    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(t,)) for t in range(4)]
    for th in threads:
        th.start()
    give_up = time.monotonic() + 120
    while sum(f is not None and f.done() for f in futures) < len(reqs) // 2:
        _check(time.monotonic() < give_up and not errors,
               f"first half of the requests not answered: {errors!r}")
        time.sleep(1e-3)
    engine.swap_generation(params1, step=1)
    half_done.set()
    for th in threads:
        th.join(120)
    results = [f.result(120) for f in futures]
    wall = time.perf_counter() - t0
    launches = fused_fwd.launches
    snap = obs.registry().snapshot()
    engine.close()
    _check(not errors, f"client thread failed: {errors!r}")

    all_ids = np.concatenate([ids_pool[o:o + n] for n, o in reqs])
    all_vals = np.concatenate([vals_pool[o:o + n] for n, o in reqs])
    want = [_plain_predict(spec, p, all_ids, all_vals, dev).numpy()
            for p in (params, params1)]
    by_gen = [0, 0]
    off = 0
    for (n, _), got in zip(reqs, results):
        _check(got.shape == (n,) and bool(np.isfinite(got).all()),
               "bad result shape or non-finite prediction")
        match = [np.allclose(got, w[off:off + n], rtol=RTOL, atol=2e-5)
                 for w in want]
        _check(any(match), "request matches neither generation")
        by_gen[0 if match[0] else 1] += 1
        off += n
    c = snap["counters"]
    _check(c.get("serve.requests_total") == len(reqs),
           "requests_total != requests submitted")
    _check(c.get("serve.rows_total") == float(sum(sizes)),
           "rows scored != rows submitted (a request answered twice or never)")
    _check(c.get("serve.batch_failures_total", 0) == 0, "a batch failed")
    _check(by_gen[0] > 0 and by_gen[1] > 0, f"swap not observed: {by_gen}")
    _check(launches > 0, "serving never launched the kernel")
    hist = snap["histograms"]["serve/request_ms"]
    out = {"requests": len(reqs), "rows": int(sum(sizes)),
           "batches": c.get("serve.batches_total"), "wall_s": wall,
           "request_ms_p50": hist["p50"], "request_ms_p99": hist["p99"],
           "batch_ms_p50": snap["histograms"]["serve/batch_ms"]["p50"],
           "answers_by_generation": by_gen, "launches": launches}
    print("serve", json.dumps(out), flush=True)
    report["serve"] = out
    return launches


def cli_phase(dev, report):
    import numpy as np

    from fm_spark_tpu_torch import data, models

    bucket = 1 << 14
    spec, params = _config3_model(dev, seed=9, bucket=bucket)
    model_dir = os.path.join(HERE, "build", "chip_smoke", "model")
    out_path = os.path.join(HERE, "build", "chip_smoke", "preds.txt")
    models.save_model(model_dir, spec, params)
    proc = subprocess.run(
        [sys.executable, "-m", "fm_spark_tpu_torch", "predict",
         "--model", model_dir, "--synthetic", "4096", "--batch-size", "512",
         "--out", out_path],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    _check(proc.returncode == 0, f"cli predict exited {proc.returncode}:\n"
           f"{proc.stderr[-4000:]}")
    summary = json.loads(proc.stderr.strip().splitlines()[-1])
    got = np.loadtxt(out_path)
    ids, vals, _ = data.synthetic_ctr(4096, spec.num_features, F, seed=1)
    ids = data.field_local(ids, bucket)
    want = _plain_predict(spec, params, ids, vals, dev).numpy()
    _check(got.shape == (4096,), f"cli wrote {got.shape} lines, want 4096")
    # %.6g output: 6 significant digits.
    _check(np.allclose(got, want, rtol=1e-5, atol=1e-6),
           f"cli predictions disagree: max err {np.abs(got - want).max()}")
    _check(summary["kernel_launches"]["fm_fused_scores"] > 0,
           "cli predict never launched the kernel")
    out = {"lines": int(got.shape[0]),
           "max_abs_err": float(np.abs(got - want).max()),
           "cli": summary}
    print("cli", json.dumps(out), flush=True)
    report["cli"] = out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from fm_spark_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda}

    t0 = time.perf_counter()
    build.build_all()
    report["build_s"] = time.perf_counter() - t0
    print(f"kernel build {report['build_s']:.2f} s", flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)

    rows = kernel_phase(dev, report)
    launches = serve_phase(dev, report)
    cli_phase(dev, report)

    main_row = next(r for r in rows if r["dtype"] == "float32" and r["B"] == 512)
    kernels = {"kernels": [{
        "name": "fm_fused_scores", "route": "cuda",
        "source": "fm_spark_tpu_torch/csrc/fm_fused_fwd.cu",
        "replaces": "fm_spark_tpu/ops/pallas_fused.py:258",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_rel_err": max(r["max_rel_err"] for r in rows),
        "ms": main_row["ms"], "call_ms": main_row["call_ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": "bytes",
        "library_ms": None, "shape": "fp32 B=512 (largest serving bucket)",
    }]}
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    with open(os.path.join(HERE, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({**report, **kernels}, f, indent=2)
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
