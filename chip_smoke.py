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
   by line against the plain version; then ``train`` on a config-3 copy
   with 16,384 buckets per field (bf16, dedup_sr, compact, the fused
   backward; 3 steps) and ``eval`` of the model it wrote;
6. the training kernels against their plain versions at config 3's full
   width on the aux of the bench batch (B = 131,072 Zipf(1.3) ids,
   compact cap 12,288): segment totals (kernel A) on one field, the
   fused backward (kernel B) over all 39 fields in fp32 and bf16
   compute; each also repeated, which must give the same bits;
7. training on the card: a config-3 FieldFM (bf16 tables and compute,
   dedup_sr, compact 12,288) made from a seeded generator, trained 7
   steps by ``fit_field_sparse`` on a stream of bench batches, once per
   leg (``segtotal``: gfull + kernel A; ``fusedbwd``: kernel B); the
   loss must be finite and fall and the leg's kernel must launch; one
   more step from the trained params must equal, within the bf16
   tolerance, the same step with the plain versions swapped in.

It prints the kernels' JSON line, then the card line, then, last,
``{"ok": true, "device": {...}}``; details go to
``chiprun_out/chip_smoke.json``. It needs one card and imports nothing
of JAX.
"""

from __future__ import annotations

import contextlib
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
FP32_FLOPS_PER_S = 67e12                 # the same, outside the tensor cores
TRAIN_B, CAP = 131072, 12288             # bench.py's config-3 batch and cap
TRAIN_STEPS, WARM_STEPS = 7, 2
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
        # bf16 tables also in the bf16-compute mode, at the serving bucket
        # and the training batch.
        runs = [(b, False) for b in BATCHES]
        if dtype == torch.bfloat16:
            runs += [(512, True), (131072, True)]
        for b, cd_bf16 in runs:
            ids = [torch.randint(0, BUCKET, (b, F), generator=g, device=dev,
                                 dtype=torch.int32) for _ in range(REPS)]
            vals = [torch.rand(b, F, generator=g, device=dev) + 0.5
                    for _ in range(REPS)]
            got_s, got_a = fused_fwd.fm_fused_scores(
                tables, ids[0], vals[0], w0=w0, compute_bf16=cd_bf16)
            torch.cuda.synchronize()
            ref_s, ref_a = fused_fwd.fm_fused_scores_plain(
                tables, ids[0], vals[0], w0=w0, compute_bf16=cd_bf16)
            name = (f"{str(dtype).removeprefix('torch.')} B={b}"
                    f"{' cd-bf16' if cd_bf16 else ''}")
            _check(bool(torch.isfinite(got_s).all()), f"{name}: non-finite scores")
            _check(_close(got_s, ref_s) and _close(got_a, ref_a),
                   f"{name}: kernel disagrees with plain version")

            def kernel(r):
                fused_fwd.fm_fused_scores(tables, ids[r], vals[r], w0=w0,
                                          compute_bf16=cd_bf16)

            def plain(r):
                fused_fwd.fm_fused_scores_plain(tables, ids[r], vals[r], w0=w0,
                                                compute_bf16=cd_bf16)

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
                "compute": "bfloat16" if cd_bf16 else "float32",
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

    # train on a config-3 copy of 16,384 buckets per field, then eval.
    train_dir = os.path.join(HERE, "build", "chip_smoke", "trained")
    proc = subprocess.run(
        [sys.executable, "-m", "fm_spark_tpu_torch", "train",
         "--config", "criteo1tb_fm_r64", "--bucket", str(bucket),
         "--synthetic", "20000", "--steps", "3", "--batch-size", "4096",
         "--param-dtype", "bfloat16", "--compute-dtype", "bfloat16",
         "--sparse-update", "dedup_sr", "--host-dedup", "--compact-cap",
         "4096", "--fused-embed", "require", "--model-out", train_dir],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    _check(proc.returncode == 0, f"cli train exited {proc.returncode}:\n"
           f"{proc.stderr[-4000:]}")
    lines = [json.loads(x) for x in proc.stdout.splitlines()]
    losses = [x["loss"] for x in lines if "loss" in x]
    _check(len(losses) == 3 and all(np.isfinite(losses)),
           f"cli train loss lines: {losses}")
    evals = [x["eval"] for x in lines if "eval" in x]
    _check(len(evals) == 1 and np.isfinite(evals[0]["logloss"]),
           f"cli train eval line: {evals}")
    train_launches = json.loads(proc.stderr.strip().splitlines()[-1])
    _check(train_launches["kernel_launches"]["fm_bwd_segment_totals"] == 3,
           f"cli train did not run the fused backward: {train_launches}")
    proc = subprocess.run(
        [sys.executable, "-m", "fm_spark_tpu_torch", "eval", "--model",
         train_dir, "--synthetic", "4096", "--batch-size", "1024"],
        cwd=HERE, capture_output=True, text=True, timeout=600)
    _check(proc.returncode == 0, f"cli eval exited {proc.returncode}:\n"
           f"{proc.stderr[-4000:]}")
    metrics = json.loads(proc.stdout.strip().splitlines()[-1])
    _check(metrics["count"] == 4096.0 and np.isfinite(metrics["logloss"])
           and 0.0 <= metrics["auc"] <= 1.0, f"cli eval: {metrics}")
    out.update(train_loss=losses, train_eval=evals[0],
               train_launches=train_launches["kernel_launches"],
               eval=metrics)
    print("cli", json.dumps(out), flush=True)
    report["cli"] = out


class BenchStream:
    """bench.py's config-3 batch as a stream: each batch draws ids
    ``zipf(1.3) % bucket`` ([B, 39], so the first batch's ids are the
    bench batch's), then its labels, from one ``default_rng(seed)``;
    vals and weights are all 1. Labels are Bernoulli(0.25) rather than
    the bench's fair coin, so a model has a bias to learn in a few
    steps."""

    def __init__(self, seed: int = 0, batch: int = TRAIN_B):
        import numpy as np

        self._rng = np.random.default_rng(seed)
        self._b = batch
        self._drawn = 0

    def state(self) -> dict:
        return {"batches": self._drawn}

    def next_batch(self):
        import numpy as np

        self._drawn += 1
        ids = (self._rng.zipf(1.3, size=(self._b, F)) % BUCKET).astype(np.int32)
        labels = (self._rng.random(self._b) < 0.25).astype(np.float32)
        return (ids, np.ones((self._b, F), np.float32), labels,
                np.ones(self._b, np.float32))


def _bound_ms(nbytes: float, flops: float = 0.0):
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOPS_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def training_kernels_phase(dev, report):
    """Kernels A and B against their plain versions at full width."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch.ops import fused_bwd, scatter, segsum

    ids = BenchStream(0).next_batch()[0]
    t0 = time.perf_counter()
    aux = scatter.compact_aux(ids, CAP)
    aux_ms = (time.perf_counter() - t0) * 1e3
    nseg = [int((u < BUCKET).sum()) for u in aux[0]]
    order, inv = (torch.from_numpy(a).to(dev) for a in (aux[3], aux[4]))
    g = torch.Generator(device=dev).manual_seed(11)
    out = {"aux_ms": aux_ms, "unique_ids_per_field_max": max(nseg),
           "unique_ids_per_field_min": min(nseg)}

    # Kernel A on field 0: deltas at the scale of -lr·g, in sorted order.
    o = order[0].long()
    sdelta = (torch.randn(TRAIN_B, WIDTH, generator=g, device=dev)
              * 0.01)[o].contiguous()
    seg = inv[0][o].contiguous()
    got = segsum.segment_totals(sdelta, seg, CAP)
    again = segsum.segment_totals(sdelta, seg, CAP)
    torch.cuda.synchronize()
    plain = segsum.segment_totals_plain(sdelta, seg, CAP)
    exact = segsum.segment_totals_plain(sdelta.double(), seg, CAP)
    bound = 1e-5 * segsum.segment_totals_plain(sdelta.abs().double(), seg, CAP)
    _check(torch.equal(got, again), "segment_totals: a repeat differs")
    # Each within 1e-5 of its segment's sum of |x| from the exact total:
    # fp32 sums in another order on each side.
    _check(bool(((got.double() - exact).abs() <= bound).all())
           and bool(((plain.double() - exact).abs() <= bound).all()),
           "segment_totals: kernel or plain version off the exact sums")
    idx = torch.where(seg < CAP, seg, CAP).long()
    base = torch.zeros(CAP + 1, WIDTH, device=dev)
    bms, bby = _bound_ms(TRAIN_B * WIDTH * 4 + 4 * TRAIN_B + CAP * WIDTH * 4,
                         TRAIN_B * WIDTH)
    a_row = {
        "field": 0, "segments": nseg[0],
        "head_run": int(torch.bincount(seg).max()),
        "max_abs_err": float((got - plain).abs().max()),
        "max_rel_err": _rel_err(got, plain),
        "max_abs_err_vs_exact": float((got.double() - exact).abs().max()),
        "bitwise_repeat": True,
        "ms": _median_ms(lambda r: segsum.segment_totals(sdelta, seg, CAP),
                         hide_host_ms=2.0),
        "plain_ms": _median_ms(
            lambda r: segsum.segment_totals_plain(sdelta, seg, CAP),
            hide_host_ms=5.0),
        "library_ms": _median_ms(lambda r: base.index_add(0, idx, sdelta),
                                 hide_host_ms=2.0),
        "bound_ms": bms, "bound_by": bby,
    }
    print("segment_totals", json.dumps(a_row), flush=True)
    out["segment_totals"] = a_row
    del sdelta, seg, plain, exact, bound

    # Kernel B over all fields, as the step calls it.
    b_rows = []
    ones = torch.ones(TRAIN_B, F, device=dev)
    weights = torch.ones(TRAIN_B, device=dev)
    for store, cd in ((torch.float32, torch.float32),
                      (torch.bfloat16, torch.bfloat16)):
        urows = [(torch.randn(CAP, WIDTH, generator=g, device=dev) * 0.01)
                 .to(store) for _ in range(F)]
        s1 = torch.cat([torch.randn(TRAIN_B, RANK, generator=g, device=dev)
                        * 0.1, torch.ones(TRAIN_B, 1, device=dev)], 1).to(cd)
        ds = (torch.randn(TRAIN_B, generator=g, device=dev) * 1e-5).to(cd)
        args = (urows, s1, ds, ones, weights, order, inv, -0.05, (1e-6, 0.0))
        got = fused_bwd.fm_bwd_segment_totals(*args, cap=CAP)
        again = fused_bwd.fm_bwd_segment_totals(*args, cap=CAP)
        torch.cuda.synchronize()
        want = fused_bwd.fm_bwd_segment_totals_plain(*args, cap=CAP)
        name = f"store={str(store)[6:]} compute={str(cd)[6:]}"
        _check(torch.equal(got, again), f"fm_bwd {name}: a repeat differs")
        # The same roundings elementwise; the fp32 segment sums differ in
        # order, an error that grows with the segment's size: within 1e-5
        # of |total| plus the field's largest |total|.
        scale = want.abs().amax(dim=(1, 2), keepdim=True)
        _check(bool(((got - want).abs() <= 1e-5 * (want.abs() + scale)).all()),
               f"fm_bwd {name}: kernel disagrees with plain version")
        cdb, sb = s1.element_size(), urows[0].element_size()
        nbytes = (TRAIN_B * WIDTH * cdb + TRAIN_B * cdb + TRAIN_B * F * 4
                  + TRAIN_B * 4 + 2 * F * TRAIN_B * 4
                  + F * CAP * WIDTH * (sb + 4))
        # ~12 fp32 operations per element of each field's lane rows.
        bms, bby = _bound_ms(nbytes, 12.0 * F * TRAIN_B * WIDTH)
        row = {
            "store": str(store)[6:], "compute": str(cd)[6:],
            "max_abs_err": float((got - want).abs().max()),
            "max_rel_err": _rel_err(got, want), "bitwise_repeat": True,
            "ms": _median_ms(
                lambda r: fused_bwd.fm_bwd_segment_totals(*args, cap=CAP),
                hide_host_ms=2.0),
            "plain_ms": _median_ms(
                lambda r: fused_bwd.fm_bwd_segment_totals_plain(*args, cap=CAP),
                reps=5, hide_host_ms=40.0),
            "library_ms": None, "bound_ms": bms, "bound_by": bby,
            "bytes": nbytes,
        }
        print("fm_bwd_segment_totals", json.dumps(row), flush=True)
        b_rows.append(row)
        del urows, s1, ds, got, again, want
        torch.cuda.empty_cache()
    out["fm_bwd_segment_totals"] = b_rows
    report["training_kernels"] = out
    return a_row, b_rows


@contextlib.contextmanager
def _plain_versions():
    """Swap the training kernels' wrappers for their plain versions (the
    step looks them up at call time)."""
    from fm_spark_tpu_torch.ops import fused_bwd, segsum

    saved = segsum.segment_totals, fused_bwd.fm_bwd_segment_totals
    segsum.segment_totals = segsum.segment_totals_plain
    fused_bwd.fm_bwd_segment_totals = fused_bwd.fm_bwd_segment_totals_plain
    try:
        yield
    finally:
        segsum.segment_totals, fused_bwd.fm_bwd_segment_totals = saved


def _profile_steps(step, params, batch, aux, step0, n: int = 3) -> dict:
    """``n`` steps on one device-resident batch under torch.profiler: the
    wall time per step, the device's busy time per step (the union of its
    kernel and copy intervals), its idle share, kernel launches per step,
    and the kernels that take the most device time. Device figures read
    "not measured" when the profiler records no device activity."""
    import collections

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for j in range(n):
            step(params, step0 + j, *batch, aux)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    events = prof.events()
    launches = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                              "cuLaunchKernel", "cuLaunchKernelEx")
                   for e in events) / n
    on_dev = [e for e in events if e.device_type == DeviceType.CUDA]
    out = {"wall_ms_per_step": wall_ms, "launches_per_step": launches}
    if not on_dev:
        return {**out, "device_ms_per_step": "not measured",
                "idle_share": "not measured"}
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end)
                         for e in on_dev):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    by_name = collections.Counter()
    for e in on_dev:
        by_name[e.name[:80]] += e.time_range.elapsed_us()
    device_ms = busy / 1e3 / n
    return {**out, "device_ms_per_step": device_ms,
            "idle_share": max(0.0, 1.0 - device_ms / wall_ms),
            "device_ops_per_step": len(on_dev) / n,
            "top_kernels_ms_per_step": [[k, v / 1e3 / n] for k, v in
                                        by_name.most_common(8)]}


def train_phase(dev, report):
    """Both config-3 training legs through fit_field_sparse."""
    import numpy as np
    import torch

    from fm_spark_tpu_torch import models, sparse
    from fm_spark_tpu_torch.data import iterate_once
    from fm_spark_tpu_torch.ops import fused_bwd, scatter, segsum
    from fm_spark_tpu_torch.train import (TrainConfig, evaluate_params,
                                          fit_field_sparse)

    spec = models.FieldFMSpec(num_features=F * BUCKET, rank=RANK,
                              num_fields=F, bucket=BUCKET, init_std=0.01,
                              param_dtype="bfloat16", compute_dtype="bfloat16")
    legs = {"segtotal": dict(gfull_fused=True, segtotal_pallas=True),
            "fusedbwd": dict(fused_embed="require")}
    out, launches = {}, {}
    for leg, lever in legs.items():
        cfg = TrainConfig(num_steps=TRAIN_STEPS, batch_size=TRAIN_B,
                          learning_rate=0.05, lr_schedule="constant",
                          reg_factors=1e-6, sparse_update="dedup_sr",
                          host_dedup=True, compact_cap=CAP, **lever)
        params = spec.init(torch.Generator(device=dev).manual_seed(21), dev)
        stats = {}
        torch.cuda.synchronize()
        # Counts start at 0 just before the main path and are read just after.
        segsum.launches = fused_bwd.launches = 0
        t0 = time.perf_counter()
        params = fit_field_sparse(spec, cfg, BenchStream(0), device=dev,
                                  stats=stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {"segment_totals": segsum.launches,
                  "fm_bwd_segment_totals": fused_bwd.launches}
        loss = stats["loss"]
        _check(all(np.isfinite(loss)), f"{leg}: non-finite loss {loss}")
        _check(loss[-1] < loss[0], f"{leg}: loss did not fall: {loss}")
        mine = "segment_totals" if leg == "segtotal" else "fm_bwd_segment_totals"
        _check(counts[mine] > 0, f"{leg}: {mine} never launched: {counts}")
        launches[mine] = counts[mine]
        step_ms = statistics.median(stats["step_ms"][WARM_STEPS:])

        # One more step from the trained params, kernels vs plain versions.
        batch = BenchStream(1).next_batch()
        aux = tuple(torch.from_numpy(a).to(dev)
                    for a in scatter.compact_aux(batch[0], CAP))
        batch = [torch.from_numpy(a).to(dev) for a in batch]
        copy = {"w0": params["w0"].clone(),
                "vw": [t.clone() for t in params["vw"]]}
        before = segsum.launches + fused_bwd.launches
        _, lk = sparse.make_field_sparse_sgd_body(spec, cfg)(
            params, TRAIN_STEPS, *batch, aux)
        mid = segsum.launches + fused_bwd.launches
        with _plain_versions():
            _, lp = sparse.make_field_sparse_sgd_body(spec, cfg)(
                copy, TRAIN_STEPS, *batch, aux)
        torch.cuda.synchronize()
        _check(mid > before,
               f"{leg}: the kernel step launched no kernel")
        _check(segsum.launches + fused_bwd.launches == mid,
               f"{leg}: the plain step launched a kernel")
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(params["vw"], copy["vw"]))
        differ = sum(int((a != b).sum()) for a, b in zip(params["vw"],
                                                         copy["vw"]))
        # bf16 tolerances of the reference: the totals' fp32 order can
        # flip a stochastic rounding by one bf16 ulp.
        _check(abs(float(lk) - float(lp)) < 1e-3 and diff < 1e-2
               and abs(float(params["w0"]) - float(copy["w0"])) < 1e-2,
               f"{leg}: kernel step != plain step (max |dw| {diff})")
        del copy
        prof = _profile_steps(sparse.make_field_sparse_sgd_body(spec, cfg),
                              params, batch, aux, TRAIN_STEPS + 1)
        metrics = evaluate_params(spec, params, iterate_once(
            *BenchStream(2).next_batch()[:3], 16384))
        _check(np.isfinite(metrics["logloss"]), f"{leg}: eval {metrics}")
        row = {
            "leg": f"bfloat16/dedup_sr/compact{CAP}/cd-bf16/"
                   + ("gfull/segtotal" if leg == "segtotal" else "fusedbwd"),
            "loss": loss, "step_ms": stats["step_ms"],
            "step_ms_median": step_ms,
            "samples_per_s": TRAIN_B / (step_ms * 1e-3),
            "host_aux_ms_median": statistics.median(stats["aux_ms"]),
            "wall_s": wall, "launches": counts,
            "launches_per_step": {k: v / TRAIN_STEPS for k, v in counts.items()},
            "vs_plain_max_abs_diff": diff, "vs_plain_elements_differing": differ,
            "vs_plain_loss_diff": abs(float(lk) - float(lp)),
            "eval": metrics, "profile": prof,
            "peak_mem_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
        }
        print("train", json.dumps(row), flush=True)
        out[leg] = row
        del params
        torch.cuda.empty_cache()
    report["train"] = out
    return launches


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
    a_row, b_rows = training_kernels_phase(dev, report)
    train_launches = train_phase(dev, report)

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
    }, {
        "name": "segment_totals", "route": "cuda",
        "source": "fm_spark_tpu_torch/csrc/segment_totals.cu",
        "replaces": "fm_spark_tpu/ops/pallas_segsum.py:81",
        "launches": train_launches["segment_totals"],
        "max_abs_err": a_row["max_abs_err"],
        "max_rel_err": a_row["max_rel_err"],
        "ms": a_row["ms"], "plain_ms": a_row["plain_ms"],
        "bound_ms": a_row["bound_ms"], "bound_by": a_row["bound_by"],
        "library_ms": a_row["library_ms"],
        "shape": f"one field, B={TRAIN_B}, cap={CAP}, w={WIDTH}",
    }, {
        "name": "fm_bwd_segment_totals", "route": "cuda",
        "source": "fm_spark_tpu_torch/csrc/fm_fused_bwd.cu",
        "replaces": "fm_spark_tpu/ops/pallas_fused.py:355",
        "launches": train_launches["fm_bwd_segment_totals"],
        "max_abs_err": max(r["max_abs_err"] for r in b_rows),
        "max_rel_err": max(r["max_rel_err"] for r in b_rows),
        "ms": b_rows[-1]["ms"], "plain_ms": b_rows[-1]["plain_ms"],
        "bound_ms": b_rows[-1]["bound_ms"], "bound_by": b_rows[-1]["bound_by"],
        "library_ms": None,
        "shape": f"{F} fields, B={TRAIN_B}, cap={CAP}, bf16 store+compute",
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
