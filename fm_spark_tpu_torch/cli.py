"""Command-line entry point of the port (``python -m fm_spark_tpu_torch``
or ``fmtorch``), mirroring ``fm_spark_tpu``'s CLI on synthetic data:

- ``train --config NAME --synthetic N --steps S --batch-size B ...``
  trains a FieldFM or FieldFFM config (``field_sparse`` strategy) on
  ``N`` seeded examples with the fused sparse-SGD step (on the card a
  captured CUDA graph per step), printing one JSON loss line
  every ``--log-every`` steps, then ``{"eval": {...}}`` on the held-out
  ``--test-fraction`` and ``{"saved": DIR}`` with ``--model-out``;
- ``eval --model DIR --synthetic N`` prints the model's metrics on
  ``N`` seeded examples shaped by its spec (seed 1, field-local ids);
- ``predict --model DIR --synthetic N`` scores the same examples through
  the serving engine with one bucket of ``--batch-size`` rows and writes
  one ``%.6g`` prediction per line.

Every command runs on the CUDA device unless ``--device cpu`` is given.
A JSON summary of kernel launches goes to standard error.
"""

from __future__ import annotations

import argparse
import json
import sys


def load_dataset(cfg, synthetic: int):
    """``(ids, vals, labels, num_features)`` of ``synthetic`` planted-FM
    examples shaped like the config (seed ``cfg.seed``; field-local ids
    for field-partitioned models), as the JAX CLI's ``--synthetic``."""
    from fm_spark_tpu_torch import data

    num_features = cfg.num_features if cfg.bucket > 0 else 4096
    ids, vals, labels = data.synthetic_ctr(synthetic, num_features,
                                           cfg.num_fields, seed=cfg.seed)
    if cfg.field_local_ids:
        ids = data.field_local(ids, cfg.bucket)
    return ids, vals, labels, num_features


def _synthetic_for_model(spec, n: int):
    """``n`` seeded examples (seed 1) shaped by a model's own spec."""
    from fm_spark_tpu_torch import data

    nnz = getattr(spec, "num_fields", 0) or min(8, spec.num_features)
    ids, vals, labels = data.synthetic_ctr(n, spec.num_features, nnz, seed=1)
    if getattr(spec, "field_local_ids", False):
        ids = data.field_local(ids, spec.bucket)
    return ids, vals, labels


def _launches() -> dict:
    from fm_spark_tpu_torch.ops import kernel_launches

    return kernel_launches()


def _since(before: dict) -> dict:
    return {k: v - before[k] for k, v in _launches().items()}


def cmd_train(args) -> int:
    from fm_spark_tpu_torch import configs, data, models, resolve_device
    from fm_spark_tpu_torch.train import evaluate_params, fit_field_sparse
    from fm_spark_tpu_torch.utils.logging import MetricsLogger

    if not args.synthetic:
        raise SystemExit("train needs --synthetic N (dataset loaders are "
                         "not ported yet)")
    cfg = configs.get_config(args.config, bucket=args.bucket,
                             param_dtype=args.param_dtype,
                             compute_dtype=args.compute_dtype,
                             use_pallas=True if args.use_pallas else None)
    if (cfg.model not in ("field_fm", "field_ffm")
            or cfg.strategy != "field_sparse"):
        raise SystemExit(f"config {cfg.name!r} (model {cfg.model!r}, "
                         f"strategy {cfg.strategy!r}) is not ported yet "
                         "(ROADMAP); the port trains field_fm and field_ffm "
                         "configs")
    tconfig = cfg.train_config(
        num_steps=args.steps, batch_size=args.batch_size,
        log_every=args.log_every, sparse_update=args.sparse_update,
        host_dedup=args.host_dedup, compact_cap=args.compact_cap,
        compact_device=args.compact_device,
        compact_overflow=args.compact_overflow,
        gfull_fused=args.gfull_fused, segtotal_pallas=args.segtotal_pallas,
        sel_blocked=args.sel_blocked, fused_embed=args.fused_embed)
    if tconfig.compact_overflow != "error" and tconfig.compact_cap <= 0:
        # The reference's guard (cli_levers._v_overflow_needs_cap).
        raise SystemExit(f"--compact-overflow {tconfig.compact_overflow} has "
                         "no effect without --compact-cap")
    spec = cfg.spec()
    if tconfig.sel_blocked and type(spec) is not models.FieldFFMSpec:
        # The reference's lever rule; the port's CLI trains on one device.
        raise SystemExit(
            f"--sel-blocked is the single-chip FieldFFM body's lever (it "
            f"blocks the [B, F, F, k] sel tensor; found 1 device(s), "
            f"{type(spec).__name__})")
    dev = resolve_device(args.device)
    ids, vals, labels, _ = load_dataset(cfg, args.synthetic)
    te = None
    if args.test_fraction > 0:
        (ids, vals, labels), te = data.train_test_split(
            ids, vals, labels, args.test_fraction, seed=cfg.seed)
    batches = data.Batches(ids, vals, labels, tconfig.batch_size,
                           seed=cfg.seed)
    before = _launches()
    params = fit_field_sparse(spec, tconfig, batches, device=dev,
                              steps_per_call=args.steps_per_call,
                              logger=MetricsLogger())
    if te is not None:
        metrics = evaluate_params(
            spec, params, data.iterate_once(*te, tconfig.batch_size))
        print(json.dumps({"eval": metrics}), flush=True)
    if args.model_out:
        models.save_model(args.model_out, spec, params)
        print(json.dumps({"saved": args.model_out}), flush=True)
    print(json.dumps({"device": str(dev), "kernel_launches": _since(before)}),
          file=sys.stderr)
    return 0


def cmd_eval(args) -> int:
    from fm_spark_tpu_torch import data, models
    from fm_spark_tpu_torch.train import evaluate_params

    if not args.synthetic:
        raise SystemExit("eval needs --synthetic N (dataset loaders are "
                         "not ported yet)")
    spec, params = models.load_model(args.model, device=args.device)
    ids, vals, labels = _synthetic_for_model(spec, args.synthetic)
    before = _launches()
    metrics = evaluate_params(
        spec, params, data.iterate_once(ids, vals, labels, args.batch_size))
    print(json.dumps(metrics), flush=True)
    print(json.dumps({"device": str(params["w0"].device),
                      "kernel_launches": _since(before)}), file=sys.stderr)
    return 0


def cmd_predict(args) -> int:
    from fm_spark_tpu_torch import data, models
    from fm_spark_tpu_torch.serve import PredictEngine

    if not args.synthetic:
        raise SystemExit("predict needs --synthetic N (dataset loaders are "
                         "not ported yet)")
    spec, params = models.load_model(args.model, device=args.device)
    nnz = getattr(spec, "num_fields", 0) or min(8, spec.num_features)
    ids, vals, labels = _synthetic_for_model(spec, args.synthetic)
    # One bucket = the batch size: every iterate_once batch is padded to it.
    engine = PredictEngine(spec, params, nnz=nnz, buckets=(args.batch_size,),
                           latency_budget_ms=0.0, device=args.device)
    engine.warmup()
    before = _launches()
    rows = 0
    out = sys.stdout if args.out in (None, "-") else open(args.out, "w")
    try:
        for bids, bvals, _, w in data.iterate_once(ids, vals, labels,
                                                   args.batch_size):
            preds = engine.score(bids, bvals)
            for p in preds[w > 0]:
                out.write(f"{float(p):.6g}\n")
                rows += 1
    finally:
        if out is not sys.stdout:
            out.close()
    print(json.dumps({"predicted": rows, "device": str(engine.device),
                      "kernel_launches": _since(before)}), file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fmtorch", description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    device_help = "'cuda' (default) or 'cpu' (the kernels' plain versions)"

    t = sub.add_parser("train", help="train a field_fm or field_ffm config")
    t.add_argument("--config", required=True, help="registered config name")
    t.add_argument("--synthetic", type=int, default=0, metavar="N",
                   help="train on N seeded synthetic examples")
    t.add_argument("--steps", type=int, required=True)
    t.add_argument("--batch-size", type=int, default=None)
    t.add_argument("--bucket", type=int, default=None,
                   help="per-field bucket count in place of the config's "
                        "(a narrower copy of the config)")
    t.add_argument("--param-dtype", choices=["float32", "bfloat16"])
    t.add_argument("--compute-dtype", choices=["float32", "bfloat16"])
    t.add_argument("--sparse-update", choices=["scatter_add", "dedup",
                                               "dedup_sr"])
    t.add_argument("--host-dedup", action="store_true", default=None,
                   help="build the dedup aux on the host (the compact aux "
                        "with --compact-cap)")
    t.add_argument("--compact-cap", type=int, default=None)
    t.add_argument("--compact-device", action="store_true", default=None,
                   help="build the compact aux on the card inside the step "
                        "(no host aux). Needs --compact-cap and a dedup "
                        "--sparse-update; exclusive with --host-dedup")
    t.add_argument("--compact-overflow", choices=["error", "drop", "split"],
                   help="when a field's unique ids exceed --compact-cap: "
                        "error (default; the device aux poisons the loss "
                        "to -inf), drop (device aux: overflow ids behave "
                        "as absent features), split (host aux; not "
                        "ported yet)")
    t.add_argument("--gfull-fused", action="store_true", default=None)
    t.add_argument("--segtotal-pallas", action="store_true", default=None,
                   help="segment sums by the segment-totals kernel")
    t.add_argument("--sel-blocked", action="store_true", default=None,
                   help="FieldFFM: the per-owner-field interaction loop in "
                        "place of the [B, F, F, k] sel tensor")
    t.add_argument("--use-pallas", action="store_true",
                   help="row gathers and scatter_add/dedup writes by the "
                        "row kernels (gather_rows, update_rows_add)")
    t.add_argument("--fused-embed", choices=["off", "auto", "require"],
                   help="the fused kernels: FieldFM's backward, FieldFFM's "
                        "ffm_sel pair (with --sel-blocked)")
    t.add_argument("--steps-per-call", type=int, default=1)
    t.add_argument("--test-fraction", type=float, default=0.2)
    t.add_argument("--log-every", type=int, default=1)
    t.add_argument("--model-out", help="directory to save the final model")
    t.add_argument("--device", default=None, help=device_help)
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("eval", help="evaluate a saved model")
    e.add_argument("--model", required=True)
    e.add_argument("--synthetic", type=int, default=0, metavar="N")
    e.add_argument("--batch-size", type=int, default=8192)
    e.add_argument("--device", default=None, help=device_help)
    e.set_defaults(fn=cmd_eval)

    pr = sub.add_parser("predict", help="write predictions for a dataset")
    pr.add_argument("--model", required=True, help="model dir (spec.json + params.npz)")
    pr.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="score N seeded synthetic examples")
    pr.add_argument("--batch-size", type=int, default=8192)
    pr.add_argument("--device", default=None, help=device_help)
    pr.add_argument("--out", help="output file ('-' = stdout)")
    pr.set_defaults(fn=cmd_predict)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
