"""Command-line entry point of the port (``python -m fm_spark_tpu_torch``
or ``fmtorch``).

``predict`` mirrors ``fm_spark_tpu``'s ``cli predict`` on synthetic
data: it loads a model dir, draws ``--synthetic N`` seeded examples
shaped by the model's spec (seed 1, field-local ids), scores them through
the serving engine with one bucket of ``--batch-size`` rows, and writes
one ``%.6g`` prediction per line. It runs on the CUDA device unless
``--device cpu`` is given. A JSON summary (rows, device, kernel
launches) goes to standard error.
"""

from __future__ import annotations

import argparse
import json
import sys


def cmd_predict(args) -> int:
    from fm_spark_tpu_torch import data, models
    from fm_spark_tpu_torch.ops import fused_fwd
    from fm_spark_tpu_torch.serve import PredictEngine

    if not args.synthetic:
        raise SystemExit("predict needs --synthetic N (dataset loaders are "
                         "not ported yet)")
    spec, params = models.load_model(args.model, device=args.device)
    nnz = getattr(spec, "num_fields", 0) or min(8, spec.num_features)
    ids, vals, labels = data.synthetic_ctr(args.synthetic, spec.num_features,
                                           nnz, seed=1)
    if getattr(spec, "field_local_ids", False):
        ids = data.field_local(ids, spec.bucket)
    # One bucket = the batch size: every iterate_once batch is padded to it.
    engine = PredictEngine(spec, params, nnz=nnz, buckets=(args.batch_size,),
                           latency_budget_ms=0.0, device=args.device)
    engine.warmup()
    launches0 = fused_fwd.launches
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
                      "kernel_launches": {
                          "fm_fused_scores": fused_fwd.launches - launches0}}),
          file=sys.stderr)
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="fmtorch", description=__doc__.split("\n\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("predict", help="write predictions for a dataset")
    pr.add_argument("--model", required=True, help="model dir (spec.json + params.npz)")
    pr.add_argument("--synthetic", type=int, default=0, metavar="N",
                    help="score N seeded synthetic examples")
    pr.add_argument("--batch-size", type=int, default=8192)
    pr.add_argument("--device", default=None,
                    help="'cuda' (default) or 'cpu' (the kernels' plain versions)")
    pr.add_argument("--out", help="output file ('-' = stdout)")
    pr.set_defaults(fn=cmd_predict)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
