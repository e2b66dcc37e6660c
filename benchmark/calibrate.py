"""The readings the limits of ``benchmark/limits/<cell>.json`` are set
from, at the cell's own size on the card, in one process:

    python3 -m benchmark.calibrate --workload <cell> --seeds 12 \\
        --control-seeds 3 --fault-seeds 3 [--out FILE]

For each seed, the compared numbers of the program's first three
steps against the reference (the lower readings); of the control, the
reference computed in the precision below the configuration's (fp8 for
bf16 compute), in the program's place; and of each planted fault of
``benchmark.faults``. Prints one JSON line per reading and a summary.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

#: The control's precision for each stated compute dtype.
LOWER = {"bfloat16": "float8_e4m3fn", "float32": "bfloat16"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--first-seed", type=int, default=3_000_000_019)
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark import cells, compare, faults
    from benchmark.drivers import fit_field_sparse as driver

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    cell = cells.load(args.workload)
    dev = torch.device("cuda", 0)
    lower = LOWER[cell["config"]["compute_dtype"]]
    plan = ([("program", None, i) for i in range(args.seeds)]
            + [("control", None, i) for i in range(args.control_seeds)]
            + [(f"fault_{k}", k, i) for k in faults.KINDS
               for i in range(args.fault_seeds)])
    rows = []
    for what, kind, i in plan:
        seed = args.first_seed + 7919 * i
        if what == "control":
            got, raw = driver.readings(cell, seed, dev, lower=lower)
        elif kind is not None:
            with faults.planted(kind):
                got, raw = driver.readings(cell, seed, dev)
        else:
            got, raw = driver.readings(cell, seed, dev)
        row = {"cell": args.workload, "what": what, "seed": seed,
               **{k: v[0] for k, v in got.items()},
               "worst_at": {k: v[1] for k, v in got.items()}}
        print(json.dumps(row), flush=True)
        rows.append({**row, "raw": raw})
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for what in dict.fromkeys(r["what"] for r in rows):
        sel = [r for r in rows if r["what"] == what]
        summary[what] = {k: [min(r[k] for r in sel), max(r[k] for r in sel)]
                         for k in compare.NUMBERS}
    print(json.dumps({"summary": summary, "limits": cell["limits"]}),
          flush=True)
    if args.out:
        with open(args.out, "w") as fh:
            json.dump({"rows": rows, "summary": summary}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
