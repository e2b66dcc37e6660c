"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. It prints, as the last line of standard output, one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks`` (each compared number with its limit, also the last lines of
standard error). Without a card, without the program, or with JAX loaded
it prints no result and exits non-zero; it never falls back to the CPU.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

#: Top-level module names that must not be loaded: JAX and the JAX
#: package the port was made from (compared whole: the port's own name
#: begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "fm_spark_tpu")


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _card(device) -> dict:
    import torch

    out = {"name": torch.cuda.get_device_name(device)}
    try:
        got = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader", f"--id={device.index}"],
            capture_output=True, text=True, timeout=20, check=True)
        out["power_limit"] = got.stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["power_limit"] = f"not read ({type(e).__name__})"
    return out


def result_line(got: dict, device_block: dict) -> dict:
    """The result object: ``correct``, ``attempted``, ``failed``,
    ``metrics``, ``device``, ``breakdown`` when traced, and ``checks``
    last."""
    line = {"correct": bool(got["correct"]), "attempted": got["attempted"],
            "failed": got["failed"], "metrics": got["metrics"],
            "device": device_block}
    if "breakdown" in got:
        line["breakdown"] = got["breakdown"]
    line["checks"] = got["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import cells

    cell = cells.load(args.workload)
    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found {found}; no result", file=sys.stderr)
        return 2
    try:
        importlib.import_module("fm_spark_tpu_torch")
    except ImportError as e:
        print(f"benchmark: the program under test cannot be imported ({e}); "
              "no result", file=sys.stderr)
        return 3
    driver = importlib.import_module(
        f"benchmark.drivers.{cell['config']['driver']}")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    got = driver.run(cell, args.seed, args.seconds, bool(args.trace), device,
                     T_START, cell["limits"])
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: forbidden modules loaded: {bad}; no result",
              file=sys.stderr)
        return 4
    block = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
             "count": cell["chips"], "memory_peak_bytes": got["peak"]}
    if args.trace:
        if "busy_s" not in got:
            print("benchmark: the profiled span recorded nothing; no result",
                  file=sys.stderr)
            return 5
        block["busy_s"], block["window_s"] = got["busy_s"], got["window_s"]
    for early in [*got["early"], {"card": _card(device)}]:
        print(json.dumps(early), flush=True)
    line = result_line(got, block)
    for name, c in got["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
