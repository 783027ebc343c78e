#!/usr/bin/env python3
"""Run one cell of the benchmark of ``transport_analysis_tpu_torch``.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for. Prints the result as one JSON line, the last of standard output:
with ``--trace 0`` the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics read from one profiler session over the window. The
numbers compared with the plain reference, each beside its limit, end
the line (``checked``) and standard error. Exits non-zero with no result
where there is no card or too few, where the program cannot be imported,
or where JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(ROOT))
    import torch

    log(f"{time.perf_counter() - T_START:9.3f} s  torch imported")

    from perfbench import guard
    from perfbench.spec import Cell

    cell = Cell(args.workload, root=ROOT)
    if not torch.cuda.is_available():
        log("no CUDA card: nothing measured")
        return 2
    if torch.cuda.device_count() < cell.chips:
        log(f"{cell.name} needs {cell.chips} cards, "
            f"{torch.cuda.device_count()} found: nothing measured")
        return 2

    from perfbench.harness import run_cell

    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      device="cuda", t_start=T_START, log=log)
    for err in result["errors"][:1]:
        log(f"a request failed ({len(result['errors'])} in all):\n{err}")
    found = guard.loaded_forbidden()
    if found:
        log(f"forbidden modules loaded: {', '.join(found)}")
        return 3

    if args.trace:
        metrics = {m["name"]: {"value": result["per_layer"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.per_layer
                   if m["name"] in result["per_layer"]}
    else:
        metrics = {m["name"]: {"value": result["end_to_end"][m["name"]],
                               "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": result["memory_peak_bytes"]}
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": metrics,
            "device": device}
    if args.trace:
        device["busy_s"] = result["busy_s"]
        device["window_s"] = result["traced_window_s"]
        line["breakdown"] = result["breakdown"]
    line["window"] = {"seconds": result["window_s"],
                      "setup_s": result["end_to_end"]["setup_s"]}
    line["checked"] = result["checked"]
    for name, c in result["checked"].items():
        log(f"checked {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
