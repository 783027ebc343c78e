#!/usr/bin/env python3
"""The readings that a cell's limits are set from, in one process.

    python3 perfbench/control.py --workload <cell> --seconds <s> \\
        --seeds <n> ... --control-seeds <n> ...

Runs the cell with the program as it stands on each of ``--seeds`` (the
lower readings) and with the program's float32 work mode
(``dtype=np.float32``), the precision below the configuration's
float64, on each of ``--control-seeds`` (the upper readings), each with
a window of ``--seconds`` at the cell's own load, and prints one JSON
line a run: the numbers compared, beside their limits, and whether the
run came out correct. The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--seeds", type=int, nargs="*", default=[])
    parser.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from perfbench.harness import run_cell
    from perfbench.spec import Cell

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload, root=ROOT)
    runs = ([(s, None) for s in args.seeds]
            + [(s, "float32") for s in args.control_seeds])
    for seed, dtype in runs:
        t0 = time.perf_counter()
        r = run_cell(cell, seed, args.seconds, False, dtype=dtype,
                     t_start=t0,
                     log=lambda *a: print(*a, file=sys.stderr, flush=True))
        print(json.dumps({
            "workload": cell.name, "seed": seed,
            "run": "control float32" if dtype else "program",
            "correct": r["correct"], "attempted": r["attempted"],
            "failed": r["failed"], "errors": len(r["errors"]),
            "wall_s": time.perf_counter() - t0,
            "checked": r["checked"]}), flush=True)
        del r
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
