#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's autocorrelation under each FFT plan.

    python3 scripts/fft_plan_sweep.py [--out build/fft_plan_sweep.json]

Runs on one CUDA Hopper card, from the repository root. For each case
(M, P, d), every balanced plan of two to six levels (each level a power of
two <= 512, longer levels first, as ``cuda_fft.plan_levels`` lays them out)
runs ``cuda_fft.autocorr_power_sum`` on the same random float32 series of
N = M/2 frames and P·d columns, and ``cuda_fft.fft_forward`` on its packed
operand. Times are CUDA-event milliseconds, the median of three after one
warm call; each plan's result is held against the first plan's. One JSON
line per (case, plan) goes to standard output and to ``--out``; the card's
name and power limit head the output. This is how ``PLAN_LEVEL`` in
``ops/cuda_fft.py`` was chosen.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [  # (M, P, d)
    (2 ** 14, 3680, 3),   # the EC system at 8,192 frames
    (2 ** 17, 3680, 3),   # the EC system at 65,536 frames
    (2 ** 18, 16, 3),     # bench.py's deep rung, 131,072 frames x 16 atoms
    (2 ** 21, 80, 3),     # 1,048,576 frames x 80 atoms
    (2 ** 24, 8, 3),      # the top of the range, 8,388,608 frames
]


def balanced_plans(m: int, max_level: int = 512):
    bits = m.bit_length() - 1
    for n_levels in range(2, 7):
        q, r = divmod(bits, n_levels)
        plan = tuple(1 << (q + (i < r)) for i in range(n_levels))
        if max(plan) <= max_level and min(plan) >= 2:
            yield plan


def time_ms(torch, fn, reps: int = 3) -> float:
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="build/fft_plan_sweep.json")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("fft_plan_sweep: needs a CUDA card")
    sys.path.insert(0, ROOT)
    from transport_analysis_tpu_torch.ops import cuda_fft

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    default_plan = cuda_fft.plan_levels
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    rows = []
    for m, P, d in CASES:
        n = m // 2
        x = torch.randn((n, P * d), dtype=torch.float32, device=dev,
                        generator=g)
        first = None
        for plan in balanced_plans(m):
            cuda_fft.plan_levels = lambda _m, p=plan: p
            try:
                out = cuda_fft.autocorr_power_sum(x, m, P, d)
                if first is None:
                    first = out
                err = float((out - first).abs().max() / first.abs().max())
                del out
                ms = time_ms(torch, lambda: cuda_fft.autocorr_power_sum(
                    x, m, P, d))
                z = cuda_fft.pack_pairs(x, m)
                fwd_ms = time_ms(torch, lambda: cuda_fft.fft_forward(z))
                del z
            finally:
                cuda_fft.plan_levels = default_plan
            row = {"m": m, "n": n, "P": P, "d": d, "plan": list(plan),
                   "default": plan == default_plan(m), "autocorr_ms": ms,
                   "forward_ms": fwd_ms, "rel_err_vs_first": err,
                   "card": smi}
            rows.append(row)
            print(json.dumps(row), flush=True)
        del x, first
        torch.cuda.empty_cache()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
