#!/usr/bin/env python3
"""Check and time the FP64 tensor-core shapes of Hopper's ``mma.sync``.

    python3 scripts/dmma_shapes.py

Builds ``scripts/dmma_shapes.cu`` with ``nvcc`` for ``sm_90a`` into
``build/dmma/``, prints the card's name and power limit, counts the
``DMMA`` instructions in the built SASS (``cuobjdump -sass``), and runs
it: each shape's fragment layout is held against a host product on one
warp (the layouts ``csrc/lag.cu`` assumes), then each shape's rate is
timed on register operands (CUDA events, best of 5), beside the 67
TFLOP/s FP64 tensor-core peak of the H100 SXM data sheet. Exits non-zero
if a layout is wrong or no card is there.
"""

from __future__ import annotations

import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from transport_analysis_tpu_torch._build import find_nvcc  # noqa: E402


def main() -> int:
    nvcc = find_nvcc()
    out_dir = os.path.join(ROOT, "build", "dmma")
    os.makedirs(out_dir, exist_ok=True)
    exe = os.path.join(out_dir, "dmma_shapes")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-o", exe,
                    os.path.join(ROOT, "scripts", "dmma_shapes.cu")],
                   check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", exe], capture_output=True,
                          text=True).stdout
    ops = [tok for tok in sass.split() if tok.startswith("DMMA")]
    print(f"DMMA instructions in the SASS: {len(ops)} "
          f"({', '.join(sorted(set(ops)))})", flush=True)
    return subprocess.run([exe]).returncode


if __name__ == "__main__":
    sys.exit(main())
