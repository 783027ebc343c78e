"""Tiny copies of the benchmark's cells for the CPU tests: the same
files, with the trajectory, the species' counts, the blocks and the lag
cut made small."""

from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from perfbench.spec import Cell  # noqa: E402

SEED = 2 ** 31 + 12345


def shrink(cell: Cell, frames: int = 384, block: int = 96,
           max_lag: int = 48) -> Cell:
    """``cell`` with each species' count cut to a hundredth (at least
    one), ``frames`` frames, blocks of ``block`` and lag cuts of
    ``max_lag``."""
    for species in cell.config["species"]:
        species["count"] = max(1, species["count"] // 100)
    cell.config["n_frames"] = frames
    if cell.traffic["frames"]["block"]:
        cell.traffic["frames"]["block"] = block
    for analysis in cell.traffic["analyses"]:
        if analysis.get("max_lag"):
            analysis["max_lag"] = max_lag
    return cell


def tiny(name: str, root: Path = ROOT) -> Cell:
    return shrink(Cell(name, root=root, bench_dir=root / "perfbench"))
