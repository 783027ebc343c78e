"""Deterministic generation of the packaged regression trajectory.

The reference ships an ethylene-carbonate (EC) topology + TRR
trajectory for its viscosity regression test (reference data/files.py:
19-22); the TRR blob is absent from its snapshot. Rather than copying
reference data, this module *generates* an equivalent velocity-bearing
system: 368 EC molecules (3680 atoms, C3H4O3 + ring hydrogens), a 41.4 Å
cubic box, and 100 frames of thermalized Ornstein–Uhlenbeck dynamics at
300 K — deterministic (fixed seed), so the regression value it yields
is stable and pinned in tests. The recipe, seed and writers are those of
``transport_analysis_tpu/data/generate.py``, so both packages write the
same bytes.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np

# ethylene carbonate: (atom name, element, mass) ×10, 368 molecules
EC_ATOMS = [
    ("C1", "C", 12.011),
    ("O1", "O", 15.999),
    ("C2", "C", 12.011),
    ("H1", "H", 1.008),
    ("H2", "H", 1.008),
    ("C3", "C", 12.011),
    ("H3", "H", 1.008),
    ("H4", "H", 1.008),
    ("O2", "O", 15.999),
    ("O3", "O", 15.999),
]
N_MOLECULES = 368
BOX = 41.432  # Å, cubic (the reference topology's cell edge)
N_FRAMES = 100
DT = 1.0  # ps between saved frames
TEMP = 300.0
SEED = 20260816

# local geometry of one EC molecule (Å, approximate ring)
_MOL_OFFSETS = np.array(
    [
        [0.00, 0.00, 0.00],   # C1 (carbonyl C)
        [1.20, 0.45, 0.00],   # O1 (ring O)
        [1.15, 1.85, 0.30],   # C2
        [1.60, 2.05, 1.28],   # H1
        [1.70, 2.45, -0.45],  # H2
        [-0.30, 1.95, 0.40],  # C3
        [-0.75, 2.15, 1.38],  # H3
        [-0.85, 2.55, -0.35], # H4
        [-1.05, 0.65, 0.15],  # O2 (ring O)
        [-0.20, -1.20, -0.15],# O3 (carbonyl O)
    ]
)


def write_topology_pdb(path: str) -> None:
    rng = np.random.RandomState(SEED)
    n_side = int(np.ceil(N_MOLECULES ** (1 / 3)))
    spacing = BOX / n_side
    with open(path, "w") as fh:
        fh.write(
            f"CRYST1{BOX:9.3f}{BOX:9.3f}{BOX:9.3f}"
            f"{90.0:7.2f}{90.0:7.2f}{90.0:7.2f} P 1           1\n"
        )
        serial = 1
        mol = 0
        for ix in range(n_side):
            for iy in range(n_side):
                for iz in range(n_side):
                    if mol >= N_MOLECULES:
                        break
                    origin = (
                        np.array([ix, iy, iz]) * spacing
                        + rng.uniform(0.5, spacing - 3.0, 3)
                    )
                    for (name, el, _), off in zip(EC_ATOMS, _MOL_OFFSETS):
                        x, y, z = origin + off
                        fh.write(
                            f"ATOM  {serial:5d} {name:<4s}"
                            f"ECA A{mol + 1:4d}    "
                            f"{x:8.3f}{y:8.3f}{z:8.3f}"
                            f"  1.00  0.00          "
                            f"{el:>2s}\n"
                        )
                        serial += 1
                    mol += 1
        fh.write("END\n")


def generate_trajectory(top_path: str, trr_path: str) -> None:
    """Ornstein–Uhlenbeck velocities + integrated positions.

    Velocities follow per-atom OU processes with the Maxwell–Boltzmann
    stationary distribution at 300 K (σ² = k_B·T/m in MDAnalysis
    units), so VACF/viscosity statistics are physically sensible and
    fully deterministic.
    """
    from ..io.pdb import parse_pdb_topology
    from ..io.trr import TRRWriter

    top = parse_pdb_topology(top_path)
    masses = top.get_atom_values("masses")
    n_atoms = top.n_atoms

    # k_B T / m in (Å/ps)² (k_B in kJ/(mol·K) = amu·Å²/ps² per mol·K... )
    # MDAnalysis units: k_B = 0.008314462159 kJ/(mol·K); 1 kJ/mol =
    # 100 amu·Å²/ps² → σ_v² = 100·k_B·T/m (Å/ps)²
    kbt = 100.0 * 0.008314462159 * TEMP
    sigma_v = np.sqrt(kbt / masses)[:, None]

    rng = np.random.RandomState(SEED + 1)
    tau = 0.35  # ps velocity correlation time
    theta = np.exp(-DT / tau)
    noise_scale = np.sqrt(1.0 - theta * theta)

    # initial positions + unit cell from the topology PDB (CRYST1 —
    # honors triclinic cells like the reference EC topology's
    # 41.432³ α=β=60 γ=90)
    from ..io.pdb import PDBReader

    first = PDBReader(top_path)[0]
    pos = first.positions.astype(np.float64)
    vel = rng.normal(0, 1, (n_atoms, 3)) * sigma_v

    if first.dimensions is not None:
        dims = list(np.asarray(first.dimensions, np.float64))
    else:
        dims = [BOX, BOX, BOX, 90.0, 90.0, 90.0]
    with TRRWriter(trr_path, n_atoms) as w:
        for frame in range(N_FRAMES):
            w.write(
                positions=pos,
                velocities=vel,
                dimensions=dims,
                time=frame * DT,
            )
            # advance OU velocities, integrate positions
            vel = theta * vel + noise_scale * sigma_v * rng.normal(
                0, 1, (n_atoms, 3)
            )
            pos = pos + vel * DT


def ensure_generated(directory: str) -> tuple[str, str]:
    """Generate (once) and return (topology_pdb, trajectory_trr) paths.

    Each file is written under a name of its own writer and moved into
    place with ``os.replace``, so a concurrent reader (another test
    worker) sees either no file or the whole one."""
    os.makedirs(directory, exist_ok=True)
    top = os.path.join(directory, "topology.pdb")
    trr = os.path.join(directory, "trajectory.trr")
    for path, write in ((top, write_topology_pdb),
                        (trr, lambda tmp: generate_trajectory(top, tmp))):
        if not os.path.exists(path):
            fd, tmp = tempfile.mkstemp(
                prefix=os.path.basename(path) + ".", suffix=".tmp",
                dir=directory)
            os.close(fd)
            try:
                write(tmp)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.remove(tmp)
    return top, trr
