"""PDB topology parsing (and single/multi-frame coordinate reading).

Covers the slice needed for the packaged ethylene-carbonate topology
(reference transport_analysis/data/ethylene_carbonate/topology.pdb,
consumed via ``Universe(ec_top, ec_traj_trr)`` at reference
test_viscosity.py:24-25): ATOM/HETATM records, CRYST1 box, element →
mass assignment.
"""

from __future__ import annotations

import numpy as np

from ..core.topology import Topology
from ..core.trajectory import MemoryReader

# standard atomic masses (amu) for common elements
MASSES = {
    "H": 1.008, "HE": 4.0026, "LI": 6.94, "BE": 9.0122, "B": 10.81,
    "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998, "NE": 20.180,
    "NA": 22.990, "MG": 24.305, "AL": 26.982, "SI": 28.085, "P": 30.974,
    "S": 32.06, "CL": 35.45, "AR": 39.948, "K": 39.098, "CA": 40.078,
    "FE": 55.845, "ZN": 65.38, "BR": 79.904, "I": 126.90, "D": 2.014,
}


def _guess_element(name: str) -> str:
    """Element from an atom name, PDB conventions (digits stripped,
    two-letter elements only when they match a known symbol)."""
    stripped = name.strip().lstrip("0123456789")
    if not stripped:
        return ""
    two = stripped[:2].upper()
    if two in MASSES and not stripped[0].isdigit():
        # prefer two-letter match only for real two-letter elements
        if two in ("CL", "BR", "NA", "MG", "FE", "ZN", "CA", "NE", "HE",
                   "LI", "BE", "SI", "AR", "AL"):
            return two
    one = stripped[0].upper()
    return one if one in MASSES else ""


def _parse_atoms(path):
    names, resnames, resids, segids, elements = [], [], [], [], []
    chain_for_res = []
    frames = []
    coords = []
    cryst = None
    with open(path, "r") as fh:
        for line in fh:
            rec = line[:6]
            if rec in ("ATOM  ", "HETATM"):
                if not frames:  # topology from the first model only
                    names.append(line[12:16].strip())
                    resnames.append(line[17:21].strip())
                    resids.append(int(line[22:26]))
                    segids.append(line[72:76].strip())
                    el = line[76:78].strip().upper()
                    elements.append(el or _guess_element(line[12:16]))
                coords.append(
                    (float(line[30:38]), float(line[38:46]),
                     float(line[46:54]))
                )
            elif rec == "CRYST1":
                cryst = np.array(
                    [float(line[6:15]), float(line[15:24]),
                     float(line[24:33]), float(line[33:40]),
                     float(line[40:47]), float(line[47:54])]
                )
            elif rec.startswith("ENDMDL"):
                frames.append(coords)
                coords = []
    if coords:
        frames.append(coords)
    return (names, resnames, resids, segids, elements), frames, cryst


def parse_pdb_topology(path) -> Topology:
    (names, resnames, resids, segids, elements), _, _ = _parse_atoms(path)
    n_atoms = len(names)

    # group consecutive (resid, resname, segid) rows into residues
    atom_resindex = np.zeros(n_atoms, np.int64)
    res_ids, res_names, res_seg = [], [], []
    prev = None
    for i in range(n_atoms):
        key = (resids[i], resnames[i], segids[i])
        if key != prev:
            res_ids.append(resids[i])
            res_names.append(resnames[i])
            res_seg.append(segids[i])
            prev = key
        atom_resindex[i] = len(res_ids) - 1

    seg_names = sorted(set(res_seg))
    seg_index = {s: i for i, s in enumerate(seg_names)}
    residue_segindex = np.array([seg_index[s] for s in res_seg], np.int64)

    top = Topology(
        n_atoms,
        n_residues=len(res_ids),
        n_segments=max(1, len(seg_names)),
        atom_resindex=atom_resindex,
        residue_segindex=residue_segindex,
    )
    top.add_attr("names", names)
    top.add_attr("elements", elements)
    top.add_attr("masses", [MASSES.get(e, 0.0) for e in elements])
    top.add_attr("resids", res_ids)
    top.add_attr("resnames", res_names)
    top.add_attr("segids", seg_names if seg_names else None)
    return top


class PDBReader(MemoryReader):
    """Coordinates from (possibly multi-MODEL) PDB files."""

    format = "PDB"

    def __init__(self, path):
        _, frames, cryst = _parse_atoms(path)
        coords = np.asarray(frames, dtype=np.float32)
        dims = cryst if cryst is not None else None
        super().__init__(coords, dimensions=dims)
