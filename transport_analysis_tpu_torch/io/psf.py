"""CHARMM PSF topology parser.

The reference's no-velocities error-path fixtures load PSF/DCD pairs
(reference test_viscosity.py:13,33-40); this parser covers the !NATOM
section (segid, resid, resname, name, type, charge, mass) in both
standard and EXT formats.
"""

from __future__ import annotations

import numpy as np

from ..core.topology import Topology


def parse_psf_topology(path) -> Topology:
    with open(path, "r") as fh:
        first = fh.readline()
        if not first.startswith("PSF"):
            raise IOError(f"{path}: not a PSF file")
        natom = None
        while True:
            line = fh.readline()
            if not line:
                raise IOError(f"{path}: no !NATOM section")
            if "!NATOM" in line:
                natom = int(line.split()[0])
                break
        names, types, segids = [], [], []
        resids, resnames = [], []
        charges, masses = [], []
        for _ in range(natom):
            parts = fh.readline().split()
            # id segid resid resname name type charge mass [imove ...]
            segids.append(parts[1])
            resids.append(int(parts[2]))
            resnames.append(parts[3])
            names.append(parts[4])
            types.append(parts[5])
            charges.append(float(parts[6]))
            masses.append(float(parts[7]))

    # residues: consecutive (segid, resid) runs
    atom_resindex = np.zeros(natom, np.int64)
    res_ids, res_names, res_seg = [], [], []
    prev = None
    for i in range(natom):
        key = (segids[i], resids[i])
        if key != prev:
            res_ids.append(resids[i])
            res_names.append(resnames[i])
            res_seg.append(segids[i])
            prev = key
        atom_resindex[i] = len(res_ids) - 1

    seg_names = []
    for s in res_seg:
        if s not in seg_names:
            seg_names.append(s)
    seg_index = {s: i for i, s in enumerate(seg_names)}
    residue_segindex = np.array([seg_index[s] for s in res_seg], np.int64)

    top = Topology(
        natom,
        n_residues=len(res_ids),
        n_segments=len(seg_names),
        atom_resindex=atom_resindex,
        residue_segindex=residue_segindex,
    )
    top.add_attr("names", names)
    top.add_attr("types", types)
    top.add_attr("charges", charges)
    top.add_attr("masses", masses)
    top.add_attr("resids", res_ids)
    top.add_attr("resnames", res_names)
    top.add_attr("segids", seg_names)
    return top
