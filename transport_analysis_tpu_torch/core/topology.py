"""Static topology: per-atom / per-residue / per-segment attribute arrays.

A compact stand-in for the slice of MDAnalysis topology the reference
consumes: ``ag.masses`` (reference viscosity.py:123), plus the attributes
the selection language filters on (``name``, ``resname``, ``resid`` — used
by test selections like "name O and resname WAT and resid 1-10",
reference test_velocityautocorr.py:29).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# attribute name → (level, dtype, default)
_ATTR_SPECS = {
    "names": ("atom", "U16", ""),
    "types": ("atom", "U16", ""),
    "elements": ("atom", "U8", ""),
    "masses": ("atom", np.float64, 0.0),
    "charges": ("atom", np.float64, 0.0),
    "ids": ("atom", np.int64, 0),
    "resids": ("residue", np.int64, 1),
    "resnums": ("residue", np.int64, 1),
    "resnames": ("residue", "U16", ""),
    "segids": ("segment", "U16", ""),
    "icodes": ("residue", "U4", ""),
}

# singular aliases accepted by add_TopologyAttr
_SINGULAR = {
    "name": "names",
    "type": "types",
    "element": "elements",
    "mass": "masses",
    "charge": "charges",
    "resid": "resids",
    "resnum": "resnums",
    "resname": "resnames",
    "segid": "segids",
}


class Topology:
    def __init__(
        self,
        n_atoms: int,
        n_residues: int = 1,
        n_segments: int = 1,
        atom_resindex: Optional[np.ndarray] = None,
        residue_segindex: Optional[np.ndarray] = None,
    ):
        self.n_atoms = int(n_atoms)
        self.n_residues = int(n_residues)
        self.n_segments = int(n_segments)
        self.atom_resindex = (
            np.zeros(n_atoms, np.int64)
            if atom_resindex is None
            else np.asarray(atom_resindex, np.int64)
        )
        self.residue_segindex = (
            np.zeros(n_residues, np.int64)
            if residue_segindex is None
            else np.asarray(residue_segindex, np.int64)
        )
        self._attrs: dict = {}

    def has(self, attr: str) -> bool:
        return attr in self._attrs

    def _level_size(self, level: str) -> int:
        return {
            "atom": self.n_atoms,
            "residue": self.n_residues,
            "segment": self.n_segments,
        }[level]

    def add_attr(self, name: str, values=None):
        name = _SINGULAR.get(name, name)
        if name not in _ATTR_SPECS:
            raise ValueError(f"unknown topology attribute {name!r}")
        level, dtype, default = _ATTR_SPECS[name]
        size = self._level_size(level)
        if values is None:
            arr = np.full(size, default, dtype=dtype)
        else:
            values = np.asarray(values)
            if values.shape == ():
                arr = np.full(size, values, dtype=dtype)
            elif len(values) == size:
                arr = values.astype(dtype)
            elif level != "atom" and len(values) == self.n_atoms:
                # given per-atom: reduce to per-residue, but only when the
                # values are constant within each residue — silently
                # collapsing distinct per-atom values would lose data
                # (e.g. resids 1..10 on a 1-residue Universe.empty)
                values = values.astype(dtype)
                arr = np.full(size, default, dtype=dtype)
                arr[self.atom_resindex] = values
                if not np.array_equal(arr[self.atom_resindex], values):
                    raise ValueError(
                        f"{name}: expected {size} values (one per "
                        f"{level}), got {len(values)} per-atom values "
                        f"that are not constant within each {level}; "
                        "build the Universe with n_residues/"
                        "atom_resindex matching the data"
                    )
            else:
                raise ValueError(
                    f"{name}: expected {size} values, got {len(values)}"
                )
        self._attrs[name] = arr

    def get_atom_values(self, name: str) -> np.ndarray:
        """Attribute broadcast to per-atom granularity."""
        name = _SINGULAR.get(name, name)
        if name not in self._attrs:
            from ..utils.errors import NoDataError

            raise NoDataError(f"Topology has no attribute {name!r}")
        level, _, _ = _ATTR_SPECS[name]
        arr = self._attrs[name]
        if level == "atom":
            return arr
        if level == "residue":
            return arr[self.atom_resindex]
        return arr[self.residue_segindex[self.atom_resindex]]

    def get_raw(self, name: str) -> np.ndarray:
        return self._attrs[_SINGULAR.get(name, name)]
