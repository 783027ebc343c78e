"""Atom-selection mini-language.

Covers the subset of the MDAnalysis selection DSL exercised by the
reference test-suite and docs: keyword filters (``name O``,
``resname WAT``, ``resid 1-10``; reference test_velocityautocorr.py:29),
boolean composition (``and`` / ``or`` / ``not``, parentheses), ``all`` /
``none``, ``protein`` / ``backbone``, index/mass filters, and the
geometric ``around R <sel>`` used to build UpdatingAtomGroups
(test_velocityautocorr.py:140).

Selections evaluate to boolean masks over all atoms vectorized with
numpy — no per-atom Python loop.
"""

from __future__ import annotations

import re
from typing import List, Optional

import numpy as np

from ..utils.errors import SelectionError

_PROTEIN_RESNAMES = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "HSD", "HSE", "HSP", "HID", "HIE", "HIP", "CYX", "ASH", "GLH", "ACE",
    "NME", "NMA",
}
_BACKBONE_NAMES = {"N", "CA", "C", "O"}

_KEYWORDS = {
    "and", "or", "not", "all", "none", "name", "resname", "resid", "resnum",
    "type", "segid", "element", "index", "bynum", "id", "mass", "charge",
    "around", "protein", "backbone", "prop", "(", ")", "to",
    "byres", "sphzone", "sphlayer", "cyzone", "cylayer", "point",
}

_PROP_OPS = {
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
    "==": np.equal,
    "!=": np.not_equal,
}


def _tokenize(sel: str) -> List[str]:
    sel = sel.replace("(", " ( ").replace(")", " ) ")
    tokens = sel.split()
    if not tokens:
        raise SelectionError("empty selection string")
    return tokens


class _Parser:
    def __init__(self, universe, tokens: List[str]):
        self.u = universe
        self.tokens = tokens
        self.pos = 0

    def peek(self) -> Optional[str]:
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self) -> str:
        tok = self.peek()
        if tok is None:
            raise SelectionError("unexpected end of selection")
        self.pos += 1
        return tok

    # expr := and_expr ('or' and_expr)*
    def parse_expr(self) -> np.ndarray:
        mask = self.parse_and()
        while self.peek() == "or":
            self.next()
            mask = mask | self.parse_and()
        return mask

    def parse_and(self) -> np.ndarray:
        mask = self.parse_not()
        while self.peek() == "and":
            self.next()
            mask = mask & self.parse_not()
        return mask

    def parse_not(self) -> np.ndarray:
        if self.peek() == "not":
            self.next()
            return ~self.parse_not()
        return self.parse_primary()

    def parse_primary(self) -> np.ndarray:
        tok = self.next()
        n = self.u._topology.n_atoms
        if tok == "(":
            mask = self.parse_expr()
            if self.next() != ")":
                raise SelectionError("missing closing parenthesis")
            return mask
        if tok == "all":
            return np.ones(n, bool)
        if tok == "none":
            return np.zeros(n, bool)
        if tok == "protein":
            resnames = self.u._topology.get_atom_values("resnames")
            return np.isin(resnames, list(_PROTEIN_RESNAMES))
        if tok == "backbone":
            resnames = self.u._topology.get_atom_values("resnames")
            names = self.u._topology.get_atom_values("names")
            return np.isin(resnames, list(_PROTEIN_RESNAMES)) & np.isin(
                names, list(_BACKBONE_NAMES)
            )
        if tok in ("name", "resname", "type", "segid", "element"):
            attr = {
                "name": "names",
                "resname": "resnames",
                "type": "types",
                "segid": "segids",
                "element": "elements",
            }[tok]
            values = self._collect_values()
            return self._string_match(attr, values)
        if tok in ("resid", "resnum"):
            attr = "resids" if tok == "resid" else "resnums"
            target = self.u._topology.get_atom_values(attr)
            return self._int_ranges(target)
        if tok in ("index", "bynum", "id"):
            target = np.arange(n, dtype=np.int64)
            if tok == "bynum":  # 1-based in MDAnalysis
                target = target + 1
            return self._int_ranges(target)
        if tok in ("mass", "charge"):
            attr = "masses" if tok == "mass" else "charges"
            target = self.u._topology.get_atom_values(attr)
            return self._float_ranges(target)
        if tok == "around":
            radius = float(self.next())
            inner = self.parse_not()
            return self._around(radius, inner)
        if tok == "byres":
            inner = self.parse_not()
            resix = self.u._topology.atom_resindex
            return np.isin(resix, np.unique(resix[inner]))
        if tok == "sphzone":
            radius = float(self.next())
            inner = self.parse_not()
            d2 = self._dist2_to_cog(inner)
            return d2 <= radius * radius
        if tok == "sphlayer":
            r_inner = float(self.next())
            r_outer = float(self.next())
            inner = self.parse_not()
            d2 = self._dist2_to_cog(inner)
            return (d2 >= r_inner * r_inner) & (d2 <= r_outer * r_outer)
        if tok == "cyzone":
            r_ext = float(self.next())
            z_max = float(self.next())
            z_min = float(self.next())
            inner = self.parse_not()
            return self._cylinder(0.0, r_ext, z_min, z_max, inner)
        if tok == "cylayer":
            r_in = float(self.next())
            r_ext = float(self.next())
            z_max = float(self.next())
            z_min = float(self.next())
            inner = self.parse_not()
            return self._cylinder(r_in, r_ext, z_min, z_max, inner)
        if tok == "point":
            x = float(self.next())
            y = float(self.next())
            z = float(self.next())
            radius = float(self.next())
            pos = self.u.trajectory.ts.positions.astype(np.float64)
            d = self._min_image(pos - np.array([x, y, z]))
            return np.sum(d * d, axis=-1) <= radius * radius
        if tok == "prop":
            return self._prop()
        raise SelectionError(f"unknown selection keyword {tok!r}")

    # --- helpers -----------------------------------------------------------
    def _collect_values(self) -> List[str]:
        values = []
        while self.peek() is not None and self.peek() not in _KEYWORDS:
            values.append(self.next())
        if not values:
            raise SelectionError("keyword expects at least one value")
        return values

    def _string_match(self, attr: str, values: List[str]) -> np.ndarray:
        target = self.u._topology.get_atom_values(attr)
        mask = np.zeros(len(target), bool)
        for v in values:
            if "*" in v or "?" in v:
                pat = re.compile(
                    "^" + re.escape(v).replace(r"\*", ".*").replace(r"\?", ".")
                    + "$"
                )
                mask |= np.array([bool(pat.match(t)) for t in target])
            else:
                mask |= target == v
        return mask

    def _int_ranges(self, target: np.ndarray) -> np.ndarray:
        mask = np.zeros(len(target), bool)
        got = False
        while True:
            tok = self.peek()
            if tok is None or (tok in _KEYWORDS and tok != "to"):
                break
            self.next()
            m = re.match(r"^(-?\d+)[-:](-?\d+)$", tok)
            if m:
                lo, hi = int(m.group(1)), int(m.group(2))
                mask |= (target >= lo) & (target <= hi)
            elif self.peek() == "to":
                self.next()
                hi = int(self.next())
                mask |= (target >= int(tok)) & (target <= hi)
            else:
                mask |= target == int(tok)
            got = True
        if not got:
            raise SelectionError("numeric keyword expects values")
        return mask

    def _float_ranges(self, target: np.ndarray) -> np.ndarray:
        mask = np.zeros(len(target), bool)
        got = False
        while True:
            tok = self.peek()
            if tok is None or tok in _KEYWORDS:
                break
            self.next()
            m = re.match(r"^(-?[\d.eE+]+):(-?[\d.eE+]+)$", tok)
            if m:
                lo, hi = float(m.group(1)), float(m.group(2))
                mask |= (target >= lo) & (target <= hi)
            else:
                mask |= target == float(tok)
            got = True
        if not got:
            raise SelectionError("numeric keyword expects values")
        return mask

    def _prop(self) -> np.ndarray:
        """``prop [abs] <x|y|z|mass|charge> <op> <value>`` comparisons
        on per-atom properties (MDAnalysis 'prop' keyword subset)."""
        tok = self.next()
        use_abs = tok == "abs"
        if use_abs:
            tok = self.next()
        if tok in ("x", "y", "z"):
            axis = {"x": 0, "y": 1, "z": 2}[tok]
            values = self.u.trajectory.ts.positions[:, axis].astype(
                np.float64
            )
        elif tok in ("mass", "charge"):
            values = self.u._topology.get_atom_values(
                "masses" if tok == "mass" else "charges"
            ).astype(np.float64)
        else:
            raise SelectionError(f"prop: unknown property {tok!r}")
        op_tok = self.next()
        if op_tok not in _PROP_OPS:
            raise SelectionError(f"prop: unknown operator {op_tok!r}")
        rhs = float(self.next())
        if use_abs:
            values = np.abs(values)
        return _PROP_OPS[op_tok](values, rhs)

    def _ortho_box(self):
        """Orthorhombic box lengths, or None (no box / triclinic —
        triclinic minimum image is not implemented; those boxes fall
        back to non-periodic distances, documented in docs/api.md)."""
        dims = self.u.trajectory.ts.dimensions
        if dims is None:
            return None
        dims = np.asarray(dims, np.float64)
        if np.all(dims[:3] > 0) and np.allclose(dims[3:], 90.0):
            return dims[:3]
        return None

    def _min_image(self, delta: np.ndarray) -> np.ndarray:
        """Minimum-image convention applied to displacement vectors
        (MDAnalysis applies PBC to geometric selections when the
        Timestep carries a box)."""
        box = self._ortho_box()
        if box is not None:
            delta = delta - box * np.round(delta / box)
        return delta

    def _dist2_to_cog(self, inner: np.ndarray) -> np.ndarray:
        """Squared min-image distance of every atom to the center of
        geometry of ``inner`` (sphzone/sphlayer reference point)."""
        pos = self.u.trajectory.ts.positions.astype(np.float64)
        if not inner.any():
            return np.full(len(pos), np.inf)
        cog = pos[inner].mean(axis=0)
        d = self._min_image(pos - cog)
        return np.sum(d * d, axis=-1)

    def _cylinder(self, r_in, r_ext, z_min, z_max, inner) -> np.ndarray:
        """Cylindrical zone/layer around the cog of ``inner``: radial
        bounds in xy, axial bounds along z (cyzone/cylayer)."""
        pos = self.u.trajectory.ts.positions.astype(np.float64)
        if not inner.any():
            return np.zeros(len(pos), bool)
        cog = pos[inner].mean(axis=0)
        d = self._min_image(pos - cog)
        r2 = d[:, 0] ** 2 + d[:, 1] ** 2
        mask = (r2 >= r_in * r_in) & (r2 <= r_ext * r_ext)
        return mask & (d[:, 2] >= z_min) & (d[:, 2] <= z_max)

    def _around(self, radius: float, inner: np.ndarray) -> np.ndarray:
        """Atoms strictly within ``radius`` of any atom in ``inner``,
        excluding ``inner`` itself (MDAnalysis ``around`` semantics;
        minimum-image distances when an orthorhombic box is present)."""
        pos = self.u.trajectory.ts.positions
        ref = pos[inner]
        if len(ref) == 0:
            return np.zeros(len(inner), bool)
        delta = self._min_image(
            pos[:, None, :].astype(np.float64) - ref[None, :, :]
        )
        d2 = np.sum(delta * delta, axis=-1)
        mask = (d2 <= radius * radius).any(axis=1)
        return mask & ~inner


def select(universe, selection: str, subset=None) -> np.ndarray:
    """Evaluate ``selection`` → sorted array of atom indices."""
    parser = _Parser(universe, _tokenize(selection))
    mask = parser.parse_expr()
    if parser.peek() is not None:
        raise SelectionError(
            f"trailing tokens in selection: {parser.tokens[parser.pos:]}"
        )
    indices = np.flatnonzero(mask)
    if subset is not None:
        indices = indices[np.isin(indices, subset)]
    return indices
