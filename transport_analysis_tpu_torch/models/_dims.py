"""Shared dim_type parsing.

The reference duplicates this verbatim in both analyses
(velocityautocorr.py:155-176, viscosity.py:144-165); deduplicated here
with identical semantics and error message.
"""

_DIM_KEYS = {
    "x": [0],
    "y": [1],
    "z": [2],
    "xy": [0, 1],
    "xz": [0, 2],
    "yz": [1, 2],
    "xyz": [0, 1, 2],
}


def parse_dim_type(dim_str: str):
    """Map a dim_type string → (component index list, dimensionality)."""
    try:
        dim = _DIM_KEYS[dim_str]
    except KeyError:
        raise ValueError(
            "invalid dim_type: {} specified, please specify one of xyz, "
            "xy, xz, yz, x, y, z".format(dim_str)
        )
    return dim, len(dim)
