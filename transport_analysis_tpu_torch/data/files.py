"""Location of packaged data files.

Use as::

    from transport_analysis_tpu_torch.data.files import ec_top, ec_traj_trr

Mirrors the reference's ``transport_analysis/data/files.py`` surface
(ec_top / ec_traj_trr / a logo text file). The EC trajectory is
generated deterministically on first access (see generate.py) because
the reference's TRR blob is absent from its snapshot; the files land in
``ethylene_carbonate/`` beside this module, which git ignores.
"""

from __future__ import annotations

import os

__all__ = ["LOGO", "MDANALYSIS_LOGO", "ec_top", "ec_traj_trr"]

_HERE = os.path.dirname(os.path.abspath(__file__))

LOGO = os.path.join(_HERE, "logo.txt")
# compatibility alias matching the reference's exported name
MDANALYSIS_LOGO = LOGO


def _ec_paths():
    from .generate import ensure_generated

    return ensure_generated(os.path.join(_HERE, "ethylene_carbonate"))


def __getattr__(name):
    if name == "ec_top":
        return _ec_paths()[0]
    if name == "ec_traj_trr":
        return _ec_paths()[1]
    raise AttributeError(name)
