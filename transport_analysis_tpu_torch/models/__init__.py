from .base import AnalysisBase, Results
from .velocityautocorr import VelocityAutocorr
from .viscosity import ViscosityHelfand
from .msd import EinsteinMSD

__all__ = [
    "AnalysisBase",
    "Results",
    "VelocityAutocorr",
    "ViscosityHelfand",
    "EinsteinMSD",
]
