"""Import-path compatibility with the reference package layout:
``from transport_analysis_tpu_torch.viscosity import ViscosityHelfand``
mirrors the reference's ``transport_analysis.viscosity`` (reference
viscosity.py:26)."""

from .models.viscosity import ViscosityHelfand

__all__ = ["ViscosityHelfand"]
