"""Import-path compatibility with the reference package layout:
``from transport_analysis_tpu_torch.velocityautocorr import
VelocityAutocorr`` mirrors the reference's
``transport_analysis.velocityautocorr`` (reference
velocityautocorr.py:72)."""

from .models.velocityautocorr import VelocityAutocorr

__all__ = ["VelocityAutocorr"]
