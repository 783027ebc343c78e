"""Import-path compatibility: the reference exposes its duecredit shim
as ``transport_analysis.due`` (reference due.py); the port's lives in
``utils.due`` and is re-exported here."""

from .utils.due import BibTeX, Doi, Url, due

__all__ = ["due", "Doi", "BibTeX", "Url"]
