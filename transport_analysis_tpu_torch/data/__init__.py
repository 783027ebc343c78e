"""The ethylene-carbonate sample files and their generator: not ported
yet, they come with the file formats (ROADMAP.md queue 1 item 1). Every
name of ``transport_analysis_tpu.data`` raises ``NotImplementedError``
here."""

from ..utils.errors import not_ported_module

__getattr__ = not_ported_module("data", "io")
