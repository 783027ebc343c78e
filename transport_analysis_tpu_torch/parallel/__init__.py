"""Multi-device parallelism: not ported yet (ROADMAP.md queue 1 item 5).
The port runs on one card; every name of ``transport_analysis_tpu.parallel``
raises ``NotImplementedError`` here."""

from ..utils.errors import not_ported_module

__getattr__ = not_ported_module("parallel", "multigpu")
