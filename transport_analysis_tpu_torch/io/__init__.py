"""Trajectory and topology files: not ported yet (ROADMAP.md queue 1
item 1). Every name of ``transport_analysis_tpu.io`` raises
``NotImplementedError`` here; build a Universe from arrays
(``convert.universe_from_arrays``) or a ``MemoryReader`` instead."""

from ..utils.errors import not_ported_module

__getattr__ = not_ported_module("io", "io")
