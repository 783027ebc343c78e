from .timestep import Timestep
from .trajectory import MemoryReader, ProtoReader
from .universe import Universe
from .groups import AtomGroup, UpdatingAtomGroup

__all__ = [
    "Timestep",
    "MemoryReader",
    "ProtoReader",
    "Universe",
    "AtomGroup",
    "UpdatingAtomGroup",
]
