from .errors import NoDataError
from . import units

__all__ = ["NoDataError", "units"]
