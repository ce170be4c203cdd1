from .gf import GF
from .extension import GFE
from .hext import HExt
from . import goldilocks, host, np_field

__all__ = ["GF", "GFE", "HExt", "goldilocks", "host", "np_field"]
