from .mps import read_mps, parse_mps
from .mps_write import write_mps

__all__ = ["read_mps", "parse_mps", "write_mps"]
