from .base import PDMP  # noqa: F401
from .zigzag import ZigZag, ZigZagAD  # noqa: F401
