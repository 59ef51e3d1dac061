"""The PDMP samplers of the port (``pdmpflux_tpu/models``): Zig-Zag, Sticky
Zig-Zag, Speed-Up Zig-Zag, BPS, Boomerang and Forward ECMC, each with the
chunk kernel that covers it and the transition engine's batched rates,
envelope strategy and velocity jump, and RHMC, which runs on the engine
only."""

from ..core.types import EV_STICK, EV_THAW  # noqa: F401
from .base import PDMP  # noqa: F401
from .boomerang import Boomerang, BoomerangAD  # noqa: F401
from .bps import BPS, BPSAD  # noqa: F401
from .ecmc import ForwardECMC, ForwardECMCAD  # noqa: F401
from .rhmc import RHMC, RHMCAD  # noqa: F401
from .speedup_zigzag import SpeedUpZigZag, SpeedUpZigZagAD  # noqa: F401
from .sticky import StickyZigZag, StickyZigZagAD  # noqa: F401
from .zigzag import ZigZag, ZigZagAD  # noqa: F401
