"""pdmpflux_tpu_torch: the PDMP sampler ported to PyTorch and CUDA (Hopper).

The JAX package ``pdmpflux_tpu`` is the reference; this package mirrors its
layout (``core``, ``models``, ``ops``, ``parallel``, ``utils``, ``api``) and
never imports JAX.  Ported: the event-count and time-horizon paths of
every sampler of the JAX package (Zig-Zag, Sticky Zig-Zag, Speed-Up
Zig-Zag, BPS, Boomerang, Forward ECMC and RHMC).  Their stream fills come
from the hand-written kernels in ``csrc/`` (the fused Zig-Zag chunk kernel,
its sticky chain-per-CTA variant, the Speed-Up Zig-Zag chunk kernel and the
warp-per-chain scalar-rate chunk kernel, each with a horizon mode: every
Pallas kernel of the JAX package has its counterpart) or from the transition
engine (``core/engine.py``, plain torch on the device: RHMC, scalar bounds,
finite-difference tangents, a gradient of the user's own with
``backend="xla_stream"``),
and every fill is compacted by the event-row compaction kernel.  Also the
diagnostics (ESS, split-R-hat, realized volatility), checkpoint/resume of
``sample_skeleton``, host accumulation of skeletons past the card's memory,
streaming statistics (``sample_streaming_stats``, which folds horizon-mode
fills into O(B * d) accumulators), chain-sharded runs over
``torch.distributed`` process groups and the coordinate-sharded
``sample_skeleton_gspmd`` (``parallel``), plotting (``plotting``) and
profiling (``utils.profiling``).
"""

from . import diagnostics  # noqa: F401
from .api import (  # noqa: F401
    sample,
    sample_from_skeleton,
    sample_skeleton,
    sample_skeleton_with_diagnostic,
)
from .core.types import (  # noqa: F401
    BoundBox,
    EV_INIT,
    EV_JUMP,
    EV_NONE,
    EV_STICK,
    EV_TERMINAL,
    EV_THAW,
    Event,
    PDMPState,
    Skeleton,
)
from .models import (  # noqa: F401
    BPS,
    BPSAD,
    Boomerang,
    BoomerangAD,
    ForwardECMC,
    ForwardECMCAD,
    PDMP,
    RHMC,
    RHMCAD,
    SpeedUpZigZag,
    SpeedUpZigZagAD,
    StickyZigZag,
    StickyZigZagAD,
    ZigZag,
    ZigZagAD,
)
from . import parallel, plotting, utils  # noqa: F401
from .diagnostics import RV_diagnostic, diagnostic, ess, ess_per_dim  # noqa: F401
from .parallel import pooled_moments, sample_from_skeleton_batch  # noqa: F401
from .plotting import (  # noqa: F401
    anim_traj,
    anim_traj_,
    jointplot,
    marginalplot,
    plot_U_contour,
    plot_traj,
)
from .streaming import sample_streaming_stats, streaming_summary  # noqa: F401
from .utils import potentials  # noqa: F401

__version__ = "1.0.0"

__all__ = [
    "sample",
    "sample_from_skeleton",
    "sample_skeleton",
    "sample_skeleton_with_diagnostic",
    "sample_streaming_stats",
    "streaming_summary",
    "BoundBox",
    "Event",
    "PDMPState",
    "Skeleton",
    "EV_INIT",
    "EV_JUMP",
    "EV_NONE",
    "EV_STICK",
    "EV_TERMINAL",
    "EV_THAW",
    "PDMP",
    "ZigZag",
    "ZigZagAD",
    "BPS",
    "BPSAD",
    "Boomerang",
    "BoomerangAD",
    "ForwardECMC",
    "ForwardECMCAD",
    "RHMC",
    "RHMCAD",
    "SpeedUpZigZag",
    "SpeedUpZigZagAD",
    "StickyZigZag",
    "StickyZigZagAD",
]
