"""Scale-out layer (``pdmpflux_tpu/parallel``): device meshes over
``torch.distributed`` process groups, the chain-sharded drivers, the
coordinate-sharded ``sample_skeleton_gspmd``, and checkpointing."""

from .mesh import CHAIN_AXIS, DIM_AXIS, chain_sharding, make_mesh
from .sharded import (
    ShardedRun,
    pooled_moments,
    sample_from_skeleton_batch,
    sample_skeleton_gspmd,
    sample_skeleton_sharded,
)
from .distributed import global_mesh, initialize
from .checkpoint import load_checkpoint, save_checkpoint

__all__ = [
    "CHAIN_AXIS",
    "DIM_AXIS",
    "chain_sharding",
    "make_mesh",
    "ShardedRun",
    "pooled_moments",
    "sample_from_skeleton_batch",
    "sample_skeleton_gspmd",
    "sample_skeleton_sharded",
    "global_mesh",
    "initialize",
    "load_checkpoint",
    "save_checkpoint",
]
