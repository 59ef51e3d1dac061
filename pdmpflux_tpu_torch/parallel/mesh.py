"""Device meshes for chain-sharded sampling (``pdmpflux_tpu/parallel/mesh.py``).

Independent chains need no communication while they run, so the port
shards them along one axis, ``chains``: each shard is a contiguous range of
the batch on one torch device, and processes join through
``torch.distributed`` (``parallel/distributed.py``), each holding the shards
of its own devices — one card per process is the usual layout.  The JAX
package's second axis, ``dim``, shards the coordinates for
``sample_skeleton_gspmd``, which the port does not have yet: a mesh here
has one device along ``dim``.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch

CHAIN_AXIS = "chains"
DIM_AXIS = "dim"


def _process():
    """``(rank, world_size, distributed)`` of this process's group."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), True
    return 0, 1, False


class Mesh:
    """This process's torch devices along ``chains``, one per local shard,
    and the process group's rank and size: the global shards are the
    processes' local ones in rank order.  ``shape[CHAIN_AXIS]`` is the
    global shard count, as on a JAX mesh."""

    def __init__(self, devices, rank: int = 0, world_size: int = 1,
                 distributed: bool = False):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        self.rank, self.world_size, self.distributed = rank, world_size, distributed

    @property
    def shape(self) -> dict:
        return {CHAIN_AXIS: self.world_size * len(self.devices), DIM_AXIS: 1}

    def local_shards(self) -> List[int]:
        """Global indices of this process's shards."""
        n = len(self.devices)
        return list(range(self.rank * n, (self.rank + 1) * n))

    def __repr__(self) -> str:
        return (f"Mesh(chains={self.shape[CHAIN_AXIS]}, devices={list(self.devices)}, "
                f"rank={self.rank}/{self.world_size})")


def on_device(dev: torch.device):
    """A shard's device as the current CUDA device (the kernels launch on
    the current device's context); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def make_mesh(n_chain_devices: int | None = None, n_dim_devices: int = 1,
              devices=None) -> Mesh:
    """A ``(chains, dim)`` mesh over this process's devices: by default every
    visible card (its own card when a process group of several runs), else
    the CPU.  ``n_chain_devices`` counts shards over all processes; on the
    CPU the shards of a process share the host, so any count divisible by
    the group's size goes."""
    if n_dim_devices != 1:
        raise NotImplementedError(
            f"n_dim_devices={n_dim_devices}: sharding the dim axis is "
            "sample_skeleton_gspmd's, which the port has not ported yet; use "
            "n_dim_devices=1")
    rank, world, dist_on = _process()
    if devices is None:
        if torch.cuda.is_available():
            n = torch.cuda.device_count()
            devices = ([torch.device("cuda", rank % n)] if world > 1
                       else [torch.device("cuda", i) for i in range(n)])
        else:
            devices = [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    if n_chain_devices is not None:
        if n_chain_devices % world:
            raise ValueError(f"n_chain_devices={n_chain_devices} must be divisible by "
                             f"the {world} processes of the group")
        n_local = n_chain_devices // world
        if n_local > len(devices):
            if any(d.type != "cpu" for d in devices):
                raise ValueError(f"n_chain_devices={n_chain_devices} asks for {n_local} "
                                 f"devices in each process; this one has {len(devices)}")
            devices = devices[:1] * n_local
        devices = devices[:n_local]
    return Mesh(devices, rank, world, dist_on)


def chain_spec(mesh: Mesh) -> Tuple[str]:
    """The leading (chain) axis sharded over ``chains``: JAX's
    ``P("chains")``."""
    return (CHAIN_AXIS,)


def chain_sharding(mesh: Mesh, n_chains: int) -> List[Tuple[int, int]]:
    """Each global shard's ``[lo, hi)`` range of an ``n_chains`` batch,
    which must divide evenly (JAX's error text)."""
    n_shards = mesh.shape[CHAIN_AXIS]
    if n_chains % n_shards != 0:
        raise ValueError(
            f"chain batch {n_chains} must be divisible by the {n_shards}-device "
            f"'chains' mesh axis"
        )
    per = n_chains // n_shards
    return [(i * per, (i + 1) * per) for i in range(n_shards)]
