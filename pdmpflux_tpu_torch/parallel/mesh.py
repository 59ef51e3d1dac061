"""Device meshes for sharded sampling (``pdmpflux_tpu/parallel/mesh.py``).

Independent chains need no communication while they run, so the port
shards them along the axis ``chains``: each shard is a contiguous range of
the batch on one torch device, and processes join through
``torch.distributed`` (``parallel/distributed.py``), each holding the shards
of its own devices — one card per process is the usual layout.  The second
axis, ``dim``, shards the coordinates for ``sample_skeleton_gspmd``: its
slices lie on processes, laid out chain-major as JAX's
``devices.reshape(chains, dim)`` lays devices, so rank ``r`` holds slice
``r % n_dim`` of the coordinates for the chain shards of row ``r // n_dim``.
Each row of processes forms a dim group (the transition's reductions over
coordinates, ``core/dims.py``), and each column a chain group (the results
gathered over chains); the chain-sharded drivers run every slice of a row
alike, as JAX's ``shard_map`` over ``chains`` replicates over ``dim``.
"""

from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch

from ..core.dims import LOCAL, ShardedDims

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
    the process group's rank and size, and the ``dim`` axis laid over the
    processes: the global chain shards are the local ones of each row of
    ``n_dim`` processes in row order.  ``shape`` has both axes, as on a JAX
    mesh.  ``chain_group`` is the process group to gather chain shards over
    (None: the whole group), ``dim_group`` this row's group, which
    :meth:`dims` reduces over (None: the coordinates are all local)."""

    def __init__(self, devices, rank: int = 0, world_size: int = 1,
                 distributed: bool = False, n_dim: int = 1, chain_group=None,
                 dim_group=None):
        self.devices: Tuple[torch.device, ...] = tuple(torch.device(d) for d in devices)
        self.rank, self.world_size, self.distributed = rank, world_size, distributed
        self.n_dim, self.chain_group, self.dim_group = n_dim, chain_group, dim_group

    @property
    def shape(self) -> dict:
        return {CHAIN_AXIS: self.world_size // self.n_dim * len(self.devices),
                DIM_AXIS: self.n_dim}

    def local_shards(self) -> List[int]:
        """Global indices of this process's chain shards."""
        n, row = len(self.devices), self.rank // self.n_dim
        return list(range(row * n, (row + 1) * n))

    def dims(self, d: int):
        """The coordinate group of this process for ``d`` coordinates: its
        slice of the ``dim`` axis over its row's processes, or every
        coordinate on a ``dim`` axis of 1."""
        if self.n_dim == 1:
            return LOCAL
        return ShardedDims(d, self.rank % self.n_dim, self.n_dim, self.dim_group)

    def __repr__(self) -> str:
        return (f"Mesh(chains={self.shape[CHAIN_AXIS]}, dim={self.n_dim}, "
                f"devices={list(self.devices)}, rank={self.rank}/{self.world_size})")


_GROUPS: dict = {}


def _groups(rank: int, world: int, n_dim: int):
    """``(chain_group, dim_group)`` of rank ``rank``.  Every process makes
    every group, in the same order (``new_group`` is collective), once per
    process group and layout.  With ``n_dim == 1`` the chain group is the
    whole group and there is no dim group (a row of one process holds every
    coordinate); a row of several is the whole group when it is the only
    one."""
    dist = torch.distributed
    world_pg = dist.group.WORLD
    key = (world_pg, world, n_dim)
    if key not in _GROUPS:
        rows = world // n_dim
        if n_dim == 1:
            chain = [None]
        else:
            chain = [dist.new_group([k + r * n_dim for r in range(rows)])
                     for k in range(n_dim)]
        if n_dim == 1:
            dim = [None] * rows
        elif rows == 1:
            dim = [world_pg]
        else:
            dim = [dist.new_group(list(range(r * n_dim, (r + 1) * n_dim)))
                   for r in range(rows)]
        _GROUPS[key] = (chain, dim)
    chain, dim = _GROUPS[key]
    return chain[rank % n_dim if n_dim > 1 else 0], dim[rank // n_dim]


def on_device(dev: torch.device):
    """A shard's device as the current CUDA device (the kernels launch on
    the current device's context); nothing on the CPU."""
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def make_mesh(n_chain_devices: int | None = None, n_dim_devices: int = 1,
              devices=None) -> Mesh:
    """A ``(chains, dim)`` mesh: ``n_dim_devices`` processes of the group
    per row along ``dim``, each holding this process's devices along
    ``chains`` — by default every visible card (its own card when a process
    group of several runs), else the CPU.  ``n_chain_devices`` counts chain
    shards over all rows; on the CPU the shards of a process share the
    host, so any count divisible by the number of rows goes."""
    rank, world, dist_on = _process()
    n_dim = int(n_dim_devices)
    if n_dim < 1 or world % n_dim:
        raise ValueError(
            f"n_dim_devices={n_dim_devices}: the 'dim' axis lays its slices over the "
            f"processes of a torch.distributed group (parallel.initialize), so it must "
            f"divide the group's {world} processes")
    rows = world // n_dim
    if devices is None:
        if torch.cuda.is_available():
            n = torch.cuda.device_count()
            devices = ([torch.device("cuda", rank % n)] if world > 1
                       else [torch.device("cuda", i) for i in range(n)])
        else:
            devices = [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    if n_chain_devices is not None:
        if n_chain_devices % rows:
            raise ValueError(f"n_chain_devices={n_chain_devices} must be divisible by "
                             f"the {rows} processes of the group"
                             + (" along 'chains'" if n_dim > 1 else ""))
        n_local = n_chain_devices // rows
        if n_local > len(devices):
            if any(d.type != "cpu" for d in devices):
                raise ValueError(f"n_chain_devices={n_chain_devices} asks for {n_local} "
                                 f"devices in each process; this one has {len(devices)}")
            devices = devices[:1] * n_local
        devices = devices[:n_local]
    chain_group, dim_group = _groups(rank, world, n_dim) if dist_on else (None, None)
    return Mesh(devices, rank, world, dist_on, n_dim, chain_group, dim_group)


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
