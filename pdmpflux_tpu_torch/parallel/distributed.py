"""Process groups and cross-process reductions
(``pdmpflux_tpu/parallel/distributed.py``).

A multi-process run forms a ``torch.distributed`` group (NCCL between
cards, gloo on the CPU), builds a mesh over every process's devices and
runs the chain-sharded drivers; chains need no communication while they
run, so only results cross processes: the shards' transition counts, the
skeleton statistics, pooled moments and streaming accumulators.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from . import mesh as mesh_lib


def initialize(coordinator_address=None, num_processes=None, process_id=None,
               backend=None) -> bool:
    """Form the process group over ``tcp://coordinator_address`` (a no-op
    returning False for one process or none, as in JAX, unless ``backend``
    names one: a group of one process then reaches the collectives too).
    The backend is NCCL where CUDA is available, else gloo; with NCCL each
    process takes card ``process_id`` modulo the visible cards."""
    if (num_processes is None or num_processes <= 1) and backend is None:
        return False
    rank = int(process_id or 0)
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes or 1), rank=rank)
    return True


def global_mesh(n_dim_devices: int = 1) -> mesh_lib.Mesh:
    """A mesh over every device of every process of the group, with
    ``n_dim_devices`` processes per row along ``dim``."""
    return mesh_lib.make_mesh(None, n_dim_devices)


def process_local_chain_slice(total_chains: int):
    """The ``[start, stop)`` chain range this process owns (JAX's
    arithmetic: equal shares, the last process takes the remainder)."""
    p, n, _ = mesh_lib._process()
    per = total_chains // n
    return p * per, (p + 1) * per if p < n - 1 else total_chains


def _comm_device(group=None):
    """Where the group's collectives take their tensors."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM, group=None) -> torch.Tensor:
    """``t`` reduced over ``group`` (None: the whole group; a new tensor on
    ``t``'s device)."""
    out = t.to(_comm_device(group), copy=True)
    dist.all_reduce(out, op=op, group=group)
    return out.to(t.device)


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every process's ``t`` concatenated along dim 0 in rank order over
    ``group`` (None: the whole group; the processes may hold different
    counts of rows)."""
    dev = _comm_device(group)
    n = torch.tensor([t.shape[0]], dtype=torch.int64, device=dev)
    sizes = [torch.empty_like(n) for _ in range(dist.get_world_size(group))]
    dist.all_gather(sizes, n, group=group)
    sizes = [int(s) for s in sizes]
    pad = t.new_zeros((max(sizes),) + t.shape[1:], device=dev)
    pad[:t.shape[0]] = t.to(dev)
    parts = [torch.empty_like(pad) for _ in sizes]
    dist.all_gather(parts, pad, group=group)
    return torch.cat([p[:s] for p, s in zip(parts, sizes)]).to(t.device)


def host_all_gather_stats(stats: dict) -> dict:
    """Sum scalar stats over the group's processes in float64 (identity
    without a group)."""
    if not (dist.is_available() and dist.is_initialized()):
        return stats
    keys = sorted(stats)
    vals = all_reduce(torch.tensor([float(stats[k]) for k in keys], dtype=torch.float64))
    return {k: float(vals[i]) for i, k in enumerate(keys)}
