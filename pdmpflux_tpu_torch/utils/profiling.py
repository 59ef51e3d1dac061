"""Tracing and build-aware timing hooks (``pdmpflux_tpu/utils/profiling.py``).

* :func:`trace`: a context manager around ``torch.profiler.profile`` with
  the host's activity and, where a card is present, the card's (its
  kernels, copies and sets, under their own names: K1 is
  ``zigzag_chunk_kernel``, K2 the four kernels of ``csrc/compact.cu``); it
  writes a Chrome-format trace that TensorBoard and Perfetto load into
  ``logdir``;
* :func:`annotate`: a named span inside such a trace
  (``torch.profiler.record_function``);
* :func:`timed`: the first call timed apart from the steady state, every
  call synchronized on the cards that hold its output;
* :func:`enable_persistent_cache`: where the kernels' library is built and
  looked for.

The JAX package's first call pays XLA's compile; the port's pays the
``nvcc`` build of ``csrc/*.cu`` at the first kernel launch of a process
(``ops/cuda/build.library``, tens of seconds, or a load when the library
of the same sources is already built), which :func:`timed` splits out the
same way.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch

__all__ = ["trace", "annotate", "timed", "enable_persistent_cache"]


@contextlib.contextmanager
def trace(logdir: str, *, create_perfetto_link: bool = False):
    """Profile everything inside the ``with`` block into ``logdir``.

    The host's activity always, the card's where CUDA is available; the
    trace lands in ``logdir`` as ``<worker>.<time>.pt.trace.json``
    (``torch.profiler.tensorboard_trace_handler``), which TensorBoard's
    profiler plugin and ui.perfetto.dev open.  The block gets the
    ``torch.profiler.profile`` object (its ``events()`` and
    ``key_averages()`` read the same trace in the process).  Usage::

        with profiling.trace("/tmp/pdmp-trace"):
            pt.sample_skeleton(sampler, 10_000, x0, v0, seed=0)

    ``create_perfetto_link``: JAX serves its trace to ui.perfetto.dev and
    prints a link; nothing is served here, so it prints the path of the
    written trace file, to open in ui.perfetto.dev."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    before = set(Path(logdir).rglob("*.json"))
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(str(logdir))) as prof:
        yield prof
    if create_perfetto_link:
        for path in sorted(set(Path(logdir).rglob("*.json")) - before):
            print(f"Perfetto trace: {path} (open it at https://ui.perfetto.dev)")


def annotate(name: str):
    """A named span inside a profiler trace
    (``torch.profiler.record_function``), usable as a context manager; it
    costs a few microseconds of host time and records nothing unless a
    trace is active."""
    return torch.profiler.record_function(name)


def _cuda_devices(tree, found=None) -> set:
    """The CUDA devices of every tensor in ``tree`` (tuples, named tuples
    such as ``Skeleton``, lists and dicts, nested)."""
    found = set() if found is None else found
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            found.add(tree.device)
    elif isinstance(tree, dict):
        for leaf in tree.values():
            _cuda_devices(leaf, found)
    elif isinstance(tree, (tuple, list)):
        for leaf in tree:
            _cuda_devices(leaf, found)
    return found


def _block(tree):
    for dev in _cuda_devices(tree):
        torch.cuda.synchronize(dev)
    return tree


def timed(fn, *args, repeats: int = 3, **kwargs):
    """Time ``fn(*args, **kwargs)`` with the first call's cost split out.

    Returns a dict::

        {"first_call_s":  wall of call #1 (the kernels' nvcc build or load
                          at a process's first launch, allocation, run),
         "steady_state_s": median wall of ``repeats`` later calls,
         "compile_overhead_s": first - steady (>= 0),
         "result": output of the last call}

    Every call is synchronized on each card that holds a tensor of its
    output, so the numbers are walls of the work, not of its launch."""
    t0 = time.perf_counter()
    out = _block(fn(*args, **kwargs))
    first = time.perf_counter() - t0

    walls = []
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        out = _block(fn(*args, **kwargs))
        walls.append(time.perf_counter() - t0)
    walls.sort()
    steady = walls[len(walls) // 2]
    return {
        "first_call_s": first,
        "steady_state_s": steady,
        "compile_overhead_s": max(0.0, first - steady),
        "result": out,
    }


def enable_persistent_cache(path: str) -> None:
    """Build the kernels' library into ``path`` and look for it there
    (``ops/cuda/build.BUILD_DIR``), so that later processes that make the
    same call load the library built there instead of running ``nvcc``
    again (a source hash names the library).  A process that has already
    loaded the library keeps it: the directory counts from the next
    process's first launch."""
    from ..ops.cuda import build

    build.BUILD_DIR = Path(path)
