"""Build the port's CUDA kernels and bind them through ``ctypes``.

``nvcc`` compiles every ``csrc/*.cu`` of the package (they share
``csrc/pdmp_common.cuh``) for Hopper (``sm_90a``) at first use: one
``nvcc -c`` per source, all started together, then one link into a shared
library with a plain C interface.  The library lands in
``pdmpflux_tpu_torch/_build/`` (git-ignored) under a name that hashes the
sources and flags, so an edited source rebuilds and an unchanged one loads
the library already built.

Each kernel wrapper adds one to its entry of :data:`LAUNCHES` where it
launches its kernel, and checks the error code the C launcher returns
(``cudaGetLastError`` right after the launch) with :func:`check`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]
SOURCE_FLAGS = {"scalar_chunk.cu": ["-fmad=false"], "suzz_chunk.cu": ["-fmad=false"]}
"""Flags of one source: K3/K5 and K4 round every product as their plain
version's torch ops do (see the notes in ``csrc/scalar_chunk.cu`` and
``csrc/suzz_chunk.cu``), so that the two round alike.  ``chip_fmad_ab.py``
measures the cost against FMA contraction; PERF.md holds its reading."""

LAUNCHES = {"zigzag_chunk": 0, "sticky_chunk": 0, "bps_chunk": 0, "ecmc_chunk": 0,
            "suzz_chunk": 0, "zigzag_chunk_horizon": 0, "sticky_chunk_horizon": 0,
            "bps_chunk_horizon": 0, "ecmc_chunk_horizon": 0, "suzz_chunk_horizon": 0,
            "compact_rows": 0}
"""Kernel launches since the last :func:`reset_launches`; a chunk kernel's
launches in horizon mode (K7) count under its name with ``_horizon``."""

BUILD_INFO: dict = {}
"""``seconds``, ``path`` and the compiler's ``log`` of the last build."""

_lib = None


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda)")


def _declare(lib) -> None:
    p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    lib.zigzag_chunk_launch.restype = i
    lib.zigzag_chunk_launch.argtypes = (
        [i] * 8                         # f64, potential, d, B, K, n_grid, adaptive, signed
        + [ctypes.c_double]             # refresh rate
        + [i] * 3                       # cap, tile, seed
        + [i, ctypes.c_float]           # horizon mode, its float32 target
        + [p] * 11 + [p]                # params, state, event rows, stream
    )
    lib.zigzag_chunk_lanes.restype = i
    lib.zigzag_chunk_lanes.argtypes = [i]
    lib.zigzag_chunk_set_lanes.restype = i
    lib.zigzag_chunk_set_lanes.argtypes = [i]
    lib.suzz_chunk_launch.restype = i
    lib.suzz_chunk_launch.argtypes = (
        [i] * 8 + [ctypes.c_double] + [i] * 3 + [i, ctypes.c_float]
        + [p] * 6                       # params, x, v, fs, iscal, ring
        + [p] * 5 + [p]                 # event rows, stream
    )
    lib.sticky_chunk_launch.restype = i
    lib.sticky_chunk_launch.argtypes = (
        [i] * 8 + [ctypes.c_double] + [i] * 3 + [i, ctypes.c_float]
        + [p] * 8                       # params, x, v, fs, iscal, ring, act, kappa
        + [p] * 6 + [p]                 # event rows (act last), stream
    )
    lib.sticky_chunk_max_dim.restype = l
    lib.sticky_chunk_max_dim.argtypes = [i]
    lib.scalar_chunk_launch.restype = i
    lib.scalar_chunk_launch.argtypes = (
        [i] * 9                         # f64, kind, potential, d, B, K, n_grid, adaptive, signed
        + [ctypes.c_double]             # refresh rate
        + [i] * 3                       # cap, tile, seed
        + [i, ctypes.c_float]           # horizon mode, its float32 target
        + [i] * 2                       # gaussian_velocity, ran_p
        + [ctypes.c_double, i, i, ctypes.c_double, i]  # mix_p, switch, positive, sf, normal
        + [p] * 11 + [p]                # params, state, event rows, stream
    )
    lib.scalar_chunk_max_dim.restype = l
    lib.scalar_chunk_max_dim.argtypes = [i]
    lib.compact_rows_launch.restype = i
    lib.compact_rows_launch.argtypes = [
        p, l, i, i, p, i, i,            # kind, kind row stride, T, B, off, W, n
        p, p, p, p, p, p, p,            # srcs, row/field strides, widths, elem, inits, outs
        p, l,                           # int32 scratch and its length
        p,                              # stream
    ]
    lib.compact_rows_scratch.restype = l
    lib.compact_rows_scratch.argtypes = [i, i, i, p, p]  # T, B, n, widths, elems
    lib.pdmpflux_cuda_error_string.restype = ctypes.c_char_p
    lib.pdmpflux_cuda_error_string.argtypes = [i]


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(SOURCE_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libpdmpflux_kernels_{h.hexdigest()[:16]}.so"
    if not path.exists():
        t0 = time.perf_counter()
        tag = f"{os.getpid()}.tmp"
        objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources]
        try:
            procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()),
                                       "-c", "-o", str(obj), str(src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True)
                     for src, obj in zip(sources, objs)]
            log = [proc.communicate()[0] for proc in procs]  # wait for every compile
            for src, proc, out in zip(sources, procs, log):
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
            tmp = path.with_suffix(f".{tag}.so")
            proc = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", str(tmp),
                                   *map(str, objs)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                                   f"{proc.stdout}\n{proc.stderr}")
            os.replace(tmp, path)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, log="".join(log))
    BUILD_INFO["path"] = str(path)
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = _lib.pdmpflux_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
