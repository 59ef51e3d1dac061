"""Build the port's CUDA kernels and bind them through ``ctypes``.

``nvcc`` compiles every ``csrc/*.cu`` of the package into one shared library
with a plain C interface, for Hopper (``sm_90a``), at first use.  The library
lands in ``pdmpflux_tpu_torch/_build/`` (git-ignored) under a name that hashes
the sources and flags, so an edited source rebuilds and an unchanged one
loads the library already built.

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
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v"]

LAUNCHES = {"zigzag_chunk": 0, "compact_rows": 0}
"""Kernel launches since the last :func:`reset_launches`."""

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
        + [p] * 10 + [p]                # state, event rows, stream
    )
    lib.compact_rows_launch.restype = i
    lib.compact_rows_launch.argtypes = [
        p, l, i, i, p, i, i,            # kind, kind row stride, T, B, off, W, n
        p, p, p, p, p, p, p,            # srcs, row/field strides, widths, elem, inits, outs
        p,                              # stream
    ]
    lib.pdmpflux_cuda_error_string.restype = ctypes.c_char_p
    lib.pdmpflux_cuda_error_string.argtypes = [i]


def library():
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = BUILD_DIR / f"libpdmpflux_kernels_{h.hexdigest()[:16]}.so"
    if not path.exists():
        tmp = path.with_suffix(f".{os.getpid()}.tmp.so")
        t0 = time.perf_counter()
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
        BUILD_INFO.update(seconds=time.perf_counter() - t0,
                          log=proc.stdout + proc.stderr)
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
