"""Build the port's CUDA kernels and bind them through ``ctypes``.

``nvcc`` compiles every ``csrc/*.cu`` of the package (they share
``csrc/pdmp_common.cuh``) for Hopper (``sm_90a``) at first use: one
``nvcc -c`` per source, all started together, then one link into a shared
library with a plain C interface.  The library lands in
``pdmpflux_tpu_torch/_build/`` (git-ignored) under a name that hashes the
sources and flags, so an edited source rebuilds and an unchanged one loads
the library already built.

A gradient of the user's own, lowered into a header by ``ops/cuda/lower.py``,
gets a library of its own (:func:`user_library`): the one chunk source its
kernel runs, compiled with the header at first use and loaded by its own
``ctypes`` handle, under a name that hashes the header, the sources and the
flags.

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
import threading
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

BUILD_INFO: dict = {"user": {}}
"""``seconds``, ``path`` and the compiler's ``log`` of the last build of the
kernel library; under ``user``, each user library's path -> its ``seconds``
(None where it was already built) and ``log``."""

USER_HEADER = "pdmpflux_user_potential.cuh"
"""The name ``csrc/pdmp_common.cuh`` includes under ``PDMPFLUX_USER_POTENTIAL``."""

_lib = None
_user_libs: dict = {}   # key -> loaded user library
_user_locks: dict = {}  # key -> the lock its build holds (builds of two keys run together)
_user_lock = threading.Lock()


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


_SIGNATURES = None


def _signatures() -> dict:
    """Each launcher's ``(restype, argtypes)``."""
    global _SIGNATURES
    if _SIGNATURES is None:
        p, i, l = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        _SIGNATURES = {
            "zigzag_chunk_launch": (i, (
                [i] * 8                         # f64, potential, d, B, K, n_grid, adaptive, signed
                + [ctypes.c_double]             # refresh rate
                + [i] * 3                       # cap, tile, seed
                + [i, ctypes.c_float]           # horizon mode, its float32 target
                + [p] * 12 + [p])),             # params, state, event rows, scratch, stream
            "zigzag_chunk_lanes": (i, [i]),
            "zigzag_chunk_set_lanes": (i, [i]),
            "suzz_chunk_launch": (i, (
                [i] * 8 + [ctypes.c_double] + [i] * 3 + [i, ctypes.c_float]
                + [p] * 6                       # params, x, v, fs, iscal, ring
                + [p] * 5 + [p])),              # event rows, stream
            "sticky_chunk_launch": (i, (
                [i] * 8 + [ctypes.c_double] + [i] * 3 + [i, ctypes.c_float]
                + [p] * 8                       # params, x, v, fs, iscal, ring, act, kappa
                + [p] * 6 + [p])),              # event rows (act last), stream
            "sticky_chunk_max_dim": (l, [i]),
            "scalar_chunk_launch": (i, (
                [i] * 9                         # f64, kind, potential, d, B, K, n_grid, adaptive, signed
                + [ctypes.c_double]             # refresh rate
                + [i] * 3                       # cap, tile, seed
                + [i, ctypes.c_float]           # horizon mode, its float32 target
                + [i] * 2                       # gaussian_velocity, ran_p
                + [ctypes.c_double, i, i, ctypes.c_double, i]  # mix_p, switch, positive, sf, normal
                + [p] * 11 + [p])),             # params, state, event rows, stream
            "scalar_chunk_max_dim": (l, [i]),
            "compact_rows_launch": (i, [
                p, l, i, i, p, i, i,            # kind, kind row stride, T, B, off, W, n
                p, p, p, p, p, p, p,            # srcs, row/field strides, widths, elem, inits, outs
                p, l,                           # int32 scratch and its length
                p]),                            # stream
            "compact_rows_scratch": (l, [i, i, i, p, p]),  # T, B, n, widths, elems
            "pdmpflux_cuda_error_string": (ctypes.c_char_p, [i]),
        }
    return _SIGNATURES


def _declare(lib) -> None:
    """Bind the signatures of the launchers ``lib`` exports (a user library
    exports its one source's)."""
    for name, (res, args) in _signatures().items():
        try:
            fn = getattr(lib, name)
        except AttributeError:
            continue
        fn.restype, fn.argtypes = res, args


def _compile(sources, flags, path: Path, extra=()) -> str:
    """``nvcc -c`` each source (all started together) with ``flags`` plus its
    ``SOURCE_FLAGS``, then one link into ``path``; returns the log.  A failed
    step raises with its log."""
    tag = f"{os.getpid()}.{threading.get_ident()}.tmp"
    objs = [path.parent / f"{src.stem}.{tag}.o" for src in sources]
    try:
        procs = [subprocess.Popen([_nvcc(), *flags, *SOURCE_FLAGS.get(src.name, ()), *extra,
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
        proc = subprocess.run([_nvcc(), *flags[:2], "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(log)


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
        log = _compile(sources, NVCC_FLAGS, path)
        BUILD_INFO.update(seconds=time.perf_counter() - t0, log=log)
    BUILD_INFO["path"] = str(path)
    lib = ctypes.CDLL(str(path))
    _declare(lib)
    _lib = lib
    return lib


def user_library(source: str, header: str):
    """The library of one chunk ``source`` (``"zigzag_chunk.cu"``, ...) built
    with a generated potential: ``header`` is written into its own directory
    of ``_build/`` as :data:`USER_HEADER`, and the source compiled with
    ``-DPDMPFLUX_USER_POTENTIAL``, that directory on the include path and the
    source's ``SOURCE_FLAGS``; the name hashes the header, the sources and the
    flags.  Built at first use of each gradient (a failed ``nvcc`` raises
    with its log), loaded by its own ``ctypes`` handle; its launches take
    potential id 7 alone, in the header's dtype alone (``UserScalar``: the
    kernels are instantiated for it only)."""
    src = CSRC / source
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode() + repr(SOURCE_FLAGS).encode())
    h.update(header.encode())
    for f in (src, CSRC / "pdmp_common.cuh"):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    key = f"{src.stem}_{h.hexdigest()[:16]}"
    with _user_lock:
        lock = _user_locks.setdefault(key, threading.Lock())
    with lock:
        if key in _user_libs:
            return _user_libs[key]
        folder = BUILD_DIR / f"user_{key}"
        folder.mkdir(parents=True, exist_ok=True)
        path = folder / f"libpdmpflux_user_{key}.so"
        seconds, log = None, ""
        if not path.exists():
            (folder / USER_HEADER).write_text(header)
            t0 = time.perf_counter()
            log = _compile([src], NVCC_FLAGS, path,
                           ["-DPDMPFLUX_USER_POTENTIAL", "-I", str(folder)])
            seconds = time.perf_counter() - t0
        BUILD_INFO["user"][str(path)] = {"seconds": seconds, "log": log}
        lib = ctypes.CDLL(str(path))
        _declare(lib)
        _user_libs[key] = lib
        return lib


def check(err: int, name: str, lib=None) -> None:
    """Raise if a launcher of ``lib`` (the kernels' own library by default)
    returned a CUDA error."""
    if err != 0:
        msg = (library() if lib is None else lib).pdmpflux_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
