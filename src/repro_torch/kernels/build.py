"""Build and bind the hand-written CUDA kernels (nvcc + ctypes).

Each kernel package is one ``.cu`` file with plain C entry points.  It is
compiled for Hopper (``sm_90a``) at first use into ``build/`` at the root
of the checkout, named by a hash of its sources and flags, and loaded
with ``ctypes``.  Nothing here runs at import time: the CPU tests import
every module on a machine with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from repro_torch.core.rns import tables

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "RNS_MAX_K", "RnsTablesC",
           "rns_tables_c", "library_path", "load", "build_all", "check"]

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build"
INCLUDE_DIR = KERNELS_DIR / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

RNS_MAX_K = 21      # widest profile (rns21); matches csrc/rns_tables.cuh


class RnsTablesC(ctypes.Structure):
    """Mirror of ``struct RnsTables`` (csrc/rns_tables.cuh), passed to the
    kernels by value: moduli, MRC digits of M//2, float32 weights W_j and
    the MRC inverses, row stride ``RNS_MAX_K``."""

    _fields_ = [("K", ctypes.c_int),
                ("moduli", ctypes.c_int * RNS_MAX_K),
                ("half", ctypes.c_int * RNS_MAX_K),
                ("w", ctypes.c_float * RNS_MAX_K),
                ("inv", ctypes.c_int * (RNS_MAX_K * RNS_MAX_K))]


@functools.lru_cache(maxsize=None)
def rns_tables_c(profile) -> RnsTablesC:
    """The profile's tables laid out as ``RnsTablesC``.  The float32
    weights are copied as float32 bits (``Tables.W_f32``), never cast
    through ``ctypes.c_float``."""
    t = tables(profile)
    K = t.profile.n_digits
    if K > RNS_MAX_K:
        raise ValueError(f"profile {t.profile.name}: K={K} > {RNS_MAX_K}")
    buf = np.zeros(1 + 3 * RNS_MAX_K + RNS_MAX_K * RNS_MAX_K, np.int32)
    buf[0] = K
    buf[1:1 + K] = t.moduli
    buf[1 + RNS_MAX_K:1 + RNS_MAX_K + K] = t.half_digits
    o = 1 + 2 * RNS_MAX_K
    buf[o:o + K] = t.W_f32.view(np.int32)
    inv = np.zeros((RNS_MAX_K, RNS_MAX_K), np.int32)
    inv[:K, :K] = t.mrc_inv
    buf[1 + 3 * RNS_MAX_K:] = inv.reshape(-1)
    return RnsTablesC.from_buffer_copy(buf.tobytes())


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    if (cuda / "bin" / "nvcc").exists():
        return str(cuda / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def library_path(name: str, source: Path) -> Path:
    """Where the library built from ``source`` lives (named by a hash of
    its sources and flags)."""
    h = hashlib.sha1()
    for f in [source, *sorted(INCLUDE_DIR.glob("*.cuh"))]:
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, source: Path):
    """Start nvcc for one source unless its library is built; returns
    (target, tmp, process) or (target, None, None)."""
    target = library_path(name, source)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{INCLUDE_DIR}", "-o", tmp, str(source)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, target: Path, tmp, proc) -> str:
    """Wait for one build; keep its compiler log beside the library."""
    log = target.with_suffix(".log")
    if proc is None:
        return log.read_text() if log.exists() else ""
    out, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}:\n{out}")
    log.write_text(out)
    os.replace(tmp, target)         # atomic: a concurrent build is harmless
    return out


def build_all(sources: dict[str, Path]) -> dict[str, str]:
    """Build every ``{name: source}`` at once (one nvcc each, all started
    together); returns each build's compiler log (``ptxas -v``)."""
    started = {n: _start(n, s) for n, s in sources.items()}
    return {n: _finish(n, *started[n]) for n in sources}


_LIBS: dict[str, ctypes.CDLL] = {}


def load(name: str, source: Path, bind) -> ctypes.CDLL:
    """The kernel library, built at first use; ``bind(lib)`` declares
    argtypes/restype once."""
    lib = _LIBS.get(name)
    if lib is None:
        target, tmp, proc = _start(name, source)
        _finish(name, target, tmp, proc)
        lib = ctypes.CDLL(str(target))
        bind(lib)
        _LIBS[name] = lib
    return lib


def check(err: int, name: str):
    """Raise on a non-zero ``cudaError_t`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
