"""Build and bind the hand-written CUDA kernels (nvcc + ctypes).

Each kernel package is one ``.cu`` file with plain C entry points.  It is
compiled for Hopper (``sm_90a``), in shares where ``PARTS`` says so, at
first use into ``build/`` at the root of the checkout, named by a hash
of its sources and flags, and loaded with ``ctypes``.  Nothing here runs at import time: the CPU tests import
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

from repro_torch.core.rns import f32_weights, tables

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "PARTS", "RNS_MAX_K", "RNS_PAIRS", "rns_pair",
           "RnsTablesC", "rns_tables_c", "mulhi_magic", "mulhi_offset",
           "mulhi_mod", "mrc_c", "mrc_offset",
           "library_path", "load", "build_all", "check"]

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build"
INCLUDE_DIR = KERNELS_DIR / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Sources whose entry points compile in that many disjoint shares
# (``-DBUILD_PART=p``), one nvcc each, all at once, then one link: the
# longest compile, split.  Without the macro a source compiles whole.
PARTS = {"rns_fused_mma": 4}

RNS_MAX_K = 21      # widest profile (rns21); matches csrc/rns_tables.cuh
RNS_PAIRS = RNS_MAX_K * (RNS_MAX_K - 1) // 2


def rns_pair(i: int, j: int) -> int:
    """Index of the MRC pair i < j in the packed ``mrc_c`` table
    (``RNS_PAIR`` of csrc/rns_tables.cuh)."""
    return i * (2 * RNS_MAX_K - i - 1) // 2 + j - i - 1


class RnsTablesC(ctypes.Structure):
    """Mirror of ``struct RnsTables`` (csrc/rns_tables.cuh), passed to the
    kernels by value: moduli, MRC digits of M//2, float32 weights W_j,
    each modulus's :func:`mulhi_magic` and :func:`mulhi_offset`, the MRC
    terms' :func:`mrc_c` (which hold the inverses m_i^-1 mod m_j; pairs
    i < j at :func:`rns_pair`) and :func:`mrc_offset`."""

    _fields_ = [("K", ctypes.c_int),
                ("moduli", ctypes.c_int * RNS_MAX_K),
                ("half", ctypes.c_int * RNS_MAX_K),
                ("w", ctypes.c_float * RNS_MAX_K),
                ("magic", ctypes.c_uint * RNS_MAX_K),
                ("moff", ctypes.c_int * RNS_MAX_K),
                ("mrc_c", ctypes.c_uint * RNS_PAIRS),
                ("roff", ctypes.c_int * RNS_MAX_K)]


def mulhi_magic(m: int) -> int:
    """``floor((2**32 - 1) / m)``: the multiply-high constant of
    ``mulhi_mod`` (csrc/rns_tables.cuh)."""
    return (2 ** 32 - 1) // m


def mulhi_offset(m: int) -> int:
    """``m * ceil(2**16 / m)``: a multiple of m that makes a quantized
    value (|v| <= 65535) non-negative for ``mulhi_mod``
    (``quant_residue``)."""
    return m * -(-2 ** 16 // m)


def mulhi_mod(x, m: int):
    """``x mod m`` for integers 0 <= x < 2**31 (an int or an int64 tensor)
    as ``mulhi_mod`` computes it on the card: the high word of
    ``x * mulhi_magic(m)``, then one correction."""
    r = x - ((x * mulhi_magic(m)) >> 32) * m
    return r - m * (r >= m)


def mrc_c(m: int, inv: int) -> int:
    """``ceil(2**32 / m) * inv mod 2**32``: the multiply-low constant of
    the MRC term ``(r_j - r_i) * inv mod m`` (``mrc_term``,
    csrc/rns_mrc.cuh)."""
    return -(-2 ** 32 // m) * inv % 2 ** 32


def mrc_offset(m: int) -> int:
    """``m * ceil(256 / m)``: a multiple of m that makes ``r_j - r_i``
    non-negative for residues below 256."""
    return m * -(-256 // m)


@functools.lru_cache(maxsize=256)
def rns_tables_c(profile, inv_scale: float = 1.0) -> RnsTablesC:
    """The profile's tables laid out as ``RnsTablesC``.  The float32
    weights are copied as float32 bits, never cast through
    ``ctypes.c_float``: ``Tables.W_f32``, or with ``inv_scale`` the
    weights W_j * inv_scale taken in float64 and rounded once to float32
    (``f32_weights``, the weights of ``mrc.decode_float(inv_scale=)``;
    inf, subnormal or 0 past float32's range).  Only ``w`` depends on
    the scale; the kernels read it nowhere else."""
    t = tables(profile)
    K = t.profile.n_digits
    if K > RNS_MAX_K:
        raise ValueError(f"profile {t.profile.name}: K={K} > {RNS_MAX_K}")
    buf = np.zeros(1 + 6 * RNS_MAX_K + RNS_PAIRS, np.int32)
    buf[0] = K
    buf[1:1 + K] = t.moduli
    buf[1 + RNS_MAX_K:1 + RNS_MAX_K + K] = t.half_digits
    o = 1 + 2 * RNS_MAX_K
    w = t.W_f32 if inv_scale == 1.0 else f32_weights(t.W_f64 * inv_scale)
    buf[o:o + K] = w.view(np.int32)
    o += RNS_MAX_K
    ms = [int(m) for m in t.moduli]
    buf[o:o + K] = np.array([mulhi_magic(m) for m in ms],
                            np.uint32).view(np.int32)
    buf[o + RNS_MAX_K:o + RNS_MAX_K + K] = [mulhi_offset(m) for m in ms]
    o += 2 * RNS_MAX_K
    c = np.zeros(RNS_PAIRS, np.uint32)
    for i in range(K):
        for j in range(i + 1, K):
            c[rns_pair(i, j)] = mrc_c(ms[j], int(t.mrc_inv[i][j]))
    buf[o:o + RNS_PAIRS] = c.view(np.int32)
    o += RNS_PAIRS
    buf[o:o + K] = [mrc_offset(m) for m in ms]
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
    """Start nvcc for one source (one process a share of ``PARTS``)
    unless its library is built; returns (target, tmp, processes) or
    (target, None, [])."""
    target = library_path(name, source)
    if target.exists():
        return target, None, []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, f"-I{INCLUDE_DIR}"]
    parts = PARTS.get(source.stem, 1)
    if parts == 1:
        cmds = [[*cmd, "-o", tmp, str(source)]]
    else:
        cmd = [f for f in cmd if f != "-shared"]
        cmds = [[*cmd, "-c", f"-DBUILD_PART={p}", "-o", f"{tmp}.{p}.o",
                 str(source)] for p in range(parts)]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    return target, tmp, procs


def _finish(name: str, target: Path, tmp, procs) -> str:
    """Wait for one build (and link its shares); keep its compiler log
    beside the library."""
    log = target.with_suffix(".log")
    if not procs:
        return log.read_text() if log.exists() else ""
    outs = [proc.communicate()[0] for proc in procs]
    objs = [f"{tmp}.{p}.o" for p in range(len(procs))] if len(procs) > 1 \
        else []
    try:
        for proc, out in zip(procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        if objs:
            link = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *objs],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc failed to link {name}:\n"
                                   f"{link.stdout}{link.stderr}")
    except RuntimeError:
        os.unlink(tmp)
        raise
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
    out = "".join(outs)
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
        target, tmp, procs = _start(name, source)
        _finish(name, target, tmp, procs)
        lib = ctypes.CDLL(str(target))
        bind(lib)
        _LIBS[name] = lib
    return lib


def check(err: int, name: str):
    """Raise on a non-zero ``cudaError_t`` from a launch."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
