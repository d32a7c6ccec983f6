"""MRC normalization kernel: residues -> signed float32 values.

Replaces ``src/repro/kernels/rns_normalize/kernel.py:rns_normalize_tiles``
(the Pallas TPU kernel, ``pl.pallas_call`` at ``kernel.py:97``).

Bound on an H100: bytes.  Each element reads K int32 residues and
writes one float32 (40 bytes for rns9) against two K-step MRC passes
(~K**2 integer ops) and 2K float32 ops.  Design: one thread per
element, all K digits in registers (K is a template parameter so the
digit loops unroll), the float sum written with ``__fmul_rn`` /
``__fadd_rn`` so that nvcc cannot contract it into FMAs: this is what
holds the kernel bit for bit to ``core/mrc.decode_float`` (ROADMAP
C.1).  Wide profiles whose W_j overflow float32 (rns21) get the same
inf/NaN the float32 reference gives.  Tables travel by value as a
kernel argument (``build.RnsTablesC``), so any number of profiles can
be in use at once.  Threads per block (the tile ``bt``) are a launch
parameter, chosen per shape bucket through ``kernels/autotune.py``;
registers cap them for the wide profiles (rns21's 255 registers a
thread allow 256 threads a block).
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.core import mrc
from repro_torch.core.moduli import get_profile
from repro_torch.kernels import autotune, build

__all__ = ["rns_normalize", "rns_normalize_plain", "SOURCE", "launches"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rns_normalize.cu"
SUPPORTED_K = (5, 6, 7, 8, 9, 12, 16, 18, 21)   # csrc/rns_normalize.cu

#: kernel launches made by :func:`rns_normalize` (CUDA tensors only)
launches = 0


def _bind(lib):
    lib.rns_normalize.argtypes = [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.POINTER(build.RnsTablesC),
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    lib.rns_normalize.restype = ctypes.c_int


def rns_normalize_plain(profile, res: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``core/mrc.decode_float`` unscaled (MRC,
    sign, magnitude MRC, float32 digit-ascending sum, one rounding per
    op)."""
    return mrc.decode_float(profile, res)


def rns_normalize(profile, res: torch.Tensor, *,
                  bt: int | None = None) -> torch.Tensor:
    """res [K, ...] int residues -> [...] float32 signed values (unscaled).

    ``bt`` (threads per block) resolves through ``autotune.resolve``,
    which gates it with ``check_wrapper_blocks`` (for the digit counts
    the kernel has).  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises).
    """
    global launches
    p = get_profile(profile)
    key, blk = autotune.resolve("rns_normalize", p,
                                (res[0].numel() if res.ndim else 0,),
                                res.device, gate=p.n_digits in SUPPORTED_K,
                                bt=bt)
    if res.device.type == "cpu":
        return rns_normalize_plain(p, res)
    if not res.is_cuda:
        raise ValueError(f"rns_normalize: residues on {res.device}")
    K = p.n_digits
    if res.shape[0] != K or K not in SUPPORTED_K:
        raise ValueError(f"rns_normalize: shape {tuple(res.shape)} for "
                         f"{p.name} (kernel digit counts {SUPPORTED_K})")
    shape = tuple(res.shape[1:])
    flat = res.reshape(K, -1).to(torch.int32).contiguous()
    T = flat.shape[1]
    out = torch.empty((T,), dtype=torch.float32, device=res.device)
    if T:
        lib = build.load("rns_normalize", SOURCE, _bind)
        with torch.cuda.device(res.device):
            err = lib.rns_normalize(
                flat.data_ptr(), T, ctypes.byref(build.rns_tables_c(p)),
                out.data_ptr(), blk["bt"],
                torch.cuda.current_stream(res.device).cuda_stream)
        build.check(err, "rns_normalize")
        launches += 1
        autotune.last_launch["rns_normalize"] = (key, blk)
    return out.reshape(shape)
