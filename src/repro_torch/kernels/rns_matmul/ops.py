"""Digit-sliced modular matmul kernel (the RNS matrix unit).

Replaces ``src/repro/kernels/rns_matmul/kernel.py:rns_matmul_tiles``
(the Pallas TPU kernel, ``pl.pallas_call`` at ``kernel.py:64``).

Bound on an H100 SXM at 700 W (data-sheet 3.35 TB/s, 1979 int8 TOP/s):
bytes at the main path's shapes.  A decode projection
[9, 8, 576] @ [9, 576, 1536] moves 8 MB of int8 weight residues for
2 * 9 * 8 * 576 * 1536 = 127 M int8 operations: ~2.4 us of memory
traffic against ~0.06 us of int8 tensor-core time.  Prefill rows add
operations but stay below the ~590 op/byte int8 ridge.  Design (a
simple first kernel): one block per (64 columns, 32 rows, digit) with
the digit on ``blockIdx.z``, 32-deep tiles of a and b staged in shared
memory, 8 int32 accumulators per thread in registers, and a modular
reduction every ``lazy_chunk - 1`` terms as ``modular_matmul`` keeps
it.  It uses CUDA cores, not the int8 tensor cores (``wgmma`` and TMA
are later work), and reads b once per 32-row tile of a.  The row and
column tile is chosen per shape bucket through ``kernels/autotune.py``
among the compiled tiles (template instantiations, ``MATMUL_TILES``).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.core.moduli import get_profile
from repro_torch.core.rns_matmul import rns_matmul_res
from repro_torch.kernels import autotune, build

__all__ = ["rns_matmul", "rns_matmul_plain", "SOURCE", "launches"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rns_matmul.cu"

#: kernel launches made by :func:`rns_matmul` (CUDA tensors only)
launches = 0


def _bind(lib):
    lib.rns_matmul.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(build.RnsTablesC), ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rns_matmul.restype = ctypes.c_int


def rns_matmul_plain(profile, a_res: torch.Tensor,
                     b_res: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, on the operands' own device:
    ``core/rns_matmul.rns_matmul_res``, a float64 bmm of the residues per
    ``lazy_chunk`` terms, then a remainder in int64.  Exact because every
    partial sum is an integer below lazy_chunk * (m-1)**2 < 2**31, far
    inside float64's 2**53 (CUDA PyTorch has no integer bmm)."""
    return rns_matmul_res(profile, a_res, b_res)


def rns_matmul(profile, a_res: torch.Tensor, b_res: torch.Tensor, *,
               bm: int | None = None,
               bn: int | None = None) -> torch.Tensor:
    """a_res [K, ..., M, D], b_res [K, D, N] residues -> [K, ..., M, N] int32.

    The (bm, bn) output tile resolves through ``autotune.resolve``, which
    gates it with ``check_wrapper_blocks`` (an illegal tile raises
    ``ValueError``).  A CPU tensor takes the plain version; a CUDA
    tensor launches the kernel (or raises).
    """
    global launches
    p = get_profile(profile)
    K, D, N = b_res.shape
    M = math.prod(a_res.shape[1:-1])
    key, blk = autotune.resolve("rns_matmul", p, (M, D, N), a_res.device,
                                bm=bm, bn=bn)
    if a_res.device.type == "cpu" and b_res.device.type == "cpu":
        return rns_matmul_plain(p, a_res, b_res)
    if not (a_res.is_cuda and b_res.device == a_res.device):
        raise ValueError(f"rns_matmul: operands on {a_res.device} and "
                         f"{b_res.device}; need one CUDA device")
    if a_res.shape[0] != K or a_res.shape[-1] != D or K != p.n_digits:
        raise ValueError(f"rns_matmul: shapes {tuple(a_res.shape)} @ "
                         f"{tuple(b_res.shape)} for {p.name}")
    if a_res.dtype != b_res.dtype or a_res.dtype not in (torch.int8,
                                                         torch.int32):
        raise ValueError(f"rns_matmul: dtypes {a_res.dtype}, {b_res.dtype}")
    a2 = a_res.reshape(K, -1, D).contiguous()
    b2 = b_res.contiguous()
    out = torch.empty((K, M, N), dtype=torch.int32, device=a_res.device)
    if M and N:
        lib = build.load("rns_matmul", SOURCE, _bind)
        with torch.cuda.device(a_res.device):
            err = lib.rns_matmul(
                a2.data_ptr(), b2.data_ptr(), K, M, N, D, p.lazy_chunk - 1,
                ctypes.byref(build.rns_tables_c(p)), out.data_ptr(),
                int(a_res.dtype == torch.int8), blk["bm"], blk["bn"],
                torch.cuda.current_stream(a_res.device).cuda_stream)
        build.check(err, "rns_matmul")
        launches += 1
        autotune.last_launch["rns_matmul"] = (key, blk)
    return out.reshape(tuple(a_res.shape[:-1]) + (N,))
