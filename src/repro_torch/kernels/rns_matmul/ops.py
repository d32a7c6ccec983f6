"""Digit-sliced modular matmul kernel (the RNS matrix unit).

Replaces ``src/repro/kernels/rns_matmul/kernel.py:rns_matmul_tiles``
(the Pallas TPU kernel, ``pl.pallas_call`` at ``kernel.py:64``).

Bound on an H100 SXM at 700 W (data-sheet 3.35 TB/s, 1979 int8 TOP/s):
bytes at the main path's shapes.  A decode projection
[9, 8, 576] @ [9, 576, 1536] moves 8 MB of int8 weight residues for
2 * 9 * 8 * 576 * 1536 = 127 M int8 operations: ~2.4 us of memory
traffic against ~0.06 us of int8 tensor-core time.  Prefill rows add
operations but stay below the ~590 op/byte int8 ridge.

Design (``csrc/rns_matmul.cu``): the products run on the integer tensor
cores (``mma.sync.m16n8k32`` on unsigned bytes: every residue of every
profile is below 256, int32 residues are narrowed to a byte while
staged), with int32 accumulators in registers reduced mod m every
``lazy_chunk - 1`` terms as ``modular_matmul`` keeps it.  A block owns
a (bm, bn) tile of one digit; 128-deep K steps of a and b come through
a 3-stage ring of 16-byte ``cp.async`` copies, and b's N-contiguous
bytes are turned into the MMA's K-contiguous column operand by 4 x 4
byte transposes (``__byte_perm``).  When the tiles would not fill the
SMs (decode: 8 rows), :func:`splits_for` shares each tile's K steps
among several blocks in the same launch; each stores its partial
residues in its slice of an int32 workspace, and the last block of a
tile (an atomic counter) adds the slices and applies the mod, so a call
is one launch, deterministic, and safe to capture in a CUDA graph: the
workspace comes from ``kernels/workspace.py``, per device and stream,
and no buffer a launch was handed is ever freed.  The
(bm, bn) tile is chosen per shape bucket through ``kernels/autotune.py``
among the compiled tiles (template instantiations, ``MATMUL_TILES``).

The fused encode + matmul's one-digit design candidate
(``scripts/variants/rns_encode_one_digit.cu``, timed by
``scripts/kernel_variants.py``) is this kernel with x quantized in the
block; :func:`split_args` sizes its splits too.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.core.moduli import get_profile
from repro_torch.core.rns_matmul import rns_matmul_res
from repro_torch.kernels import autotune, build, workspace

__all__ = ["rns_matmul", "rns_matmul_plain", "splits_for", "split_args",
           "SOURCE", "launches", "BK"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rns_matmul.cu"

#: kernel launches made by :func:`rns_matmul` (CUDA tensors only)
launches = 0
BK = 128                # csrc/rns_matmul.cu: the K step


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.rns_matmul.argtypes = [p, p, i, i, i, i, i,
                               ctypes.POINTER(build.RnsTablesC), p, i, i, i,
                               i, p, p, p]
    lib.rns_matmul.restype = ctypes.c_int


def rns_matmul_plain(profile, a_res: torch.Tensor,
                     b_res: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, on the operands' own device:
    ``core/rns_matmul.rns_matmul_res``, a float64 bmm of the residues per
    ``lazy_chunk`` terms, then a remainder in int64.  Exact because every
    partial sum is an integer below lazy_chunk * (m-1)**2 < 2**31, far
    inside float64's 2**53 (CUDA PyTorch has no integer bmm)."""
    return rns_matmul_res(profile, a_res, b_res)


def splits_for(S: int, M: int, D: int, N: int, bm: int, bn: int,
               sms: int) -> int:
    """Blocks that share each output tile's K steps (one launch): 1 when
    the S x row x column tiles alone fill the card's ``sms`` SMs, else
    enough for about two blocks per SM, at most 4 and each with at
    least two K steps.  Each split adds a workspace round trip of the
    tile's partial residues, which costs more than it gains once the
    tiles fill the card (PERF.md; `scripts/kernel_variants.py`)."""
    tiles = S * -(-M // bm) * -(-N // bn)
    ksteps = -(-D // BK)
    if tiles >= sms or ksteps < 4:
        return 1
    want = min(4, ksteps // 2, -(-2 * sms // tiles))
    per = -(-ksteps // want)
    return -(-ksteps // per)        # as the launch recounts it


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def split_args(K: int, M: int, D: int, N: int, bm: int, bn: int,
               device) -> tuple[int, int, int]:
    """(splits, workspace pointer, counters pointer) of one launch of
    ``csrc/rns_matmul.cu``: :func:`splits_for` on the card's SMs, the
    workspace of ``kernels/workspace.py`` when it splits."""
    splits = splits_for(K, M, D, N, bm, bn, _sms(device.index))
    if splits == 1:
        return 1, 0, 0
    ws, cnt = workspace.get(device, splits * K * M * N,
                            K * -(-M // bm) * -(-N // bn))
    return splits, ws.data_ptr(), cnt.data_ptr()


def rns_matmul(profile, a_res: torch.Tensor, b_res: torch.Tensor, *,
               bm: int | None = None,
               bn: int | None = None) -> torch.Tensor:
    """a_res [K, ..., M, D], b_res [K, D, N] residues -> [K, ..., M, N] int32.

    One launch per call; the blocks of a tile split its K steps when the
    tiles alone would leave SMs idle (:func:`splits_for`), combining
    through the workspace of the device and stream
    (``kernels/workspace.py``).  The (bm, bn) output tile resolves through
    ``autotune.resolve``, which gates it with ``check_wrapper_blocks``
    (an illegal tile raises ``ValueError``).  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (or raises).
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
        dev = a_res.device
        split = split_args(K, M, D, N, blk["bm"], blk["bn"], dev)
        with torch.cuda.device(dev):
            err = lib.rns_matmul(
                a2.data_ptr(), b2.data_ptr(), K, M, N, D, p.lazy_chunk - 1,
                ctypes.byref(build.rns_tables_c(p)), out.data_ptr(),
                int(a_res.dtype == torch.int8), blk["bm"], blk["bn"],
                *split, torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "rns_matmul")
        launches += 1
        autotune.last_launch["rns_matmul"] = (key, blk)
    return out.reshape(tuple(a_res.shape[:-1]) + (N,))
