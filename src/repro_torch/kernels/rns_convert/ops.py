"""Forward conversion kernel: fused quantize + per-digit modular reduction.

Replaces ``src/repro/kernels/rns_convert/kernel.py:rns_convert_tiles``
(the Pallas TPU kernel, ``pl.pallas_call`` at ``kernel.py:50``).

Bound on an H100: bytes.  Each element reads 4 bytes of x and writes
K residue bytes (4 + 9 for rns9) against one multiply, a round, a clip
and K integer mods, so device memory is the limit: a per-op weight row
[576, 1536] moves 11.5 MB, 3.43 us at 3.35 TB/s; at the decode sizes of
the main path the launch itself costs more (PERF.md).
Design (``csrc/rns_convert.cu``): each thread converts 4 consecutive
elements, with one float4 load where x is 16-byte aligned and T % 4 ==
0; the scale is read per run of ``group`` elements (a scalar, a row or
a token grid is never materialised to x's shape), a scalar once, other
runs found by one 32-bit division and a counter; K is a template
parameter (an instantiation per profile digit count,
:data:`SUPPORTED_K`), each residue an offset multiply-high mod while
qmax <= 65535 (bits <= 17; wider values keep floor-mod's division); one
32-bit store of 4 int8 residues (an int4 of int32 ones) per digit plane,
so a warp's stores to each plane coalesce.  Indices are 32-bit: a call
of more than :data:`MAX_T` elements raises.  Tables travel by value as a
kernel argument (``build.RnsTablesC``).  Threads per block (the tile
``bt``) are a launch parameter, chosen per shape bucket through
``kernels/autotune.py``.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.core.moduli import get_profile
from repro_torch.core.quantize import quantize_with_scale
from repro_torch.core.rns import encode_int32
from repro_torch.kernels import autotune, build
from repro_torch.kernels.rns_normalize.ops import SUPPORTED_K

__all__ = ["rns_convert", "rns_convert_plain", "SOURCE", "launches",
           "MAX_T"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rns_convert.cu"

#: kernel launches made by :func:`rns_convert` (CUDA tensors only)
launches = 0
#: the kernel's 32-bit indices: elements of one call, at most
MAX_T = 2 ** 31 - 2 ** 16 - 1


def _bind(lib):
    lib.rns_convert.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_float, ctypes.POINTER(build.RnsTablesC), ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.rns_convert.restype = ctypes.c_int


def rns_convert_plain(profile, x: torch.Tensor, scale, *, bits: int = 16,
                      out_dtype=torch.int8) -> torch.Tensor:
    """Plain PyTorch version: residues of clip(round(x*scale))."""
    v = quantize_with_scale(x, scale, bits)
    return encode_int32(get_profile(profile), v).to(out_dtype)


def _scale_runs(x_shape: tuple, scale: torch.Tensor):
    """(flat scale, group): the scale is constant over runs of ``group``
    consecutive elements of a contiguous x -- a scalar (one run), or a
    keepdims grid whose dims match x's leading dims and are 1 after."""
    n = len(x_shape)
    T = math.prod(x_shape)
    if scale.numel() == 1:
        return scale.reshape(1), max(T, 1)
    ss = (1,) * (n - scale.ndim) + tuple(scale.shape)
    for k in range(n + 1):
        if ss[:k] == tuple(x_shape[:k]) and all(d == 1 for d in ss[k:]):
            return scale.reshape(-1).contiguous(), math.prod(x_shape[k:])
    return scale.expand(x_shape).contiguous().reshape(-1), 1


def rns_convert(profile, x: torch.Tensor, scale, *, bits: int = 16,
                out_dtype=torch.int8, bt: int | None = None) -> torch.Tensor:
    """x [...] float, scale scalar or broadcastable -> [K, ...] residues.

    ``bt`` (threads per block) resolves through ``autotune.resolve``,
    which gates it with ``check_wrapper_blocks``.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel
    (or raises).
    """
    global launches
    p = get_profile(profile)
    key, blk = autotune.resolve("rns_convert", p, (x.numel(),), x.device,
                                gate=p.n_digits in SUPPORTED_K, bt=bt)
    if not torch.is_tensor(scale):      # a fill, no host copy: graph-safe
        scale = torch.full((), scale, dtype=torch.float32, device=x.device)
    if x.device.type == "cpu":
        return rns_convert_plain(p, x, scale, bits=bits, out_dtype=out_dtype)
    if not x.is_cuda or not scale.is_cuda:
        raise ValueError(f"rns_convert: x on {x.device}, scale on "
                         f"{scale.device}; need both on one CUDA device")
    if out_dtype not in (torch.int8, torch.int32):
        raise ValueError(f"rns_convert: out_dtype {out_dtype}")
    if out_dtype == torch.int8 and not p.int8_safe:
        raise ValueError(f"rns_convert: {p.name} residues exceed int8")
    if p.n_digits not in SUPPORTED_K:
        raise ValueError(f"rns_convert: K={p.n_digits} for {p.name} "
                         f"(kernel digit counts {SUPPORTED_K})")
    if x.numel() > MAX_T:
        raise ValueError(f"rns_convert: {x.numel()} elements > {MAX_T}, "
                         "the kernel's 32-bit indices; split the call")
    shape = tuple(x.shape)
    xf = x.to(torch.float32).contiguous()
    s, group = _scale_runs(shape, scale.to(torch.float32))
    T = xf.numel()
    out = torch.empty((p.n_digits, T), dtype=out_dtype, device=x.device)
    if T:
        lib = build.load("rns_convert", SOURCE, _bind)
        with torch.cuda.device(x.device):
            err = lib.rns_convert(
                xf.data_ptr(), s.data_ptr(), group, T,
                float(2 ** (bits - 1) - 1), ctypes.byref(build.rns_tables_c(p)),
                out.data_ptr(), int(out_dtype == torch.int8), blk["bt"],
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(err, "rns_convert")
        launches += 1
        autotune.last_launch["rns_convert"] = (key, blk)
    return out.reshape((p.n_digits,) + shape)
