"""Fused residue-datapath kernels: one projection's convert -> digit
matmul -> MRC normalize chain, or the first or last two of its stages,
in one kernel.

Replaces the Pallas TPU kernels of ``src/repro/kernels/rns_fused/kernel.py``:
``rns_fused_encode_matmul_tiles`` (``pl.pallas_call`` at ``kernel.py:96``),
``rns_fused_matmul_normalize_tiles`` (``:151``) and ``rns_fused_dot_tiles``
(``:205``).

Bound on an H100 SXM at 700 W (data-sheet 3.35 TB/s, 1979 int8 TOP/s):
bytes at the main path's shapes.  A decode ``rns_fused_dot``
[8, 576] @ [9, 576, 1536] reads 8.0 MB of int8 weight residues for
2 * 9 * 8 * 576 * 1536 = 127 M int8 operations: ~2.4 us of memory traffic
against ~0.06 us of int8 tensor-core time; ``rns_fused_matmul_normalize``
adds the 442 KB of int32 ``a_res`` [9, 8, 1536], and
``rns_fused_encode_matmul`` writes [9, 8, 1536] int32 residues instead
of [8, 1536] floats.  Prefill (144 rows) stays below the ~590 op/byte
int8 ridge.

The dot (B.4) and the matmul + normalize (B.6), ``csrc/rns_fused_mma.cu``:
products on the integer tensor cores (``mma.sync.m16n8k32`` with u8 b,
the building blocks of ``csrc/rns_mma.cuh`` that rns_matmul uses), a
block holding one (bm, bn) output tile for all K digits (bn / 32 warps a
digit), K steps of b and a through a ``cp.async`` ring (int32 a narrowed
to bytes as the MMA fragments are read), and the dot's x tile quantized
once a step (``csrc/rns_quantize.cuh``, the rule of ``rns_convert``):
at bits <= 8 the quantized values are every digit's a operand as signed
bytes (s8 x u8 products, congruent to the residues' mod m), else the
block reduces them to each digit's residues on chip.  When the
tiles leave SMs idle (decode), :func:`splits_for` shares each tile's K
steps among several blocks of the one launch, combining their residues
through the per-stream workspace of ``kernels/workspace.py`` (the last
block of a tile, elected by an atomic counter, adds the slices).  The
epilogue parks the tile's residues in shared memory and every thread of
the block runs the MRC of ``csrc/rns_mrc.cuh`` on its elements (one
pass of exact multiply-high mods): the bits of ``rns_normalize``.

The encode + matmul (B.5) runs the same kernel body
(``rns_encode_residues_kernel``): the dot's x tile quantized once a step
into one s8 operand for every digit, and, in place of the MRC, each
warp's residues stored from its registers ([K, M, N] int32, 16-byte
stores); its splits follow the dot's.  Its other layout, one digit's
tile a block (rns_matmul's, with the block's x rows quantized once),
measured slower in both main-path rows; it is the design candidate
``scripts/variants/rns_encode_one_digit.cu`` of
``scripts/kernel_variants.py`` (PERF.md).

The scale travels as one float per run of ``group`` activation rows (a
scalar, per-row or per-token grid, never expanded to x's shape).  The
output scale ``inv_scale`` of the dot and the matmul + normalize (a
fractional residue tensor's ``M_f**-frac_exp``) travels inside the
epilogue's weight table (``build.rns_tables_c(p, inv_scale)``), as
``rns_normalize`` takes it.  Output
tiles are chosen per shape bucket through ``kernels/autotune.py`` among
the compiled tiles (template instantiations, ``FUSED_MMA_TILES``).

On a CPU tensor each wrapper takes its plain version: the composition of
the port's plain stages, as ``repro/kernels/rns_fused/ref.py`` composes
the JAX ones.
"""

from __future__ import annotations

import ctypes
import functools
import math
from pathlib import Path

import torch

from repro_torch.core.moduli import get_profile
from repro_torch.analysis.kernel_audit import fused_ring
from repro_torch.kernels import autotune, build, workspace
from repro_torch.kernels.rns_convert.ops import _scale_runs, rns_convert_plain
from repro_torch.kernels.rns_matmul.ops import rns_matmul_plain
from repro_torch.kernels.rns_normalize.ops import (SUPPORTED_K,
                                                   rns_normalize_plain)

__all__ = ["rns_fused_encode_matmul", "rns_fused_matmul_normalize",
           "rns_fused_dot", "rns_fused_encode_matmul_plain",
           "rns_fused_matmul_normalize_plain", "rns_fused_dot_plain",
           "splits_for", "MIN_STEPS", "SOURCE", "launches"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "rns_fused_mma.cu"

#: kernel launches made by each wrapper (CUDA tensors only)
launches = {"rns_fused_encode_matmul": 0, "rns_fused_matmul_normalize": 0,
            "rns_fused_dot": 0}


def _bind(lib):
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_float
    tab = ctypes.POINTER(build.RnsTablesC)
    lib.rns_fused_dot.argtypes = [p, p, ll, f, p, i, i, i, i, i, tab, p, i,
                                  i, i, p, p, p]
    lib.rns_fused_encode_matmul.argtypes = lib.rns_fused_dot.argtypes
    lib.rns_fused_encode_matmul.restype = ctypes.c_int
    lib.rns_fused_matmul_normalize.argtypes = [p, i, p, i, i, i, i, i, tab,
                                               p, i, i, i, p, p, p]
    lib.rns_fused_dot.restype = ctypes.c_int
    lib.rns_fused_matmul_normalize.restype = ctypes.c_int


#: K steps a split takes at least, by kernel: the encode + matmul's last
#: block only adds slices and stores them (no MRC), and its decode tile
#: of 16 x 64 ran fastest split 5 ways, one K step more or less each
#: (PERF.md)
MIN_STEPS = {"rns_fused_dot": 2, "rns_fused_matmul_normalize": 2,
             "rns_fused_encode_matmul": 1}


def splits_for(M: int, D: int, N: int, bm: int, bn: int, bk: int,
               sms: int, min_steps: int = 2) -> int:
    """Blocks of rns_fused_mma.cu that share each output tile's K steps
    (``bk`` deep) in one launch: 1 when the row x column tiles alone fill
    the card's ``sms`` SMs or D has fewer than 4 K steps, else about one
    block an SM, at most 8 ways and each with at least ``min_steps`` K
    steps (:data:`MIN_STEPS`).  A block holds a tile's every digit and
    most of an SM's shared memory, so the target is one block an SM, not
    rns_matmul's two (``rns_matmul.splits_for``)."""
    tiles = -(-M // bm) * -(-N // bn)
    ksteps = -(-D // bk)
    if tiles >= sms or ksteps < 4:
        return 1
    want = max(1, min(8, ksteps // min_steps, sms // tiles))
    per = -(-ksteps // want)
    return -(-ksteps // per)        # as the launch recounts it


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_args(name, p, M, D, N, blk, dev):
    """(splits, workspace pointer, counters pointer) of one launch."""
    bm, bn = blk["bm"], blk["bn"]
    bk = fused_ring(name, p.n_digits, bm, bn)[0]
    splits = splits_for(M, D, N, bm, bn, bk, _sms(dev.index),
                        MIN_STEPS[name])
    if splits == 1:
        return 1, 0, 0
    tiles = -(-M // bm) * -(-N // bn)
    ws, cnt = workspace.get(dev, tiles * splits * p.n_digits * bm * bn,
                            tiles)
    return splits, ws.data_ptr(), cnt.data_ptr()


# ------------------------------------------------------ plain versions ----
def rns_fused_encode_matmul_plain(profile, x, scale, b_res, *,
                                  bits: int = 16) -> torch.Tensor:
    """convert -> ``rns_matmul_res``: [K, ..., N] int32 residues."""
    p = get_profile(profile)
    res = rns_convert_plain(p, x, scale, bits=bits, out_dtype=torch.int32)
    return rns_matmul_plain(p, res, b_res)


def rns_fused_matmul_normalize_plain(profile, a_res, b_res, *,
                                     inv_scale: float = 1.0) -> torch.Tensor:
    """``rns_matmul_res`` -> ``mrc.decode_float(inv_scale=)``: [..., N]
    float32."""
    return rns_normalize_plain(profile,
                               rns_matmul_plain(profile, a_res, b_res),
                               inv_scale=inv_scale)


def rns_fused_dot_plain(profile, x, scale, b_res, *, bits: int = 16,
                        inv_scale: float = 1.0) -> torch.Tensor:
    """convert -> matmul -> normalize: [..., N] float32 times
    ``inv_scale``."""
    return rns_normalize_plain(profile, rns_fused_encode_matmul_plain(
        profile, x, scale, b_res, bits=bits), inv_scale=inv_scale)


# ------------------------------------------------------------ wrappers ----
def _check_b(name, p, b_res, D, device):
    if b_res.device != device:
        raise ValueError(f"{name}: operands on {device} and {b_res.device}; "
                         "need one CUDA device")
    if b_res.ndim != 3 or b_res.shape[0] != p.n_digits or \
            b_res.shape[1] != D:
        raise ValueError(f"{name}: b_res {tuple(b_res.shape)} for {p.name} "
                         f"and D={D}")
    want = torch.int8 if p.int8_safe else torch.int32
    if b_res.dtype != want:
        raise ValueError(f"{name}: b_res {b_res.dtype}; {p.name} residues "
                         f"are {want}")
    return b_res.contiguous()


def _row_scales(name, x, scale):
    """(flat float32 scales, group): one scale per run of ``group``
    flattened rows of x [..., D]; ``scale`` is a scalar or anything that
    broadcasts to ``x.shape[:-1] + (1,)``."""
    lead = tuple(x.shape[:-1])
    if not torch.is_tensor(scale):      # a fill, no host copy: graph-safe
        scale = torch.full((), scale, dtype=torch.float32, device=x.device)
    if scale.device != x.device:
        raise ValueError(f"{name}: scale on {scale.device}, x on {x.device}")
    if scale.ndim:
        ss = tuple(scale.shape)
        if (len(ss) > x.ndim or ss[-1] != 1 or any(
                a not in (1, b) for a, b in zip(ss[-2::-1], lead[::-1]))):
            raise ValueError(f"{name}: scale {ss} is not one scale per row "
                             f"of x {tuple(x.shape)}")
        scale = scale.reshape(ss[:-1])
    return _scale_runs(lead, scale.to(torch.float32))


def _quantized_call(name, p, x, scale, b_res, bits, out, key, blk,
                    inv_scale=1.0):
    """Launch rns_fused_encode_matmul or rns_fused_dot (rns_fused_mma.cu)
    into ``out``; ``inv_scale`` scales the dot's weight table."""
    D, N = x.shape[-1], b_res.shape[-1]
    b2 = _check_b(name, p, b_res, D, x.device)
    if p.n_digits not in SUPPORTED_K:
        raise ValueError(f"{name}: K={p.n_digits} (have {SUPPORTED_K})")
    x2 = x.to(torch.float32).contiguous()
    s, group = _row_scales(name, x2, scale)
    M = math.prod(x.shape[:-1])
    if M and N:
        dev = x.device
        args = [x2.data_ptr(), s.data_ptr(), group,
                float(2 ** (bits - 1) - 1), b2.data_ptr(),
                int(b2.dtype == torch.int8), M, N, D, p.lazy_chunk - 1,
                ctypes.byref(build.rns_tables_c(p, float(inv_scale))),
                out.data_ptr(), blk["bm"], blk["bn"]]
        lib = build.load("rns_fused_mma", SOURCE, _bind)
        args += _split_args(name, p, M, D, N, blk, dev)
        with torch.cuda.device(dev):
            err = getattr(lib, name)(
                *args, torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, name)
        launches[name] += 1
        autotune.last_launch[name] = (key, blk)
    return out


def rns_fused_encode_matmul(profile, x: torch.Tensor, scale,
                            b_res: torch.Tensor, *, bits: int = 16,
                            bm: int | None = None,
                            bn: int | None = None) -> torch.Tensor:
    """x [..., D] float + row scales, b_res [K, D, N] -> [K, ..., N] int32
    residues of ``convert(x, scale) @ b_res``.

    The (bm, bn) output tile resolves through ``autotune.resolve``, which
    gates it with ``check_wrapper_blocks``.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (or raises).
    """
    name = "rns_fused_encode_matmul"
    p = get_profile(profile)
    key, blk = autotune.resolve(name, p, (math.prod(x.shape[:-1]),
                                          x.shape[-1], b_res.shape[-1]),
                                x.device, bm=bm, bn=bn)
    if x.device.type == "cpu" and b_res.device.type == "cpu":
        return rns_fused_encode_matmul_plain(p, x, scale, b_res, bits=bits)
    if not x.is_cuda:
        raise ValueError(f"rns_fused_encode_matmul: x on {x.device}")
    lead, N = tuple(x.shape[:-1]), b_res.shape[-1]
    out = torch.empty((p.n_digits,) + lead + (N,), dtype=torch.int32,
                      device=x.device)
    return _quantized_call(name, p, x, scale, b_res, bits, out, key, blk)


def rns_fused_dot(profile, x: torch.Tensor, scale, b_res: torch.Tensor, *,
                  bits: int = 16, inv_scale: float = 1.0,
                  bm: int | None = None,
                  bn: int | None = None) -> torch.Tensor:
    """x [..., D] float + row scales, b_res [K, D, N] -> [..., N] float32
    signed values of ``convert(x, scale) @ b_res`` times ``inv_scale``
    (folded into the weight table).

    The (bm, bn) output tile resolves through ``autotune.resolve``, which
    gates it with ``check_wrapper_blocks``.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (or raises).
    """
    name = "rns_fused_dot"
    p = get_profile(profile)
    key, blk = autotune.resolve(name, p, (math.prod(x.shape[:-1]),
                                          x.shape[-1], b_res.shape[-1]),
                                x.device, bm=bm, bn=bn)
    if x.device.type == "cpu" and b_res.device.type == "cpu":
        return rns_fused_dot_plain(p, x, scale, b_res, bits=bits,
                                   inv_scale=inv_scale)
    if not x.is_cuda:
        raise ValueError(f"rns_fused_dot: x on {x.device}")
    lead, N = tuple(x.shape[:-1]), b_res.shape[-1]
    out = torch.empty(lead + (N,), dtype=torch.float32, device=x.device)
    return _quantized_call(name, p, x, scale, b_res, bits, out, key, blk,
                           inv_scale)


def rns_fused_matmul_normalize(profile, a_res: torch.Tensor,
                               b_res: torch.Tensor, *,
                               inv_scale: float = 1.0,
                               bm: int | None = None,
                               bn: int | None = None) -> torch.Tensor:
    """a_res [K, ..., D] (int8 or int32), b_res [K, D, N] -> [..., N]
    float32 signed values of ``a_res @ b_res`` times ``inv_scale``
    (folded into the weight table).

    The (bm, bn) output tile resolves through ``autotune.resolve``, which
    gates it with ``check_wrapper_blocks``.  A CPU tensor takes the
    plain version; a CUDA tensor launches the kernel (or raises).
    """
    name = "rns_fused_matmul_normalize"
    p = get_profile(profile)
    key, blk = autotune.resolve(name, p, (math.prod(a_res.shape[1:-1]),
                                          a_res.shape[-1], b_res.shape[-1]),
                                a_res.device, bm=bm, bn=bn)
    if a_res.device.type == "cpu" and b_res.device.type == "cpu":
        return rns_fused_matmul_normalize_plain(p, a_res, b_res,
                                                inv_scale=inv_scale)
    if not a_res.is_cuda:
        raise ValueError(f"{name}: a_res on {a_res.device}")
    K, D, N = p.n_digits, a_res.shape[-1], b_res.shape[-1]
    if K not in SUPPORTED_K or a_res.shape[0] != K:
        raise ValueError(f"{name}: a_res {tuple(a_res.shape)} for {p.name} "
                         f"(kernel digit counts {SUPPORTED_K})")
    if a_res.dtype not in (torch.int8, torch.int32) or (
            a_res.dtype == torch.int8 and not p.int8_safe):
        raise ValueError(f"{name}: a_res {a_res.dtype} for {p.name}")
    b2 = _check_b(name, p, b_res, D, a_res.device)
    lead = tuple(a_res.shape[1:-1])
    a2 = a_res.reshape(K, -1, D).contiguous()
    M = a2.shape[1]
    out = torch.empty(lead + (N,), dtype=torch.float32, device=a_res.device)
    if M and N:
        lib = build.load("rns_fused_mma", SOURCE, _bind)
        dev = a_res.device
        splits, ws, cnt = _split_args(name, p, M, D, N, blk, dev)
        with torch.cuda.device(dev):
            err = lib.rns_fused_matmul_normalize(
                a2.data_ptr(), int(a2.dtype == torch.int8), b2.data_ptr(),
                int(b2.dtype == torch.int8), M, N, D, p.lazy_chunk - 1,
                ctypes.byref(build.rns_tables_c(p, float(inv_scale))),
                out.data_ptr(), blk["bm"], blk["bn"], splits, ws, cnt,
                torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, name)
        launches[name] += 1
        autotune.last_launch[name] = (key, blk)
    return out
