"""MRC normalization kernel: residues -> signed float32 values.

Replaces ``src/repro/kernels/rns_normalize/kernel.py:rns_normalize_tiles``
(the Pallas TPU kernel, ``pl.pallas_call`` at ``kernel.py:97``).

Bound on an H100: bytes.  Each element reads K int32 residues and
writes one float32 (40 bytes for rns9) against one K-step MRC pass
(K(K-1)/2 terms) and 2K float32 ops, but a floor-mod by a runtime
modulus (C's ``%``) costs about 20 instructions, so an MRC of them is
instruction-bound.  The design has no division and one pass:

* every MRC term ``(r_j - d_i) * inv_ij mod m_j`` by a direct
  remainder: an add of the offset ``roff_j``, a multiply-low by the
  table's ``mrc_c`` (which holds ``inv_ij``) and a multiply-high by
  ``m_j`` (``mrc_term``, ``csrc/rns_mrc.cuh``): the same integers;
* one MRC pass an element: a negative value's magnitude M - X has the
  digits ``m_j - 1 - d_j`` plus one carried digit-ascending, the digits
  a second MRC of ``(m_j - r_j) mod m_j`` would give
  (``csrc/rns_mrc.cuh``, the fused kernels' epilogue too);
* one element a thread, all K digits in registers (K a template
  parameter), each digit plane's load coalesced across a warp; 2 or 4
  elements a thread with vector loads measured slower (fewer warps to
  hide the MRC's latency: ``scripts/kernel_variants.py
  normalize_design``);
* the float sum written with ``__fmul_rn`` / ``__fadd_rn`` so that nvcc
  cannot contract it into FMAs: this is what holds the kernel bit for
  bit to ``core/mrc.decode_float`` (ROADMAP C.1).

Wide profiles whose W_j overflow float32 (rns21) get the same inf/NaN
the float32 reference gives.  A scale (``inv_scale``, the
``M_f**-frac_exp`` of a fractional residue tensor) travels inside the
weights: W_j * inv_scale rounded once to float32 on the host, as
``mrc.decode_float(inv_scale=)`` rounds them, so the kernel is the same
at any scale (subnormal weights included: nvcc's default keeps
denormals).  Tables travel by value as a kernel
argument (``build.RnsTablesC``), so any number of profiles can be in
use at once.  Threads per block (the tile ``bt``) are a launch
parameter, chosen per shape bucket through ``kernels/autotune.py``;
at 32 registers a thread or fewer (``REGISTERS`` in
``analysis/kernel_audit.py``) every candidate fits every profile.
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


def rns_normalize_plain(profile, res: torch.Tensor, *,
                        inv_scale: float = 1.0) -> torch.Tensor:
    """Plain PyTorch version: ``core/mrc.decode_float`` (MRC, sign,
    magnitude MRC, float32 digit-ascending sum, one rounding per op)."""
    return mrc.decode_float(profile, res, inv_scale=inv_scale)


def rns_normalize(profile, res: torch.Tensor, *, inv_scale: float = 1.0,
                  bt: int | None = None) -> torch.Tensor:
    """res [K, ...] int residues -> [...] float32 signed values times
    ``inv_scale`` (folded into the weight table).

    Residues must be reduced: ``res[j]`` in ``[0, m_j)``, as every
    producer in the port leaves them (the kernel's multiply-high mods
    assume it; the plain version's first digit is ``res[0]`` as given).
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
        return rns_normalize_plain(p, res, inv_scale=inv_scale)
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
                flat.data_ptr(), T,
                ctypes.byref(build.rns_tables_c(p, float(inv_scale))),
                out.data_ptr(), blk["bt"],
                torch.cuda.current_stream(res.device).cuda_stream)
        build.check(err, "rns_normalize")
        launches += 1
        autotune.last_launch["rns_normalize"] = (key, blk)
    return out.reshape(shape)
