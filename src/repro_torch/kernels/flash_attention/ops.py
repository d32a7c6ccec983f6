"""Online-softmax attention kernel (inference forward) with GQA.

Replaces ``src/repro/kernels/flash_attention/kernel.py:flash_attention_bhtd``
(the Pallas TPU kernel, ``pl.pallas_call`` at ``kernel.py:84``) and its
wrapper ``ops.py:flash_attention``.  The models do not call it (their
attention is a plain PyTorch flash, as ``repro.models.attention`` is a
jnp one); the block tuner (``kernels/autotune.py``) and its tests do.

Bound on an H100 SXM at 700 W (3.35 TB/s; 989 TFLOP/s bf16 and fp16
and 495 TFLOP/s TF32 on the tensor cores, 67 TFLOP/s float32 outside
them): operations at the long shapes.  SmolLM-135M's attention at its
2048-token context, q [1, 2048, 9, 64] causal, is
4 * 9 * 2048**2 * 64 / 2 = 4.8 GFLOP against 13 MB of q, k, v and o
(float32): 4 us of memory traffic against 4.9 us of bf16 tensor-core
time; in float32 the bound is the smaller of 72 us on the CUDA cores and
29 us for the three TF32 products per product that 3xTF32 needs.  At
120 tokens the launch costs more than either.

Design (``csrc/flash_attention.cu``, FlashAttention-2 style): one block
of ``bq / 16`` warps per (batch x head, ``bq`` query rows), each warp
owning 16 rows with its q fragments in registers; K and V tiles of
``bk`` keys double-buffered through ``cp.async``, the KV head
``h / (H / Hk)`` read in place (no repeated copy), D padded with zeros
to the MMA depth, the tails of both axes masked in the kernel (no
padded copy).  Scores stay in the tensor-core accumulators, where the
online softmax runs (row max and sum over the 4 lanes of a quad), in
the Pallas kernel's update order with ``expf``.  TF32 or bf16
tensor-core products would miss the 2e-5 bar, so the products are
split: bf16 and fp16 inputs run ``mma.sync.m16n8k16`` with float32
accumulation (exact products for q.k), P.V as two MMAs of
``p = p_hi + p_lo`` (both in the input type) with V through
``ldmatrix.trans``; float32 inputs run 3xTF32 on
``mma.sync.m16n8k8.tf32`` (each operand split into hi = tf32(x) and
lo = tf32(x - hi), the products lo.hi + hi.lo + hi.hi).

A CPU tensor takes the plain version (``flash_attention_plain``).
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import autotune, build

__all__ = ["flash_attention", "flash_attention_plain",
           "flash_attention_plain_bhtd", "within_tolerance", "ATOL",
           "SOURCE", "launches", "NEG_INF"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
NEG_INF = -1e30
#: kernel vs plain version: float32 outputs within ATOL; bf16 and f16
#: outputs within ATOL plus one step of their type (``within_tolerance``)
ATOL = 2e-5
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}

#: kernel launches made by :func:`flash_attention` (CUDA tensors only)
launches = 0


def _bind(lib):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, i,
                                    i, i, ctypes.c_float, p]
    lib.flash_attention.restype = ctypes.c_int


def flash_attention_plain_bhtd(q, k, v, *, causal: bool,
                               tk_valid: int | None = None) -> torch.Tensor:
    """q [BH,Tq,D], k/v [BH,Tk,Dv] -> [BH,Tq,Dv] in q's dtype: masked
    softmax attention in float32 (``repro/kernels/flash_attention/ref.py``):
    keys at or past ``tk_valid`` and, if causal, keys after the query
    (top-left aligned) score -1e30; the denominator has a floor of
    1e-30."""
    Tq, Tk = q.shape[1], k.shape[1]
    tk_valid = Tk if tk_valid is None else tk_valid
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(
        q.shape[-1])
    kpos = torch.arange(Tk, device=q.device)
    valid = (kpos < tk_valid)[None, :]
    if causal:
        valid = valid & (torch.arange(Tq, device=q.device)[:, None]
                         >= kpos[None, :])
    s = torch.where(valid[None], s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def flash_attention_plain(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """Model layout: q [B,Tq,H,D], k/v [B,Tk,Hk,D(v)] (GQA) -> [B,Tq,H,Dv],
    the KV heads repeated and the heads folded into the batch, as the JAX
    wrapper does before its kernel."""
    B, Tq, H, D = q.shape
    Tk, Hk, Dv = v.shape[1:]
    G = H // Hk
    kb = k.repeat_interleave(G, 2).transpose(1, 2).reshape(B * H, Tk, D)
    vb = v.repeat_interleave(G, 2).transpose(1, 2).reshape(B * H, Tk, Dv)
    qb = q.transpose(1, 2).reshape(B * H, Tq, D)
    out = flash_attention_plain_bhtd(qb, kb, vb, causal=causal)
    return out.reshape(B, H, Tq, Dv).transpose(1, 2)


def within_tolerance(got, want) -> tuple[bool, float]:
    """(ok, max |got - want|): every element within ATOL, plus, for a
    16-bit output type, one step of that type at |want| -- kernel and
    plain version compute float32 values within ATOL of each other, and
    two such values may round to neighbouring steps."""
    if not got.numel():
        return True, 0.0
    diff = (got.float() - want.float()).abs()
    bound = torch.full_like(diff, ATOL)
    if got.dtype != torch.float32:
        _, e = torch.frexp(want.float())          # |want| in [2^(e-1), 2^e)
        bound = bound + torch.finfo(got.dtype).eps * torch.ldexp(
            torch.ones_like(diff), e - 1)
    return bool((diff <= bound).all()), float(diff.max())


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int | None = None,
                    bk: int | None = None) -> torch.Tensor:
    """q [B,Tq,H,D], k/v [B,Tk,Hk,D(v)] (GQA, H % Hk == 0) -> [B,Tq,H,Dv]
    in q's dtype.

    Tiles not given resolve through ``autotune.resolve`` (kind
    ``flash_attention``, keyed on the dtype tag, e.g. ``"float32"``,
    and ``(Tq, Tk, D)``), which gates them with ``check_wrapper_blocks``
    (an illegal tile raises ``ValueError``).  A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (or raises).
    """
    global launches
    B, Tq, H, D = q.shape
    _, Tk, Hk, Dv = v.shape
    if k.shape != (B, Tk, Hk, D) or v.shape[0] != B or H % Hk:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    tag = str(q.dtype).removeprefix("torch.")
    key, blk = autotune.resolve("flash_attention", tag, (Tq, Tk, D),
                                q.device, dims=(("Dv", Dv),), bq=bq, bk=bk)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_plain(q, k, v, causal=causal)
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}; need one CUDA device")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, "
                         f"{v.dtype}; need one of {list(_DTYPES)}")
    q2, k2, v2 = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, Tq, H, Dv), dtype=q.dtype, device=q.device)
    if B * H * Tq:
        lib = build.load("flash_attention", SOURCE, _bind)
        with torch.cuda.device(q.device):
            err = lib.flash_attention(
                q2.data_ptr(), k2.data_ptr(), v2.data_ptr(), out.data_ptr(),
                _DTYPES[q.dtype], B, Tq, Tk, H, Hk, D, Dv, blk["bq"],
                blk["bk"], int(causal), float(1.0 / math.sqrt(D)),
                torch.cuda.current_stream(q.device).cuda_stream)
        build.check(err, "flash_attention")
        launches += 1
        autotune.last_launch["flash_attention"] = (key, blk)
    return out
