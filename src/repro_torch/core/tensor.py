"""Residue-domain tensor with cross-op deferred normalization.

An :class:`RnsTensor` carries a value tensor in the residue domain:
``value = X / (scale * M_f**frac_exp)``, with ``X`` the signed integer
encoded by ``digits`` ([K, *shape] residue planes of the profile).

* ``frac_exp`` counts pending Olsen M_f powers (a fractional residue
  tensor, e.g. digits from ``core/fractional.fr_encode``): every
  fractional product raises it instead of paying the slow
  normalization, and the one decode folds ``M_f**-frac_exp`` into the
  float64 reconstruction weights on the host (M_f powers leave float32's
  range fast), which the kernels take as their weight table.
* ``mag_bits`` is a worst-case bound on ``log2|X|``: the deferral
  ledger.  Chained PAC ops (matmul, elementwise multiply, add) grow it,
  and :func:`rt_matmul` / :func:`rt_mul` consult it to decide when a
  renormalization is actually required -- one slow MRC op per chain
  instead of one per op.

The port of ``repro.core.tensor`` (forward only; every op routes through
:mod:`repro_torch.core.dispatch`).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core import dispatch
from repro_torch.core.moduli import RnsProfile, get_profile
from repro_torch.core.quantize import absmax_scale
from repro_torch.core.rns import encode_int32, rns_add, rns_mul

__all__ = ["RnsTensor", "ledger_limit_bits", "dot_out_bits",
           "matmul_out_bits", "needs_renormalize", "rt_encode",
           "rt_encode_int", "rt_decode", "rt_renormalize", "rt_matmul",
           "rt_mul", "rt_add", "rt_stack", "rt_digit_sharding",
           "rt_device_put", "rt_encode_matmul", "rt_matmul_decode", "rt_dot"]

#: headroom (bits) kept below the profile's guaranteed signed range
_SAFETY_BITS = 1.0


def ledger_limit_bits(profile) -> float:
    """THE overflow threshold every ledger decision compares against."""
    return get_profile(profile).signed_bits - _SAFETY_BITS


def dot_out_bits(a_bits: float, w_bits: float, contract_dim: int) -> float:
    """Worst-case ``log2|X|`` of a ``contract_dim``-term product sum."""
    return a_bits + w_bits + math.log2(max(contract_dim, 1))


@dataclasses.dataclass
class RnsTensor:
    """``digits`` [K, *shape] int8/int32 residues, ``scale`` a float32
    tensor broadcastable to ``shape`` (a scalar, or one scale per row or
    token), ``profile`` the profile name, ``mag_bits`` the ledger bound
    on log2|X|, ``frac_exp`` the pending M_f powers."""

    digits: torch.Tensor
    scale: torch.Tensor
    profile: str
    mag_bits: float
    frac_exp: int = 0

    @property
    def shape(self) -> tuple[int, ...]:
        return tuple(self.digits.shape[1:])

    @property
    def rns_profile(self) -> RnsProfile:
        return get_profile(self.profile)

    def headroom_bits(self) -> float:
        """Exactness margin left before |X| could exceed M/2."""
        return ledger_limit_bits(self.profile) - self.mag_bits

    def astype_digits(self, dtype) -> "RnsTensor":
        return dataclasses.replace(self, digits=self.digits.to(dtype))


def _digits32(rt: RnsTensor) -> torch.Tensor:
    return rt.digits.to(torch.int32)


def _f32(scale, device) -> torch.Tensor:
    return torch.as_tensor(scale, dtype=torch.float32, device=device)


def _inv_frac(p: RnsProfile, frac_exp: int) -> float:
    """M_f**-frac_exp as the python float the decode folds in."""
    return 1.0 / float(p.M_f) ** frac_exp if frac_exp else 1.0


# ------------------------------------------------------------ mesh layout --
def rt_digit_sharding(rt: RnsTensor, *, digit_axis: int = 0):
    """The spec the installed digit mesh gives ``rt.digits`` (its digit
    axis over the mesh's digit axis, a tuple as ``distributed/
    sharding.py`` writes specs), or None when no digit context is
    installed or the profile does not divide the axis.  ``digit_axis``:
    where K sits, 0 for ``[K, ...]``, 1 for period-major ``[P, K, ...]``."""
    from repro_torch.distributed.sharding import digit_sharding

    ds = digit_sharding()
    if ds is None or not ds.shards(rt.rns_profile.n_digits):
        return None
    return ds.digit_spec(rt.digits.ndim, axis_pos=digit_axis)


def rt_device_put(rt: RnsTensor, *, digit_axis: int = 0) -> RnsTensor:
    """An encoded tensor in the digit-sharded layout: this rank's digit
    group of a whole ``[K, ...]`` (or ``[P, K, ...]``) tensor, for an
    operand encoded before the context (weights encoded once at engine
    build).  Unchanged without a context, or when the tensor holds the
    group already."""
    from repro_torch.distributed.sharding import digit_sharding

    if rt_digit_sharding(rt, digit_axis=digit_axis) is None:
        return rt
    if rt.digits.shape[digit_axis] != rt.rns_profile.n_digits:
        return rt
    return dataclasses.replace(
        rt, digits=digit_sharding().local(rt.digits, axis_pos=digit_axis))


def rt_stack(rts) -> RnsTensor:
    """Stack tensors period-major: digits [P, K, ...], scale [P]; they
    must share one profile and ``frac_exp``."""
    rts = list(rts)
    p0, fe0 = rts[0].profile, rts[0].frac_exp
    if any(r.profile != p0 or r.frac_exp != fe0 for r in rts):
        raise ValueError("rt_stack needs one shared profile and frac_exp")
    return RnsTensor(torch.stack([r.digits for r in rts], dim=0),
                     torch.stack([r.scale.reshape(()) for r in rts], dim=0),
                     p0, max(r.mag_bits for r in rts), fe0)


# ------------------------------------------------------------- encoding ---
def rt_encode(x: torch.Tensor, profile, *, bits: int = 16, scale=None,
              backend: str | None = None,
              weight: bool = False) -> RnsTensor:
    """Quantize (absmax grid for ``bits`` unless ``scale`` is given) and
    forward-convert; ``weight=True`` tallies a static-weight convert."""
    p = get_profile(profile)
    if scale is None:
        scale = absmax_scale(x, bits)
    digits = dispatch.convert(p, x, scale, bits=bits, backend=backend,
                              weight=weight)
    return RnsTensor(digits, _f32(scale, x.device), p.name, float(bits - 1))


def _concrete_int_mag_bits(v) -> float:
    """log2(max|v|) of an integer tensor or array (0 for max|v| <= 1)."""
    a = v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    m = int(np.max(np.abs(a)))
    return math.log2(m) if m > 1 else 0.0


def rt_encode_int(v, profile, *,
                  mag_bits: float | None = None) -> RnsTensor:
    """Encode an int32 tensor exactly (scale 1).  The ledger entry
    defaults to the actual bound log2(max|v|), read from the values
    (a host sync), and raises if it escapes the profile's signed range."""
    p = get_profile(profile)
    if mag_bits is None:
        mag_bits = _concrete_int_mag_bits(v)
        if mag_bits > p.signed_bits:
            raise ValueError(
                f"profile {p.name} cannot represent max|v| = 2^"
                f"{mag_bits:.1f} exactly (signed range is "
                f"{p.signed_bits:.1f} bits); use a wider profile")
    v = torch.as_tensor(v)
    digits = encode_int32(p, v)
    if p.int8_safe:
        digits = digits.to(torch.int8)
    return RnsTensor(digits, _f32(1.0, v.device), p.name, float(mag_bits))


def rt_decode(rt: RnsTensor, *, backend: str | None = None) -> torch.Tensor:
    """Back to float32: exactly ONE MRC normalization, whatever chain of
    deferred ops made ``rt``; ``M_f**-frac_exp`` rides in the weights."""
    y = dispatch.normalize(rt.profile, _digits32(rt),
                           inv_scale=_inv_frac(rt.rns_profile, rt.frac_exp),
                           backend=backend)
    return y / rt.scale


# ------------------------------------------------------- deferral ledger --
def matmul_out_bits(a: RnsTensor, w: RnsTensor, contract_dim: int) -> float:
    return dot_out_bits(a.mag_bits, w.mag_bits, contract_dim)


def needs_renormalize(a: RnsTensor, extra_bits: float) -> bool:
    """Would growing ``a`` by ``extra_bits`` overflow the exact range?"""
    return a.mag_bits + extra_bits > ledger_limit_bits(a.profile)


def rt_renormalize(rt: RnsTensor, *, bits: int = 16,
                   backend: str | None = None) -> RnsTensor:
    """THE slow op: MRC-decode and re-encode on a fresh ``bits`` grid."""
    return rt_encode(rt_decode(rt, backend=backend), rt.profile, bits=bits,
                     backend=backend)


def _matmul_ledger(a: RnsTensor, w: RnsTensor, *, backend, renorm_bits):
    """Renormalize ``a`` once if the product sum would escape the exact
    range; raise if even that cannot fit."""
    D = a.shape[-1]
    lim = ledger_limit_bits(a.profile)
    if matmul_out_bits(a, w, D) > lim:
        a = rt_renormalize(a, bits=renorm_bits, backend=backend)
        if matmul_out_bits(a, w, D) > lim:
            raise ValueError(
                f"profile {a.profile} cannot hold an exact {D}-term product "
                f"summation of {a.mag_bits:.0f}+{w.mag_bits:.0f}-bit operands "
                f"even after renormalization; use a wider profile")
    return a


def _check_profiles(a: RnsTensor, b: RnsTensor):
    if a.profile != b.profile:
        raise ValueError(f"profile mismatch: {a.profile} vs {b.profile}")


# ---------------------------------------------------------------- PAC ops -
def rt_matmul(a: RnsTensor, w: RnsTensor, *, backend: str | None = None,
              renorm_bits: int = 16) -> RnsTensor:
    """Residues in, residues out, along the last dim of ``a``; the ledger
    renormalizes ``a`` first only if the exact range would overflow."""
    _check_profiles(a, w)
    a = _matmul_ledger(a, w, backend=backend, renorm_bits=renorm_bits)
    digits = dispatch.matmul(a.profile, a.digits, w.digits, backend=backend)
    return RnsTensor(digits, a.scale * w.scale, a.profile,
                     matmul_out_bits(a, w, a.shape[-1]),
                     a.frac_exp + w.frac_exp)


def rt_mul(a: RnsTensor, b: RnsTensor, *, backend: str | None = None,
           renorm_bits: int = 16) -> RnsTensor:
    """Elementwise PAC product (deferred: no normalization)."""
    _check_profiles(a, b)
    if needs_renormalize(a, b.mag_bits):
        a = rt_renormalize(a, bits=renorm_bits, backend=backend)
        if needs_renormalize(a, b.mag_bits):
            raise ValueError(
                f"profile {a.profile} cannot hold an exact elementwise "
                f"product of {a.mag_bits:.0f}+{b.mag_bits:.0f}-bit operands")
    digits = rns_mul(a.profile, _digits32(a), _digits32(b))
    return RnsTensor(digits, a.scale * b.scale, a.profile,
                     a.mag_bits + b.mag_bits, a.frac_exp + b.frac_exp)


def rt_add(a: RnsTensor, b: RnsTensor) -> RnsTensor:
    """Elementwise PAC sum; the operands must share one fixed-point grid,
    ``frac_exp`` included (the caller renormalizes across grids)."""
    if a.profile != b.profile or a.frac_exp != b.frac_exp:
        raise ValueError("rt_add operands must share profile and frac_exp")
    digits = rns_add(a.profile, _digits32(a), _digits32(b))
    return RnsTensor(digits, a.scale, a.profile,
                     max(a.mag_bits, b.mag_bits) + 1.0, a.frac_exp)


# ------------------------------------------------------- fused entries ---
def _encode_out_bits(p, bits: int, w: RnsTensor, D: int) -> float:
    """Ledger bound of encode(x, bits) @ w; raises if the exact range
    would overflow."""
    out_bits = dot_out_bits(float(bits - 1), w.mag_bits, D)
    if out_bits > ledger_limit_bits(p):
        raise ValueError(
            f"profile {p.name} cannot hold an exact {D}-term product "
            f"summation of {bits - 1}+{w.mag_bits:.0f}-bit operands; use a "
            f"wider profile or fewer bits")
    return out_bits


def rt_encode_matmul(x: torch.Tensor, w: RnsTensor, *, bits: int = 16,
                     scale=None, backend: str | None = None) -> RnsTensor:
    """Head of a chain: ``rt_matmul(rt_encode(x), w)`` with the ledger and
    numerics of that pair, as one fused kernel on a fused backend."""
    p = get_profile(w.profile)
    if scale is None:
        scale = absmax_scale(x, bits)
    out_bits = _encode_out_bits(p, bits, w, x.shape[-1])
    digits = dispatch.fused_encode_matmul(p, x, scale, w.digits, bits=bits,
                                          backend=backend)
    return RnsTensor(digits, _f32(scale, x.device) * w.scale, p.name,
                     out_bits, w.frac_exp)


def rt_matmul_decode(a: RnsTensor, w: RnsTensor, *,
                     backend: str | None = None,
                     renorm_bits: int = 16) -> torch.Tensor:
    """Tail of a chain: ``rt_decode(rt_matmul(a, w))`` bit for bit, as one
    fused kernel on a fused backend.  The scale is ``a.scale * w.scale``
    divided once (``repro.core.tensor`` order: a deferred MLP's
    ``a.scale`` is ``((sx * sw_i) * sg)``), after ``M_f**-frac_exp`` of
    the two operands' frac_exp in the weights."""
    _check_profiles(a, w)
    a = _matmul_ledger(a, w, backend=backend, renorm_bits=renorm_bits)
    inv = _inv_frac(a.rns_profile, a.frac_exp + w.frac_exp)
    y = dispatch.fused_matmul_normalize(a.profile, a.digits, w.digits,
                                        inv_scale=inv, backend=backend)
    return y / (a.scale * w.scale)


def rt_dot(x: torch.Tensor, w: RnsTensor, *, bits: int = 16, scale=None,
           backend: str | None = None,
           shared_encode: bool = False) -> torch.Tensor:
    """encode -> digit matmul -> normalize, floats in and out: one fused
    kernel on a fused backend.  Divides by ``scale * w.scale`` after
    ``M_f**-w.frac_exp`` in the weights."""
    p = get_profile(w.profile)
    if scale is None:
        scale = absmax_scale(x, bits)
    _encode_out_bits(p, bits, w, x.shape[-1])
    y = dispatch.fused_dot(p, x, scale, w.digits, bits=bits,
                           inv_scale=_inv_frac(p, w.frac_exp),
                           backend=backend, shared_encode=shared_encode)
    return y / (_f32(scale, x.device) * w.scale)
