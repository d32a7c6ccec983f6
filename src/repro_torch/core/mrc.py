"""Mixed-radix conversion (MRC), base extension, sign/compare, scaling,
float and int32 reconstruction.

The paper's "slow" operation: O(K) sequential digit steps, run once per
product summation (deferred normalization) instead of once per multiply.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.moduli import get_profile
from repro_torch.core.rns import (f32_weights, moduli_vec, on_device,
                                  rns_add_const, rns_neg, tables)

__all__ = ["mrc_digits", "is_negative_digits", "is_negative",
           "compare_ge_const", "rns_sign", "base_extend", "scale_signed",
           "decode_float", "decode_int32", "scaled_weights"]


def mrc_digits(profile, res: torch.Tensor) -> torch.Tensor:
    """Mixed-radix digits d with X = sum_j d_j * prod_{i<j} m_i.  Step i
    updates only the residues of moduli i+1.. (the others are done)."""
    t = tables(profile)
    K = t.profile.n_digits
    m = moduli_vec(profile, res.ndim, res.device)
    inv = on_device(t.profile, "mrc_inv", res.device)
    r = res.to(torch.int32)             # residues of moduli i..K-1
    digits = []
    for i in range(K):
        d = r[0]
        digits.append(d)
        if i + 1 < K:
            inv_i = inv[i, i + 1:].reshape((-1,) + (1,) * (res.ndim - 1))
            # (r - d) may be negative: remainder() is a floor-mod
            r = torch.remainder((r[1:] - d[None]) * inv_i, m[i + 1:])
    return torch.stack(digits, dim=0)


def is_negative_digits(profile, digits: torch.Tensor) -> torch.Tensor:
    """Lexicographic (most-significant-last) digits >= those of M//2."""
    t = tables(profile)
    ge = torch.zeros(digits.shape[1:], dtype=torch.bool, device=digits.device)
    eq = torch.ones_like(ge)
    for j in range(digits.shape[0] - 1, -1, -1):
        ref = int(t.half_digits[j])
        ge = ge | (eq & (digits[j] > ref))
        eq = eq & (digits[j] == ref)
    return ge | eq


def is_negative(profile, res: torch.Tensor) -> torch.Tensor:
    return is_negative_digits(profile, mrc_digits(profile, res))


def compare_ge_const(profile, res: torch.Tensor, c: int) -> torch.Tensor:
    """X_signed >= c for |X|, |c| < M/2: the sign of X - c, one MRC."""
    p = get_profile(profile)
    if c == 0:
        return ~is_negative(p, res)
    return ~is_negative(p, rns_add_const(p, res, (-int(c)) % p.M))


def rns_sign(profile, res: torch.Tensor) -> torch.Tensor:
    """-1 / 0 / +1 of the signed value, int32."""
    digits = mrc_digits(profile, res)
    neg = is_negative_digits(profile, digits)
    zero = (digits == 0).all(dim=0)
    return torch.where(zero, 0, torch.where(neg, -1, 1)).to(torch.int32)


def base_extend(profile, digits: torch.Tensor, n_src: int) -> torch.Tensor:
    """Residues (all K moduli) of X = sum_{j<n_src} d_j W_j from its MRC
    digits."""
    t = tables(profile)
    m = moduli_vec(profile, digits.ndim, digits.device)
    ext = on_device(t.profile, "ext", digits.device)
    acc = torch.zeros((t.profile.n_digits,) + tuple(digits.shape[1:]),
                      dtype=torch.int32, device=digits.device)
    for j in range(n_src):
        wj = ext[j].reshape((-1,) + (1,) * (digits.ndim - 1))
        acc = torch.remainder(acc + digits[j][None] * wj, m)
    return acc


def scale_signed(profile, res: torch.Tensor,
                 rounded: bool = True) -> torch.Tensor:
    """Residues of X_signed / M_f rounded to the nearest integer, ties
    away from zero (the +M_f//2 bias is added to the magnitude): Olsen's
    fractional normalization.

    Two MRC passes, one for the sign and one on the magnitude; the
    magnitude's digits at and above ``frac_digits`` are re-extended to
    the full base through the table ``ext_scaled`` (W_j // M_f mod m_k).
    ``rounded=False`` truncates the magnitude.
    """
    p = get_profile(profile)
    f = p.frac_digits
    neg = is_negative(p, res)
    mag = torch.where(neg[None], rns_neg(p, res), res)
    if rounded:
        mag = rns_add_const(p, mag, p.M_f // 2)
    d = mrc_digits(p, mag)
    m = moduli_vec(p, res.ndim, res.device)
    ext = on_device(p, "ext_scaled", res.device)
    acc = torch.zeros_like(res, dtype=torch.int32)
    for j in range(f, p.n_digits):
        wj = ext[j - f].reshape((-1,) + (1,) * (res.ndim - 1))
        acc = torch.remainder(acc + d[j][None] * wj, m)
    return torch.where(neg[None], rns_neg(p, acc), acc)


@functools.lru_cache(maxsize=256)
def scaled_weights(profile, inv_scale: float, dtype: torch.dtype,
                   device: torch.device) -> torch.Tensor:
    """The reconstruction weights W_j * inv_scale, taken in float64 on
    the host and rounded once to ``dtype`` (past float32's range: inf, or
    subnormals and 0, as an IEEE cast gives them), on ``device``; cached,
    so a captured step reads a buffer instead of copying from the host."""
    w64 = tables(profile).W_f64 * float(inv_scale)
    return torch.as_tensor(f32_weights(w64) if dtype == torch.float32
                           else w64.astype(np.float64), device=device)


def _negated_digits(p, d: torch.Tensor) -> torch.Tensor:
    """The mixed-radix digits of M - X from those of X (0 < X < M): the
    complement M - 1 - X has digits m_j - 1 - d_j, and the one added
    carries up while a digit wraps to m_j.  Mixed-radix digits are
    unique, so these are the digits an MRC of M - X gives."""
    out, carry = [], torch.ones_like(d[0])
    for j, mj in enumerate(int(m) for m in p.moduli):
        e = (mj - 1) - d[j] + carry
        wrap = e == mj
        out.append(torch.where(wrap, 0, e))
        carry = wrap.to(d.dtype)
    return torch.stack(out)


def decode_float(profile, res: torch.Tensor, inv_scale: float = 1.0,
                 dtype=torch.float32) -> torch.Tensor:
    """Signed float reconstruction: value * inv_scale.

    Negative values are negated to their magnitude BEFORE reconstruction.
    ``inv_scale`` is folded into the float64 weights on the host, which
    are then cast to ``dtype`` (:func:`scaled_weights`); the sum runs
    digit-ascending with one rounding after every multiply and every add
    (separate ops, no FMA).  Subnormal weights and sums stay subnormal
    (IEEE gradual underflow); JAX's CPU backend flushes them to zero
    (ROADMAP C.9).
    """
    p = get_profile(profile)
    d = mrc_digits(p, res)
    neg = is_negative_digits(p, d)
    d = torch.where(neg[None], _negated_digits(p, d), d)
    if inv_scale == 1.0 and dtype == torch.float32:
        w = on_device(p, "W_f32", res.device)
    else:
        w = scaled_weights(p, float(inv_scale), dtype, res.device)
    acc = torch.zeros(res.shape[1:], dtype=dtype, device=res.device)
    for j in range(p.n_digits):
        acc = acc + d[j].to(dtype) * w[j]
    return torch.where(neg, -acc, acc)


def decode_int32(profile, res: torch.Tensor) -> torch.Tensor:
    """Exact int32 decode of values with |X| < 2**31: the sum of d_j W_j
    less M for a negative X, taken mod 2**32 (the reference's int32
    wrap-around, computed here in int64 and wrapped once)."""
    t = tables(profile)
    d = mrc_digits(profile, res)
    neg = is_negative_digits(profile, d)
    w = on_device(t.profile, "W_mod32", res.device).to(torch.int64)
    acc = torch.zeros(res.shape[1:], dtype=torch.int64, device=res.device)
    for j in range(t.profile.n_digits):
        acc = acc + d[j].to(torch.int64) * w[j]
    acc = acc - neg.to(torch.int64) * int(t.M_mod32)
    return (torch.remainder(acc + 2 ** 31, 2 ** 32) - 2 ** 31).to(torch.int32)
