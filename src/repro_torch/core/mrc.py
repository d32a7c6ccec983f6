"""Mixed-radix conversion (MRC), sign detection, float reconstruction.

The paper's "slow" operation: O(K) sequential digit steps, run once per
product summation (deferred normalization) instead of once per multiply.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.moduli import get_profile
from repro_torch.core.rns import f32_weights, moduli_vec, on_device, tables

__all__ = ["mrc_digits", "is_negative_digits", "is_negative", "decode_float"]


def mrc_digits(profile, res: torch.Tensor) -> torch.Tensor:
    """Mixed-radix digits d with X = sum_j d_j * prod_{i<j} m_i."""
    t = tables(profile)
    K = t.profile.n_digits
    m = moduli_vec(profile, res.ndim, res.device)
    inv = on_device(t.profile, "mrc_inv", res.device)
    r = res.to(torch.int32)
    digits = []
    for i in range(K):
        d = r[i]
        digits.append(d)
        if i + 1 < K:
            inv_i = inv[i].reshape((-1,) + (1,) * (res.ndim - 1))
            # (r - d) may be negative: remainder() is a floor-mod
            r = torch.remainder((r - d[None]) * inv_i, m)
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


def decode_float(profile, res: torch.Tensor, inv_scale: float = 1.0,
                 dtype=torch.float32) -> torch.Tensor:
    """Signed float reconstruction: value * inv_scale.

    Negative values are negated to their magnitude BEFORE reconstruction.
    ``inv_scale`` is folded into the float64 weights on the host, which
    are then cast to ``dtype``; the sum runs digit-ascending with one
    rounding after every multiply and every add (separate ops, no FMA).
    """
    p = get_profile(profile)
    t = tables(p)
    m = moduli_vec(p, res.ndim, res.device)
    neg = is_negative(p, res)
    mag = torch.where(neg[None], torch.remainder(m - res, m), res)
    d = mrc_digits(p, mag)
    if inv_scale == 1.0 and dtype == torch.float32:
        w = on_device(p, "W_f32", res.device)
    else:
        w64 = t.W_f64 * float(inv_scale)
        w = torch.as_tensor(f32_weights(w64) if dtype == torch.float32
                            else w64.astype(np.float64), device=res.device)
    acc = torch.zeros(res.shape[1:], dtype=dtype, device=res.device)
    for j in range(p.n_digits):
        acc = acc + d[j].to(dtype) * w[j]
    return torch.where(neg, -acc, acc)
