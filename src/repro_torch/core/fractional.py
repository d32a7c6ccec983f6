"""Olsen fractional RNS (US20130311532): a value v is carried as the
integer X = round(v * M_f), M_f the product of the profile's first
``frac_digits`` moduli.

* add / sub: PAC (one digit-parallel op);
* multiply: the PAC digit product (at scale M_f**2), then the "slow"
  normalization (``mrc.scale_signed`` divides by M_f, rounding ties
  away from zero);
* product summation: every multiply and accumulate is PAC at scale
  M_f**2, and ONE normalization ends it: the deferred-normalization claim.

The port of ``repro.core.fractional``; every op is plain PyTorch on the
residues' device.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from repro_torch.core import mrc
from repro_torch.core.moduli import RnsProfile, get_profile
from repro_torch.core.rns import (decode_exact, encode_exact, encode_int32,
                                  moduli_vec, rns_add, rns_mul, rns_neg,
                                  rns_scale_const, rns_sub, saturate_int32)

__all__ = ["fr_encode", "fr_encode_exact", "fr_decode", "fr_decode_exact",
           "fr_add", "fr_sub", "fr_neg", "fr_mul", "fr_mul_raw",
           "fr_normalize", "fr_from_int", "fr_ge_const", "fr_dot_deferred"]


def _p(profile) -> RnsProfile:
    return get_profile(profile)


def fr_encode(profile, x: torch.Tensor) -> torch.Tensor:
    """Fractional residues of a float tensor on its device:
    round_half_even(float32(x) * M_f), cast to int32 as XLA casts
    (saturating), for |x| * M_f < 2**31."""
    p = _p(profile)
    if p.M_f >= 2 ** 31:
        raise ValueError("M_f too large for device float encode; use "
                         "fr_encode_exact")
    v = torch.round(x.to(torch.float32) * float(np.float32(p.M_f)))
    return encode_int32(p, saturate_int32(v))


def fr_encode_exact(profile, values) -> np.ndarray:
    """Host-side exact encode of floats / Fractions / ints through python
    ints (any M_f)."""
    p = _p(profile)
    vals = np.asarray(values, dtype=object)
    ints = [v * p.M_f if isinstance(v, int)
            else int(round(Fraction(v) * p.M_f)) for v in vals.reshape(-1)]
    out = encode_exact(p, np.asarray(ints, dtype=object))
    return out.reshape((p.n_digits,) + vals.shape)


def fr_decode(profile, res: torch.Tensor, dtype=None) -> torch.Tensor:
    """Signed float reconstruction of X / M_f (``mrc.decode_float``)."""
    p = _p(profile)
    return mrc.decode_float(p, res, inv_scale=1.0 / p.M_f,
                            dtype=dtype or torch.float32)


def fr_decode_exact(profile, res) -> np.ndarray:
    """Host-side exact decode to Fractions X / M_f."""
    p = _p(profile)
    if torch.is_tensor(res):
        res = res.cpu().numpy()
    ints = np.asarray(decode_exact(p, np.asarray(res)), dtype=object)
    out = [Fraction(int(v), p.M_f) for v in ints.reshape(-1)]
    return np.asarray(out, dtype=object).reshape(ints.shape)


def fr_add(profile, x, y):
    return rns_add(_p(profile), x, y)


def fr_sub(profile, x, y):
    return rns_sub(_p(profile), x, y)


def fr_neg(profile, x):
    return rns_neg(_p(profile), x)


def fr_mul_raw(profile, x, y):
    """PAC product at scale M_f**2 (normalization deferred)."""
    return rns_mul(_p(profile), x, y)


def fr_normalize(profile, raw):
    """Divide an M_f**2-scaled value by M_f, rounding: the slow op."""
    return mrc.scale_signed(_p(profile), raw, rounded=True)


def fr_mul(profile, x, y):
    return fr_normalize(profile, fr_mul_raw(profile, x, y))


def fr_from_int(profile, n: torch.Tensor) -> torch.Tensor:
    """Exact fractional encode of an integer tensor (PAC scale by M_f)."""
    p = _p(profile)
    return rns_scale_const(p, encode_int32(p, n), p.M_f)


def fr_ge_const(profile, res: torch.Tensor, c: float, *,
                raw: bool = False) -> torch.Tensor:
    """value >= c; ``raw=True`` compares an M_f**2-scaled (unnormalized)
    value.  ``c`` is scaled exactly on the host."""
    p = _p(profile)
    scale = p.M_f * p.M_f if raw else p.M_f
    return mrc.compare_ge_const(p, res, int(round(Fraction(c) * scale)))


def fr_dot_deferred(profile, xs: torch.Tensor,
                    ys: torch.Tensor) -> torch.Tensor:
    """Product summation of stacked fractional residues xs, ys [n, K, ...]:
    PAC products at scale M_f**2, ONE final normalization.  Exact while
    n * max|x*y| * M_f**2 < M/2.

    Every ``lazy_chunk`` products (each below max_digit**2) sum exactly
    in int32, so each chunk takes one modular reduction.
    """
    p = _p(profile)
    m = moduli_vec(p, xs.ndim - 1, xs.device)
    chunk = p.lazy_chunk
    acc = torch.zeros(xs.shape[1:], dtype=torch.int32, device=xs.device)
    for s in range(0, xs.shape[0], chunk):
        prod = (xs[s:s + chunk] * ys[s:s + chunk]).to(torch.int32)
        part = torch.remainder(prod.sum(dim=0, dtype=torch.int32), m)
        acc = torch.remainder(acc + part, m)
    return fr_normalize(p, acc)
