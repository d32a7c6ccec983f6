"""RNS codec: constant tables, forward encode, exact oracles, PAC ops.

Residue layout: a value tensor of shape ``(...)`` is represented by a
residue tensor of shape ``(K, ...)``, one digit plane per modulus.  Every
PAC (parallel-array-computation) op is one elementwise floor-mod op per
digit (``torch.remainder``, as ``jnp.remainder``), all digits independent.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.moduli import RnsProfile, get_profile

__all__ = ["Tables", "tables", "moduli_vec", "encode_int32", "encode_float",
           "saturate_int32", "encode_exact", "decode_exact", "rns_add",
           "rns_sub", "rns_neg", "rns_mul", "rns_scale_const",
           "rns_add_const", "to_int8", "from_int8"]


class Tables:
    """Host-side constant tables for a profile (numpy)."""

    def __init__(self, p: RnsProfile):
        self.profile = p
        K = p.n_digits
        ms = p.moduli
        self.moduli = np.asarray(ms, np.int32)
        # mrc_inv[i, j] = (m_i)^-1 mod m_j   (only used for j > i)
        inv = np.ones((K, K), np.int64)
        for i in range(K):
            for j in range(i + 1, K):
                inv[i, j] = pow(ms[i], -1, ms[j])
        self.mrc_inv = inv.astype(np.int32)
        # W_j = prod_{i<j} m_i (python ints, exact)
        self.W: list[int] = [1] * K
        for j in range(1, K):
            self.W[j] = self.W[j - 1] * ms[j - 1]
        # base-extension table: ext[j, k] = W_j mod m_k
        self.ext = np.asarray([[w % m for m in ms] for w in self.W], np.int32)
        # scale-by-M_f table: Wf_j = W_j // M_f for j >= frac_digits
        self.Wf: list[int] = [w // p.M_f for w in self.W[p.frac_digits:]]
        self.ext_scaled = np.asarray([[w % m for m in ms] for w in self.Wf],
                                     np.int32)
        # W_j and M mod 2**32 as int32, for the wrap-around int32 decode
        self.W_mod32 = np.asarray([_wrap32(w) for w in self.W], np.int32)
        self.M_mod32 = np.int32(_wrap32(p.M))
        # MRC digits of M//2: X is negative iff its digits are >= these
        half, x = [], p.M // 2
        for m in ms:
            half.append(x % m)
            x //= m
        self.half_digits = np.asarray(half, np.int32)
        self.W_f64 = np.asarray([float(w) for w in self.W], np.float64)
        # the kernels' float32 weights.  Wide profiles (rns21) have W_j
        # beyond the float32 range: the cast gives inf, exactly as the
        # reference's float32 cast does, and the sums then give inf/NaN
        self.W_f32 = f32_weights(self.W_f64)


def _wrap32(x: int) -> int:
    """x mod 2**32 as a signed int32 value."""
    x %= 1 << 32
    return x - (1 << 32) if x >= 1 << 31 else x


def f32_weights(w_f64: np.ndarray) -> np.ndarray:
    """float64 -> float32 rounding of reconstruction weights (inf past
    the float32 range, as an IEEE cast gives it, without a warning)."""
    with np.errstate(over="ignore"):
        return np.asarray(w_f64, np.float64).astype(np.float32)


@functools.lru_cache(maxsize=None)
def tables(profile: RnsProfile | str) -> Tables:
    return Tables(get_profile(profile))


@functools.lru_cache(maxsize=None)
def on_device(profile: RnsProfile, name: str, device: torch.device):
    """A table of ``tables(profile)`` as a tensor on ``device``, copied
    once per (profile, table, device) and not on every call."""
    return torch.as_tensor(getattr(tables(profile), name), device=device)


def moduli_vec(profile, ndim: int, device) -> torch.Tensor:
    """Moduli as an int32 tensor shaped (K, 1, ..., 1) with ``ndim`` dims."""
    m = on_device(get_profile(profile), "moduli", torch.device(device))
    return m.reshape((-1,) + (1,) * (ndim - 1))


@functools.lru_cache(maxsize=256)
def _const_residues(profile: RnsProfile, c: int, device: torch.device):
    """Residues [K] of the python int ``c`` (any size: reduced per modulus
    on the host), on ``device``; cached, so a captured step reads a
    buffer instead of copying from the host."""
    return torch.tensor([c % m for m in profile.moduli], dtype=torch.int32,
                        device=device)


def encode_int32(profile, v: torch.Tensor) -> torch.Tensor:
    """Residues [K, ...] of an int32 tensor: a floor-mod, so a negative
    value maps to M - |v|."""
    v = v.to(torch.int32)
    return torch.remainder(v[None], moduli_vec(profile, v.ndim + 1, v.device))


def saturate_int32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> int32 as XLA converts: NaN to 0, values beyond the int32
    range to its ends.  (``.to(torch.int32)`` of such a value gives
    -2**31 on the CPU; the card's ``cvt`` saturates.)"""
    v = torch.nan_to_num(v, nan=0.0)
    return v.to(torch.float64).clamp(-2.0 ** 31, 2.0 ** 31 - 1).to(
        torch.int32)


def encode_float(profile, x: torch.Tensor, scale: float) -> torch.Tensor:
    """Quantize to round_half_even(x * scale) and encode.  The float32
    clip bound of the reference, 2**31 - 1, rounds to 2**31, so the clip
    leaves 2**31 to the saturating cast (:func:`saturate_int32`)."""
    v = torch.round(x.to(torch.float32) * float(np.float32(scale)))
    bound = float(np.float32(2.0 ** 31 - 1))
    return encode_int32(profile, saturate_int32(v.clamp(-bound, bound)))


def rns_add(profile, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """PAC sum of residues [K, ...] (floor-mod, like ``jnp.remainder``)."""
    return torch.remainder(x + y, moduli_vec(profile, x.ndim, x.device))


def rns_sub(profile, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """PAC difference of residues [K, ...]."""
    m = moduli_vec(profile, x.ndim, x.device)
    return torch.remainder(x - y + m, m)


def rns_neg(profile, x: torch.Tensor) -> torch.Tensor:
    """PAC negation: residues of M - X."""
    m = moduli_vec(profile, x.ndim, x.device)
    return torch.remainder(m - x, m)


def rns_mul(profile, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """PAC product of residues [K, ...]: int32 digits below 2**8 keep the
    product below 2**16, so no int32 overflow."""
    return torch.remainder(x * y, moduli_vec(profile, x.ndim, x.device))


def _const_vec(profile, c: int, x: torch.Tensor) -> torch.Tensor:
    p = get_profile(profile)
    return _const_residues(p, int(c), x.device).reshape(
        (-1,) + (1,) * (x.ndim - 1))


def rns_scale_const(profile, x: torch.Tensor, c: int) -> torch.Tensor:
    """PAC scaling by a python-int constant of any size, exactly."""
    return torch.remainder(x * _const_vec(profile, c, x),
                           moduli_vec(profile, x.ndim, x.device))


def rns_add_const(profile, x: torch.Tensor, c: int) -> torch.Tensor:
    """PAC sum with a python-int constant of any size, exactly."""
    return torch.remainder(x + _const_vec(profile, c, x),
                           moduli_vec(profile, x.ndim, x.device))


def to_int8(profile, res: torch.Tensor) -> torch.Tensor:
    """int8 storage of residues; raises for a profile whose digits do not
    fit."""
    p = get_profile(profile)
    if not p.int8_safe:
        raise ValueError(f"profile {p.name} residues exceed int8")
    return res.to(torch.int8)


def from_int8(res8: torch.Tensor) -> torch.Tensor:
    return res8.to(torch.int32)


def encode_exact(profile, values) -> np.ndarray:
    """Host-side exact encode of arbitrary-size python ints (test oracle)."""
    t = tables(profile)
    vals = np.asarray(values, dtype=object)
    flat = vals.reshape(-1)
    out = np.empty((t.profile.n_digits, flat.size), np.int32)
    for j, m in enumerate(t.profile.moduli):
        out[j] = [int(int(v) % m) for v in flat]
    return out.reshape((t.profile.n_digits,) + vals.shape)


def decode_exact(profile, res, signed: bool = True) -> np.ndarray:
    """Host-side exact CRT decode to python ints (test oracle)."""
    t = tables(profile)
    p = t.profile
    res = np.asarray(res)
    K = p.n_digits
    flat = res.reshape(K, -1)
    out = []
    for col in range(flat.shape[1]):
        x = 0
        for j in range(K):
            m = p.moduli[j]
            d = (int(flat[j, col]) - x) * pow(t.W[j] % m, -1, m) % m
            x += d * t.W[j]
        if signed and x >= p.M // 2:
            x -= p.M
        out.append(x)
    return np.asarray(out, dtype=object).reshape(res.shape[1:])
