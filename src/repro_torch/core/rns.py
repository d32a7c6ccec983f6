"""RNS codec: constant tables, forward encode, exact oracles.

Residue layout: a value tensor of shape ``(...)`` is represented by a
residue tensor of shape ``(K, ...)``, one digit plane per modulus.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.moduli import RnsProfile, get_profile

__all__ = ["Tables", "tables", "moduli_vec", "encode_int32", "encode_exact",
           "decode_exact", "rns_add", "rns_mul"]


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


def encode_int32(profile, v: torch.Tensor) -> torch.Tensor:
    """Residues [K, ...] of an int32 tensor: a floor-mod, so a negative
    value maps to M - |v|."""
    v = v.to(torch.int32)
    return torch.remainder(v[None], moduli_vec(profile, v.ndim + 1, v.device))


def rns_add(profile, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """PAC sum of residues [K, ...] (floor-mod, like ``jnp.remainder``)."""
    return torch.remainder(x + y, moduli_vec(profile, x.ndim, x.device))


def rns_mul(profile, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """PAC product of residues [K, ...]: int32 digits below 2**8 keep the
    product below 2**16, so no int32 overflow."""
    return torch.remainder(x * y, moduli_vec(profile, x.ndim, x.device))


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
