"""Moduli selection for the RNS datapath (PyTorch port of ``repro.core.moduli``).

Each RNS digit is an 8-bit word, so the default moduli are <= 128: residues
lie in [0, 127] and fit int8, products are < 2**14, and ~2**17 products
accumulate in int32 between modular reductions ("lazy reduction").  A
<= 256 ("u8") family is kept for the plain path.
"""

from __future__ import annotations

import dataclasses
import functools
import math

__all__ = ["greedy_coprime_moduli", "RnsProfile", "PROFILES", "get_profile",
           "narrowest_profile", "required_digits"]


def greedy_coprime_moduli(limit: int, count: int) -> tuple[int, ...]:
    """Largest-first greedy pairwise-coprime moduli <= ``limit``."""
    chosen: list[int] = []
    cand = limit
    while len(chosen) < count and cand >= 2:
        if all(math.gcd(cand, m) == 1 for m in chosen):
            chosen.append(cand)
        cand -= 1
    if len(chosen) < count:
        raise ValueError(f"cannot find {count} coprime moduli <= {limit}")
    return tuple(chosen)


@dataclasses.dataclass(frozen=True)
class RnsProfile:
    """A static description of an RNS working register.

    ``moduli`` are pairwise coprime (descending); ``frac_digits`` leading
    moduli form the fractional base M_f.
    """

    name: str
    moduli: tuple[int, ...]
    frac_digits: int = 2

    def __post_init__(self):
        ms = self.moduli
        if not ms:
            raise ValueError(f"profile {self.name!r}: empty moduli set")
        if any(m < 2 for m in ms):
            raise ValueError(f"profile {self.name!r}: modulus < 2")
        if len(set(ms)) != len(ms):
            raise ValueError(f"profile {self.name!r}: duplicate modulus")
        for i in range(len(ms)):
            for j in range(i + 1, len(ms)):
                if math.gcd(ms[i], ms[j]) != 1:
                    raise ValueError(
                        f"profile {self.name!r}: moduli not coprime: "
                        f"{ms[i]}, {ms[j]}")
        if not (0 < self.frac_digits < len(ms)):
            raise ValueError("frac_digits must be in (0, n_digits)")

    @property
    def n_digits(self) -> int:
        return len(self.moduli)

    @functools.cached_property
    def M(self) -> int:
        """Full dynamic range (product of all moduli)."""
        return math.prod(self.moduli)

    @functools.cached_property
    def M_f(self) -> int:
        """Fractional base: product of the first ``frac_digits`` moduli."""
        return math.prod(self.moduli[: self.frac_digits])

    @property
    def range_bits(self) -> float:
        return math.log2(self.M)

    @property
    def signed_bits(self) -> int:
        """Guaranteed exact signed-magnitude bits (|X| < M/2)."""
        return int(math.floor(self.range_bits)) - 1

    @property
    def max_digit(self) -> int:
        return max(self.moduli)

    @property
    def lazy_chunk(self) -> int:
        """Max #terms accumulable in int32 between modular reductions."""
        return (2**31 - 1) // (self.max_digit - 1) ** 2

    @property
    def int8_safe(self) -> bool:
        """Residues fit signed int8 (the matmul kernel's operand type)."""
        return self.max_digit <= 128

    def dot_capacity(self, qa: int, qw: int) -> int:
        """Max #terms of an exact signed dot of qa x qw-bit operands."""
        return self.M // (2 ** (qa + qw - 1))


def _mk(name: str, n: int, frac: int, limit: int = 128) -> RnsProfile:
    return RnsProfile(name, greedy_coprime_moduli(limit, n), frac)


PROFILES: dict[str, RnsProfile] = {
    "rns5": _mk("rns5", 5, 1),
    "rns6": _mk("rns6", 6, 1),
    "rns7": _mk("rns7", 7, 1),
    "rns8": _mk("rns8", 8, 1),
    "rns9": _mk("rns9", 9, 2),
    "rns16": _mk("rns16", 16, 4),
    "rns12": _mk("rns12", 12, 3),
    "rns18": _mk("rns18", 18, 8),
    "rns21": _mk("rns21", 21, 8),
    # residues do NOT fit signed int8: plain path only
    "rns8_u8": RnsProfile("rns8_u8", greedy_coprime_moduli(256, 8), 2),
}


def get_profile(profile: str | RnsProfile) -> RnsProfile:
    if isinstance(profile, RnsProfile):
        return profile
    try:
        return PROFILES[profile]
    except KeyError:
        raise KeyError(
            f"unknown RNS profile {profile!r}; have {sorted(PROFILES)}"
        ) from None


def narrowest_profile(min_signed_bits: float,
                      cap: str | RnsProfile = "rns9") -> RnsProfile:
    """Narrowest registered profile whose exact signed range covers
    ``min_signed_bits``, never wider than ``cap``.

    The resident-weight encoder (``models/resident.py``) picks per-layer
    profiles with it.  Candidates are the registered :data:`PROFILES`
    only (so a by-name lookup round-trips), ordered by ``range_bits``,
    and keep ``cap``'s ``int8_safe`` property; ``cap`` itself is returned
    when nothing narrower suffices.
    """
    cap = get_profile(cap)
    cands = sorted(
        (p for p in PROFILES.values()
         if (p.int8_safe or not cap.int8_safe)
         and p.range_bits <= cap.range_bits),
        key=lambda p: p.range_bits)
    for p in cands:
        if p.signed_bits >= min_signed_bits:
            return p
    return cap


def required_digits(n_terms: int, qa: int, qw: int, limit: int = 128) -> int:
    """Digit slices an exact ``n_terms``-term ``qa`` x ``qw``-bit dot
    needs, on the greedy coprime moduli <= ``limit``."""
    need_bits = (qa + qw - 1) + math.log2(max(n_terms, 1))
    bits = 0.0
    for k, m in enumerate(greedy_coprime_moduli(limit, 24), start=1):
        bits += math.log2(m)
        if bits > need_bits:
            return k
    raise ValueError("need more than 24 digits")
