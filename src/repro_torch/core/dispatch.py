"""Backend dispatch for the three RNS execution primitives.

Every residue-domain computation reduces to three primitives:

  * ``convert``   -- quantize + per-digit modular reduction;
  * ``matmul``    -- digit-sliced modular matmul;
  * ``normalize`` -- MRC normalization to signed floats (THE slow op).

Backends:

  * ``reference`` -- plain PyTorch (``core/``), on any device;
  * ``cuda``      -- the hand-written kernels (``kernels/*/ops.py``).  A
    wrapper launches its kernel for a CUDA tensor and takes its plain
    version only for a tensor on the CPU;
  * ``auto``      -- ``cuda`` for CUDA operands, ``reference`` otherwise.

The fused composites and digit sharding of ``repro.core.dispatch`` are
later slices of the port: asking for them raises.

``count_ops()`` tallies primitive calls; the port runs eagerly, so the
tally is of calls made (the JAX package tallies at trace time, once per
call site reached, which gives the same numbers per step).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from repro_torch.core.moduli import get_profile

__all__ = ["BACKENDS", "resolve_backend", "OpCounts", "count_ops", "convert",
           "matmul", "normalize"]

BACKENDS = ("reference", "cuda")
_LATER = {
    "pallas_fused": "the fused backend (kernels/rns_fused)",
    "cuda_fused": "the fused backend (kernels/rns_fused)",
}

_state = threading.local()      # per-thread op-counter stacks


def resolve_backend(name: str | None, operand: torch.Tensor) -> str:
    """Map None/"auto" to the operand's device: ``cuda`` on the card,
    ``reference`` elsewhere."""
    name = name or "auto"
    if name == "auto":
        return "cuda" if operand.is_cuda else "reference"
    if name in _LATER:
        raise NotImplementedError(
            f"backend {name!r}: {_LATER[name]} is a later slice of the port")
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have {BACKENDS} or auto")
    return name


# ------------------------------------------------------------ counters ----
@dataclasses.dataclass(eq=False)  # identity semantics: counters nest
class OpCounts:
    """Primitive tallies; ``weight_converts`` is the subset of ``converts``
    spent re-encoding static weights.  ``fused`` and ``fallbacks`` (the
    JAX package's fused launches and requested-backend downgrades) stay
    0 here: this slice has neither, and a wrapper given a CUDA tensor
    launches its kernel or raises."""

    converts: int = 0
    matmuls: int = 0
    normalizes: int = 0
    fused: int = 0
    fallbacks: int = 0
    weight_converts: int = 0

    FIELDS = ("converts", "matmuls", "normalizes", "fused", "fallbacks",
              "weight_converts")

    def as_dict(self) -> dict:
        return {f: getattr(self, f) for f in self.FIELDS}


def _counters() -> list[OpCounts]:
    if not hasattr(_state, "counters"):
        _state.counters = []
    return _state.counters


def _tally(field: str):
    for c in _counters():
        setattr(c, field, getattr(c, field) + 1)


@contextlib.contextmanager
def count_ops():
    """Count primitive calls made inside the block (counters nest)."""
    c = OpCounts()
    _counters().append(c)
    try:
        yield c
    finally:
        _counters().remove(c)


# ---------------------------------------------------------- primitives ----
def convert(profile, x: torch.Tensor, scale, *, bits: int = 16,
            backend: str | None = None, weight: bool = False) -> torch.Tensor:
    """Quantize ``x`` by ``scale`` and encode to residues [K, ...]: int8
    digit planes for an int8-safe profile, else int32."""
    _tally("converts")
    if weight:
        _tally("weight_converts")
    p = get_profile(profile)
    be = resolve_backend(backend, x)
    out_dtype = torch.int8 if p.int8_safe else torch.int32
    if be == "reference":
        from repro_torch.core.quantize import quantize_with_scale
        from repro_torch.core.rns import encode_int32

        return encode_int32(p, quantize_with_scale(x, scale, bits)).to(
            out_dtype)
    from repro_torch.kernels.rns_convert.ops import rns_convert

    return rns_convert(p, x, scale, bits=bits, out_dtype=out_dtype)


def matmul(profile, a_res: torch.Tensor, b_res: torch.Tensor, *,
           backend: str | None = None) -> torch.Tensor:
    """Digit-sliced modular matmul: [K,...,M,D] @ [K,D,N] -> [K,...,M,N]."""
    _tally("matmuls")
    be = resolve_backend(backend, a_res)
    if be == "reference":
        from repro_torch.core.rns_matmul import rns_matmul_res

        return rns_matmul_res(profile, a_res, b_res)
    from repro_torch.kernels.rns_matmul.ops import rns_matmul

    return rns_matmul(profile, a_res, b_res)


def normalize(profile, res: torch.Tensor, *,
              backend: str | None = None) -> torch.Tensor:
    """MRC-normalize residues [K, ...] to signed float32 values.

    The scaled form of ``repro.core.dispatch.normalize`` (its
    ``inv_scale``, with a reference fallback for scales outside the
    float32 range) has no caller on this slice's path: it comes with the
    residue-tensor slice that passes scales.
    """
    _tally("normalizes")
    be = resolve_backend(backend, res)
    if be == "reference":
        from repro_torch.core import mrc

        return mrc.decode_float(profile, res)
    from repro_torch.kernels.rns_normalize.ops import rns_normalize

    return rns_normalize(profile, res)
