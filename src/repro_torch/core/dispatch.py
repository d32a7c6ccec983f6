"""Backend dispatch for the three RNS execution primitives.

Every residue-domain computation reduces to three primitives:

  * ``convert``   -- quantize + per-digit modular reduction;
  * ``matmul``    -- digit-sliced modular matmul;
  * ``normalize`` -- MRC normalization to signed floats (THE slow op).

Backends:

  * ``reference``  -- plain PyTorch (``core/``), on any device;
  * ``cuda``       -- the hand-written kernels (``kernels/*/ops.py``).  A
    wrapper launches its kernel for a CUDA tensor and takes its plain
    version only for a tensor on the CPU;
  * ``cuda_fused`` -- ``cuda``, plus the fused composite kernels
    (``kernels/rns_fused``) at the ``fused_*`` call sites below;
  * ``auto``       -- ``cuda`` for CUDA operands, ``reference`` otherwise.

Fused composites: ``fused_encode_matmul`` / ``fused_matmul_normalize`` /
``fused_dot`` run the convert -> matmul -> normalize chain as one kernel,
bit-identical to the three stages, without the activation residues or
the [K, ..., N] accumulator going through device memory.  On a backend
that is not fused, or for a scale that cannot fold into one scale per
activation row, they decompose into the primitives; the latter
downgrade tallies ``fallbacks``.  Digit sharding is a later slice.

``inv_scale`` (a static python float, e.g. ``M_f**-frac_exp`` of a
fractional residue tensor) is folded into the float64 reconstruction
weights on the host and rounded once to float32, on every backend: the
kernels take the scaled weight table (``build.rns_tables_c``) and give
the floats of ``mrc.decode_float(inv_scale=)``.  So no scale, inside
float32's range or not, sends a decode to the plain path; the JAX
package's Pallas path multiplies afterwards and, for a scale outside
float32, decodes on its reference path and tallies a fallback (ROADMAP
C.8).

``count_ops()`` tallies primitive calls; the port runs eagerly, so the
tally is of calls made (the JAX package tallies at trace time, once per
call site reached, which gives the same numbers per layer and step).
A fused composite tallies its constituent logical ops plus one
``fused``, as the JAX package's does.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch

from repro_torch.core.moduli import get_profile

__all__ = ["BACKENDS", "resolve_backend", "is_fused", "fusion_active",
           "OpCounts", "count_ops", "convert", "matmul", "normalize",
           "fused_encode_matmul", "fused_matmul_normalize", "fused_dot"]

BACKENDS = ("reference", "cuda", "cuda_fused")
# a fused backend's primitives are its unfused counterpart's; only the
# fused_* composites below change what runs
_FUSED_TO_UNFUSED = {"cuda_fused": "cuda"}

_state = threading.local()      # per-thread op-counter stacks


def resolve_backend(name: str | None, operand: torch.Tensor) -> str:
    """Map None/"auto" to the operand's device: ``cuda`` on the card,
    ``reference`` elsewhere."""
    name = name or "auto"
    if name == "auto":
        return "cuda" if operand.is_cuda else "reference"
    if name not in BACKENDS:
        raise ValueError(f"unknown backend {name!r}; have {BACKENDS} or auto")
    return name


def is_fused(name: str | None) -> bool:
    """Whether the backend routes the composites through the fused
    kernels (``auto`` never does)."""
    return name in _FUSED_TO_UNFUSED


def fusion_active(profile, backend: str | None) -> bool:
    """Would the composites launch fused kernels for ``profile``?  The
    JAX package also says no under a digit-sharding context; the port has
    none yet (a later slice), so this is :func:`is_fused`."""
    return is_fused(backend)


def _unfused(name: str | None, operand: torch.Tensor) -> str:
    be = resolve_backend(name, operand)
    return _FUSED_TO_UNFUSED.get(be, be)


# ------------------------------------------------------------ counters ----
@dataclasses.dataclass(eq=False)  # identity semantics: counters nest
class OpCounts:
    """Primitive tallies; ``weight_converts`` is the subset of ``converts``
    spent re-encoding static weights (0 on resident weights), ``fused``
    counts composite kernel calls and ``fallbacks`` the composites that
    decomposed because their scale could not fold into rows."""

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

    def add(self, other: "OpCounts", times: int = 1) -> "OpCounts":
        """New OpCounts = self + times * other."""
        return OpCounts(**{f: getattr(self, f) + times * getattr(other, f)
                           for f in self.FIELDS})


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
    be = _unfused(backend, x)
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
    be = _unfused(backend, a_res)
    if be == "reference":
        from repro_torch.core.rns_matmul import rns_matmul_res

        return rns_matmul_res(profile, a_res, b_res)
    from repro_torch.kernels.rns_matmul.ops import rns_matmul

    return rns_matmul(profile, a_res, b_res)


def normalize(profile, res: torch.Tensor, *, inv_scale: float = 1.0,
              backend: str | None = None) -> torch.Tensor:
    """MRC-normalize residues [K, ...] to signed float32 values times
    ``inv_scale`` (folded into the weights, see the module docstring)."""
    _tally("normalizes")
    be = _unfused(backend, res)
    if be == "reference":
        from repro_torch.core import mrc

        return mrc.decode_float(profile, res, inv_scale=inv_scale)
    from repro_torch.kernels.rns_normalize.ops import rns_normalize

    return rns_normalize(profile, res, inv_scale=inv_scale)


# ------------------------------------------------- fused composites ----
def _fused_scale_ok(x: torch.Tensor, scale) -> bool:
    """The fused kernels take at most one scale per activation ROW: a
    scalar, or a keepdims shape with a broadcast last dim."""
    if not torch.is_tensor(scale) or scale.ndim == 0:
        return True
    xs, ss = tuple(x.shape), tuple(scale.shape)
    return (len(ss) == len(xs) and ss[-1] == 1
            and all(a in (1, b) for a, b in zip(ss, xs)))


def _fuse(profile, x, scale, backend) -> bool:
    """Whether a composite over activation ``x`` runs fused; a fused
    backend with a scale that cannot fold into rows tallies a fallback."""
    if not fusion_active(profile, backend):
        return False
    if not _fused_scale_ok(x, scale):
        _tally("fallbacks")
        return False
    return True


def fused_encode_matmul(profile, x: torch.Tensor, scale, w_res, *,
                        bits: int = 16, backend: str | None = None):
    """convert(x, scale) -> matmul with ``w_res`` [K, D, N] as one kernel:
    [K, ..., N] int32 residues.  Tallies a convert, a matmul and a
    ``fused``; decomposes into the primitives when not fused."""
    p = get_profile(profile)
    if not _fuse(p, x, scale, backend):
        ub = _unfused(backend, x)
        res = convert(p, x, scale, bits=bits, backend=ub)
        return matmul(p, res, w_res, backend=ub)
    _tally("converts")
    _tally("matmuls")
    _tally("fused")
    from repro_torch.kernels.rns_fused.ops import rns_fused_encode_matmul

    return rns_fused_encode_matmul(p, x, scale, w_res, bits=bits)


def fused_matmul_normalize(profile, a_res: torch.Tensor, b_res, *,
                           inv_scale: float = 1.0,
                           backend: str | None = None):
    """matmul -> normalize as one kernel: [..., N] float32 times
    ``inv_scale``.  Tallies a matmul, a normalize and a ``fused``."""
    p = get_profile(profile)
    if not fusion_active(p, backend):
        ub = _unfused(backend, a_res)
        return normalize(p, matmul(p, a_res, b_res, backend=ub),
                         inv_scale=inv_scale, backend=ub)
    _tally("matmuls")
    _tally("normalizes")
    _tally("fused")
    from repro_torch.kernels.rns_fused.ops import rns_fused_matmul_normalize

    return rns_fused_matmul_normalize(p, a_res, b_res, inv_scale=inv_scale)


def fused_dot(profile, x: torch.Tensor, scale, w_res, *, bits: int = 16,
              inv_scale: float = 1.0, backend: str | None = None,
              shared_encode: bool = False):
    """convert -> matmul -> normalize as one kernel: floats in, [..., N]
    float32 times ``inv_scale`` out.  Tallies a convert (none with
    ``shared_encode``: x's conversion was tallied by a sibling composite
    over the same x; the kernel still quantizes x itself), a matmul, a
    normalize and a ``fused``."""
    p = get_profile(profile)
    if not _fuse(p, x, scale, backend):
        ub = _unfused(backend, x)
        res = convert(p, x, scale, bits=bits, backend=ub)
        return normalize(p, matmul(p, res, w_res, backend=ub),
                         inv_scale=inv_scale, backend=ub)
    if not shared_encode:
        _tally("converts")
    _tally("matmuls")
    _tally("normalizes")
    _tally("fused")
    from repro_torch.kernels.rns_fused.ops import rns_fused_dot

    return rns_fused_dot(p, x, scale, w_res, bits=bits, inv_scale=inv_scale)
