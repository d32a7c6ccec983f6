"""Symmetric fixed-point quantization feeding the RNS conversion.

Two grid policies, as in ``repro.core.quantize``:

* **per-tensor** (default): one absmax scale for the whole tensor;
* **per-sequence** (mask-aware): with a :class:`token_mask` installed,
  activations whose leading dims match the mask get one scale per row
  (or per (row, token) with ``per_token=True``) over the real tokens
  only, so padding and batch neighbours never move a row's grid.

Blocks whose absmax sits below ``eps`` flush to the unit grid.
"""

from __future__ import annotations

import threading

import torch

__all__ = ["token_mask", "current_token_mask", "absmax_scale",
           "quantize_with_scale", "quantize", "dequantize"]

_state = threading.local()          # per-thread token-mask stack


def _masks() -> list:
    if not hasattr(_state, "masks"):
        _state.masks = []
    return _state.masks


class token_mask:
    """Install a ``[B, T]`` (or ``[B, 1]``) validity mask for per-sequence
    quantization; ``per_token=True`` keeps one grid per (row, token).
    ``mask=None`` is a no-op."""

    def __init__(self, mask, per_token: bool = False):
        self.mask = mask
        self.per_token = per_token

    def __enter__(self):
        if self.mask is not None:
            _masks().append((self.mask, self.per_token))
        return self

    def __exit__(self, *exc):
        if self.mask is not None:
            _masks().pop()
        return False


def current_token_mask():
    """The innermost installed (mask, per_token) pair, or None."""
    ms = _masks()
    return ms[-1] if ms else None


def _context_mask_for(x: torch.Tensor):
    ctx = current_token_mask()
    if ctx is None:
        return None
    mask, per_token = ctx
    if x.ndim == mask.ndim + 1 and tuple(x.shape[: mask.ndim]) == tuple(
            mask.shape):
        return mask, per_token
    return None


def absmax_scale(x: torch.Tensor, bits: int, axis=None, eps: float = 1e-12,
                 mask=None, per_token: bool = False) -> torch.Tensor:
    """float32 scale s such that round(x*s) uses <= ``bits`` signed bits.

    ``qmax / amax`` is a true float32 division (``qmax / tensor`` in
    PyTorch would multiply by a reciprocal and round differently).
    """
    qmax = float(2 ** (bits - 1) - 1)
    if mask is None and axis is None:
        ctx = _context_mask_for(x)
        if ctx is not None:
            mask, per_token = ctx
    if mask is not None:
        m = mask.to(torch.bool)
        mask_ndim = m.ndim
        m = m.reshape(tuple(m.shape) + (1,) * (x.ndim - m.ndim))
        red = (tuple(range(mask_ndim, x.ndim)) if per_token
               else tuple(range(1, x.ndim)))
        amax = torch.where(m, x.abs(), 0.0).amax(dim=red, keepdim=True)
    elif axis is None:
        amax = x.abs().amax()
    else:
        amax = x.abs().amax(dim=axis, keepdim=True)
    return torch.where(amax >= eps, amax.new_full((), qmax) / amax, 1.0)


def quantize_with_scale(x: torch.Tensor, s, bits: int) -> torch.Tensor:
    """v = clip(round_half_even(x*s), -qmax, qmax) as int32."""
    qmax = 2 ** (bits - 1) - 1
    return torch.clamp(torch.round(x.to(torch.float32) * s),
                       -qmax, qmax).to(torch.int32)


def quantize(x: torch.Tensor, bits: int, axis=None):
    """(int32 values, scale) on the absmax grid: v = clip(round(x*s))."""
    s = absmax_scale(x, bits, axis=axis)
    return quantize_with_scale(x, s, bits), s


def dequantize(v: torch.Tensor, s) -> torch.Tensor:
    """v / s in float32 (a true division)."""
    return v.to(torch.float32) / s
