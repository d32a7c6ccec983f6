"""Gradient compression for a slow hop between pods: int8 with error
feedback (the port of ``repro.distributed.compression``).

Quantizing that hop's gradients 4x (float32 -> int8) with error feedback
keeps convergence: each step's rounding residual is added back to the
next step's gradient, so the long-run update is unbiased.  Rounding is
half to even (``torch.round``, as ``jnp.round``).
"""

from __future__ import annotations

import torch

__all__ = ["compress_int8", "decompress_int8", "ef_compress_tree",
           "decompress_tree"]


def _scale(xs) -> torch.Tensor:
    amax = torch.stack([x.abs().amax() for x in xs]).amax()
    return torch.clamp(amax, min=1e-12) / 127.0


def _quantize(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)


def compress_int8(x: torch.Tensor):
    """x float32 -> (int8 values, float32 scale): symmetric, one scale a
    tensor, ``amax / 127`` with amax floored at 1e-12."""
    scale = _scale([x])
    return _quantize(x, scale), scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_tree(grads: dict, error_state: dict | None,
                     groups=None):
    """Error-feedback compression of a dict of gradients: returns
    ({name: (int8 values, scale)}, new error state {name: float32}).  The
    error state starts at zeros (``None``).  ``groups``: lists of names
    that share one scale, the max over them (a JAX leaf that stacks the
    layers of a period slot is one tensor there, several here); by
    default each tensor has its own."""
    if groups is None:
        groups = [[name] for name in grads]
    out, new_e = {}, {}
    for names in groups:
        corrected = {}
        for name in names:
            g = grads[name]
            e = (torch.zeros(g.shape, dtype=torch.float32, device=g.device)
                 if error_state is None else error_state[name])
            corrected[name] = g.to(torch.float32) + e
        s = _scale(list(corrected.values()))
        for name, c in corrected.items():
            q = _quantize(c, s)
            out[name] = (q, s)
            new_e[name] = c - decompress_int8(q, s)
    return out, new_e


def decompress_tree(qtree: dict) -> dict:
    return {name: decompress_int8(q, s) for name, (q, s) in qtree.items()}
