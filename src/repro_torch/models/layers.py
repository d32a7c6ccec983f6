"""Building-block layers: linear (float or RNS), norms, embedding, MLP.

Weights keep the JAX package's layout (``w [d_in, d_out]``, ``y = x @ w``)
so the port's public functions compare like with like.  Every projection
goes through :func:`linear`, which takes the RNS digit-sliced datapath
when an :class:`RnsDotConfig` is given.

Weight encoding: the JAX engine's steps run under ``jit``, where weights
are tracers and bypass its encode cache, so every step re-encodes the
MLP weights (3 weight converts per layer).  The port does the same, so
that its per-step ``OpCounts`` equal the JAX engine's; weights resident
in residues are a later slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.rns_matmul import RnsDotConfig, rns_dot, rns_multi_dot

__all__ = ["linear", "RMSNorm", "rmsnorm", "embed", "unembed", "act_fn",
           "MLP", "mlp"]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def linear(w: torch.Tensor, x: torch.Tensor, rns: RnsDotConfig | None = None):
    """x @ w, through the RNS datapath when ``rns`` is given."""
    if rns is not None:
        return rns_dot(x.to(torch.float32), w.to(torch.float32),
                       rns).to(x.dtype)
    return x @ w


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _param(torch.ones(d, device=device))

    def forward(self, x):
        return rmsnorm(self.scale, x)


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: x @ table.T."""
    return x @ table.T


def act_fn(name: str):
    return {
        "silu": F.silu,
        # jax.nn.gelu defaults to the tanh approximation
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


class MLP(nn.Module):
    """Gated (or plain) MLP weights: wi, wg [d, d_ff], wo [d_ff, d]."""

    def __init__(self, d: int, d_ff: int, gated: bool = True, device=None):
        super().__init__()
        self.wi = _param(torch.empty(d, d_ff, device=device))
        self.wg = _param(torch.empty(d, d_ff, device=device)) if gated else None
        self.wo = _param(torch.empty(d_ff, d, device=device))


def mlp(p: MLP, x: torch.Tensor, *, gated: bool = True, act: str = "silu",
        rns: RnsDotConfig | None = None):
    """The MLP block; with ``rns`` on the per-op normalized branch (one
    normalize per matmul, one shared conversion of x for wi and wg)."""
    if rns is not None and gated:
        hi, hg = rns_multi_dot(x.to(torch.float32),
                               (p.wi.to(torch.float32),
                                p.wg.to(torch.float32)), rns)
        h = (act_fn(act)(hg) * hi).to(x.dtype)
        return linear(p.wo, h, rns)
    h = linear(p.wi, x, rns)
    h = act_fn(act)(linear(p.wg, x, rns)) * h if gated else act_fn(act)(h)
    return linear(p.wo, h, rns)
