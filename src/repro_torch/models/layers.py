"""Building-block layers: linear (float or RNS), norms, embedding, MLP.

Weights keep the JAX package's layout (``w [d_in, d_out]``, ``y = x @ w``)
so the port's public functions compare like with like.  Every projection
goes through :func:`linear`, which takes the RNS digit-sliced datapath
when an :class:`RnsDotConfig` is given.

Residue-domain execution: :func:`linear` also consumes and produces
:class:`~repro_torch.core.tensor.RnsTensor`, and the MLP has a deferred
datapath (``RnsDotConfig.defer``) where wi -> gate multiply -> wo stays in
residues, with one main-path normalize per block (plus one inside the
float gate nonlinearity).

Weight encoding: the JAX engine's steps run under ``jit``, where weights
are tracers and bypass its encode cache, so every step re-encodes the
MLP weights (3 weight converts per layer).  The port does the same, so
that its per-step ``OpCounts`` equal the JAX engine's, unless the MLP
holds resident weights (``models/resident.py``): encoded once, used as
they are.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core import dispatch
from repro_torch.core.rns_matmul import (RnsDotConfig, rns_dot, rns_multi_dot,
                                         rns_resident_dot,
                                         rns_resident_multi_dot)
from repro_torch.core.tensor import (RnsTensor, rt_decode, rt_dot, rt_encode,
                                     rt_encode_matmul, rt_matmul,
                                     rt_matmul_decode, rt_mul)

__all__ = ["linear", "RMSNorm", "rmsnorm", "embed", "unembed", "act_fn",
           "MLP", "mlp", "mlp_rns_deferred", "mlp_rns_resident_perop"]


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _encode_weight(w: torch.Tensor, res: RnsTensor | None,
                   rns: RnsDotConfig) -> RnsTensor:
    """The resident weight when it is on ``rns.profile``, else ``w``
    encoded now (a weight convert)."""
    if res is not None and res.profile == rns.profile:
        return res
    return rt_encode(w.to(torch.float32), rns.profile, bits=rns.qw,
                     backend=rns.backend, weight=True)


def linear(w: torch.Tensor, x, rns: RnsDotConfig | None = None, *,
           res: RnsTensor | None = None, b: torch.Tensor | None = None):
    """x @ w (+ b), through the RNS datapath when ``rns`` is given.

    ``x`` may be an :class:`RnsTensor`: the product then stays in the
    residue domain (an RnsTensor, no normalization).  ``res`` is ``w``
    encoded once (resident), used in place of re-encoding ``w``.
    """
    if isinstance(x, RnsTensor):
        if rns is None:
            raise ValueError("RnsTensor input requires an RnsDotConfig")
        if b is not None:
            raise ValueError(
                "bias add on a residue-domain activation needs a matching "
                "fixed-point grid; decode first or drop the bias")
        return rt_matmul(x, _encode_weight(w, res, rns), backend=rns.backend,
                         renorm_bits=rns.qx)
    if rns is not None and res is not None:
        y = rns_resident_dot(x.to(torch.float32), res, rns).to(x.dtype)
    elif rns is not None:
        y = rns_dot(x.to(torch.float32), w.to(torch.float32),
                    rns).to(x.dtype)
    else:
        y = x @ w
    if b is not None:
        y = y + b.to(y.dtype)
    return y


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
    """Gated (or plain) MLP weights: wi, wg [d, d_ff], wo [d_ff, d], and
    optional biases bi, bg [d_ff], bo [d] (none in the ported configs).

    Resident weights (:meth:`set_resident`) are buffers ``{name}_digits``
    and ``{name}_scale``, so ``Module.to`` moves them with the floats."""

    NAMES = ("wi", "wg", "wo")

    def __init__(self, d: int, d_ff: int, gated: bool = True,
                 device=None, bias: bool = False):
        super().__init__()
        self.wi = _param(torch.empty(d, d_ff, device=device))
        self.wg = _param(torch.empty(d, d_ff, device=device)) if gated else None
        self.wo = _param(torch.empty(d_ff, d, device=device))
        self.bi = self.bg = self.bo = None
        if bias:
            self.bi = _param(torch.zeros(d_ff, device=device))
            self.bg = _param(torch.zeros(d_ff, device=device)) if gated \
                else None
            self.bo = _param(torch.zeros(d, device=device))
        self._resident_meta: dict[str, tuple[str, float]] = {}

    def has_bias(self) -> bool:
        return any(b is not None for b in (self.bi, self.bg, self.bo))

    def set_resident(self, name: str, rt: RnsTensor):
        """Keep ``rt`` (weight ``name`` encoded once) on the module."""
        self.register_buffer(f"{name}_digits", rt.digits)
        self.register_buffer(f"{name}_scale", rt.scale)
        self._resident_meta[name] = (rt.profile, rt.mag_bits)

    def resident(self, name: str) -> RnsTensor | None:
        """Weight ``name`` as its resident RnsTensor, or None."""
        meta = self._resident_meta.get(name)
        if meta is None:
            return None
        return RnsTensor(getattr(self, f"{name}_digits"),
                         getattr(self, f"{name}_scale"), *meta)


def _mlp_resident(p: MLP, gated: bool) -> bool:
    names = ("wi", "wg", "wo") if gated else ("wi", "wo")
    return all(p.resident(n) is not None for n in names)


def mlp_rns_deferred(p: MLP, x: torch.Tensor, gated: bool, act: str,
                     cfg: RnsDotConfig):
    """The MLP block with a residue-domain main datapath: wi(x), the gate
    product and wo(.) chain in residues, the ledger renormalizing only
    where the profile would overflow.  Slow ops per block: ONE normalize
    on the main path (after wo) plus one inside the gate nonlinearity.

    On a fused backend the same chain runs through the composite kernels:
    wi is a fused encode+matmul (residues out, for the PAC gate product),
    the gate branch one fused dot, wo a fused matmul+normalize -- the
    same numerics and slow-op budget.
    """
    be = cfg.backend
    xf = x.to(torch.float32)
    f = act_fn(act)
    if dispatch.fusion_active(cfg.profile, be):
        def enc(name):
            return _encode_weight(getattr(p, name), p.resident(name), cfg)

        if gated:
            hi = rt_encode_matmul(xf, enc("wi"), bits=cfg.qx, backend=be)
            # shared_encode: x's conversion was tallied by wi's composite
            hg = rt_dot(xf, enc("wg"), bits=cfg.qx, backend=be,
                        shared_encode=True)
            gt = rt_encode(f(hg), cfg.profile, bits=cfg.qx, backend=be)
            hi = rt_mul(hi, gt, backend=be, renorm_bits=cfg.qx)
        else:
            a = f(rt_dot(xf, enc("wi"), bits=cfg.qx, backend=be))
            hi = rt_encode(a, cfg.profile, bits=cfg.qx, backend=be)
        out = rt_matmul_decode(hi, enc("wo"), backend=be, renorm_bits=cfg.qx)
        return out.to(x.dtype)
    xt = rt_encode(xf, cfg.profile, bits=cfg.qx, backend=be)
    hi = linear(p.wi, xt, cfg, res=p.resident("wi"))
    if gated:
        hg = linear(p.wg, xt, cfg, res=p.resident("wg"))
        gt = rt_encode(f(rt_decode(hg, backend=be)), cfg.profile,
                       bits=cfg.qx, backend=be)
        hi = rt_mul(hi, gt, backend=be, renorm_bits=cfg.qx)
    else:
        a = f(rt_decode(hi, backend=be))
        hi = rt_encode(a, cfg.profile, bits=cfg.qx, backend=be)
    out = linear(p.wo, hi, cfg, res=p.resident("wo"))
    return rt_decode(out, backend=be).to(x.dtype)


def mlp_rns_resident_perop(p: MLP, x: torch.Tensor, gated: bool, act: str,
                           cfg: RnsDotConfig):
    """Per-op-normalized MLP on resident weights: the arithmetic of the
    re-encode per-op path (same grids, primitives and casts) without its
    weight conversions."""
    xf = x.to(torch.float32)
    if gated:
        hi, hg = rns_resident_multi_dot(
            xf, (p.resident("wi"), p.resident("wg")), cfg)
        h = (act_fn(act)(hg) * hi).to(x.dtype)
    else:
        h = act_fn(act)(rns_resident_dot(xf, p.resident("wi"), cfg)
                        .to(x.dtype))
    y = rns_resident_dot(h.to(torch.float32), p.resident("wo"), cfg)
    return y.to(x.dtype)


def mlp(p: MLP, x: torch.Tensor, *, gated: bool = True, act: str = "silu",
        rns: RnsDotConfig | None = None):
    """The MLP block.  With ``rns``: resident weights take the resident
    paths, ``rns.defer`` the deferred chain, otherwise the per-op
    normalized branch (one normalize per matmul, one shared conversion
    of x for wi and wg).  A biased MLP falls back to per-op."""
    if rns is not None and rns.defer and p.has_bias():
        warnings.warn(
            "rns.defer requested but the MLP has biases; falling back to "
            "per-op normalization", stacklevel=2)
        rns = dataclasses.replace(rns, defer=False)
    if rns is not None and not p.has_bias():
        if _mlp_resident(p, gated):
            res_prof = p.resident("wi").profile
            if rns.profile != res_prof:
                rns = dataclasses.replace(rns, profile=res_prof)
            if rns.defer:
                return mlp_rns_deferred(p, x, gated, act, rns)
            return mlp_rns_resident_perop(p, x, gated, act, rns)
        if rns.defer:
            return mlp_rns_deferred(p, x, gated, act, rns)
        if gated:
            hi, hg = rns_multi_dot(x.to(torch.float32),
                                   (p.wi.to(torch.float32),
                                    p.wg.to(torch.float32)), rns)
            h = (act_fn(act)(hg) * hi).to(x.dtype)
            return linear(p.wo, h, rns)
    h = linear(p.wi, x, rns, b=p.bi)
    if gated:
        h = act_fn(act)(linear(p.wg, x, rns, b=p.bg)) * h
    else:
        h = act_fn(act)(h)
    return linear(p.wo, h, rns, b=p.bo)
