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

Float matmuls (:func:`matmul_rows`) run as fixed-shape calls over
blocks of ``ROW_BLOCK`` rows, and float sums (:func:`tree_sum`) as a
fixed tree of elementwise adds, so a row's result is the same float ops
whatever other rows share its call: a whole prompt, a packed step's
lanes or a decode batch (ROADMAP C.10).

Training: the RNS MLP paths have the JAX package's straight-through
backwards -- :func:`mlp_rns_deferred` and :func:`mlp_rns_resident_perop`
differentiate the float MLP over the masters (resident digits take no
gradient), :func:`rns_linear_chain` the float chain -- and
:func:`matmul_rows` records its blocks for autograd when it must.

Weight encoding: the JAX engine's steps run under ``jit``, where weights
are tracers and bypass its encode cache, so every step re-encodes the
MLP weights (3 weight converts per layer).  The port does the same, so
that its per-step ``OpCounts`` equal the JAX engine's, unless the MLP
holds resident weights (``models/resident.py``): encoded once, used as
they are.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import warnings

import numpy as np
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

__all__ = ["ROW_BLOCK", "matmul_rows", "bmm_rows", "tree_sum",
           "init_normal_", "linear", "RMSNorm", "rmsnorm", "LayerNorm",
           "layernorm", "norm", "embed", "unembed", "sinusoidal_positions",
           "act_fn", "rns_linear_chain",
           "MLP", "mlp", "mlp_rns_deferred", "mlp_rns_resident_perop"]


#: rows of every fixed-shape float matmul call (:func:`matmul_rows`)
ROW_BLOCK = 64


def matmul_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [..., K] @ w [K, N]`` as one fixed-shape ``[ROW_BLOCK, K] @ [K,
    N]`` call per block of rows (the last zero-padded).

    cuBLAS (and the CPU's BLAS) pick their kernel, and with it the order
    in which a row's products are summed, by the call's shape.  With one
    shape for every call, a row's result no longer depends on how many
    rows were batched with it, so a prompt prefilled in packed chunks
    gets the same floats as prefilled whole, and a decode lane of a
    packed step those of the decode step (ROADMAP C.10).  Where autograd
    records (a training step), the blocks are concatenated instead of
    written in place: the same calls, the same floats.
    """
    lead = tuple(x.shape[:-1])
    x2 = x.reshape(-1, x.shape[-1])
    M = x2.shape[0]
    Mp = -(-M // ROW_BLOCK) * ROW_BLOCK
    if Mp != M:
        x2 = F.pad(x2, (0, 0, 0, Mp - M))
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        out = torch.cat([torch.mm(x2[i:i + ROW_BLOCK], w)
                         for i in range(0, Mp, ROW_BLOCK)])
    else:
        out = x2.new_empty((Mp, w.shape[1]))
        for i in range(0, Mp, ROW_BLOCK):
            torch.mm(x2[i:i + ROW_BLOCK], w, out=out[i:i + ROW_BLOCK])
    return out[:M].reshape(lead + (w.shape[1],))


def bmm_rows(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x [G, M, K] @ w [G, K, N]`` (one matmul per group, e.g. per
    head) as one fixed-shape ``[G, ROW_BLOCK, K] @ [G, K, N]`` call per
    block of rows, each block contiguous: a row's result does not depend
    on the rows batched with it (see :func:`matmul_rows`)."""
    G, M, K = x.shape
    Mp = -(-M // ROW_BLOCK) * ROW_BLOCK
    if Mp != M:
        x = F.pad(x, (0, 0, 0, Mp - M))
    w = w.contiguous()
    out = [torch.bmm(x[:, i:i + ROW_BLOCK].contiguous(), w)
           for i in range(0, Mp, ROW_BLOCK)]
    return torch.cat(out, dim=1)[:, :M]


def tree_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over ``dim`` as a tree of elementwise adds of halves over the
    next power of two (zero-padded), ``dim`` dropped.

    A reduction kernel splits a row among threads by the tensor's shape
    (PyTorch's CUDA reduce gives a row more threads when there are fewer
    rows), so its order of additions, and its rounding, depends on the
    other rows.  Here the order is fixed by the code, and trailing zeros
    change nothing (x + 0 = x): a row sums the same whatever rows share
    the call and however far it is padded.
    """
    dim = dim % x.ndim
    n = x.shape[dim]
    p2 = 1 << max(n - 1, 0).bit_length()
    if p2 != n:
        pad = [0, 0] * (x.ndim - 1 - dim) + [0, p2 - n]
        x = F.pad(x, pad)
    while x.shape[dim] > 1:
        h = x.shape[dim] // 2
        x = x.narrow(dim, 0, h) + x.narrow(dim, h, h)
    return x.squeeze(dim)


def _param(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def init_normal_(module: nn.Module, generator: torch.Generator,
                 skip=()) -> None:
    """Draw every matrix of ``module`` from N(0, 1/d_in), ``d_in`` its
    next-to-last dim (a weight [d_in, d_out], an expert stack [E, d_in,
    d_out]) -- the JAX package's ``init_linear`` scale; vectors (norms'
    scales and biases, projection biases: as built) and the names in
    ``skip`` are left."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            if p.ndim < 2 or name in skip:
                continue
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[-2]), generator=generator)


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
        y = matmul_rows(x, w)
    if b is not None:
        y = y + b.to(y.dtype)
    return y


class _Chain(torch.autograd.Function):
    """:func:`rns_linear_chain`: the residue chain forward, the float
    chain's gradients (straight-through quantizers)."""

    @staticmethod
    def forward(ctx, cfg, x, *ws):
        ctx.save_for_backward(x, *ws)
        be = cfg.backend
        ht = rt_encode(x.to(torch.float32), cfg.profile, bits=cfg.qx,
                       backend=be)
        for w in ws:
            wt = rt_encode(w.to(torch.float32), cfg.profile, bits=cfg.qw,
                           backend=be, weight=True)
            ht = rt_matmul(ht, wt, backend=be, renorm_bits=cfg.qx)
        return rt_decode(ht, backend=be).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, *ws = ctx.saved_tensors
        return (None,) + _float_vjp(
            lambda x, *ws: functools.reduce(torch.matmul, ws, x),
            (x, *ws), g)


def rns_linear_chain(x: torch.Tensor, ws: tuple, cfg: RnsDotConfig):
    """x @ w1 @ w2 @ ... entirely in residues: ONE MRC normalization, the
    magnitude ledger renormalizing only where the profile would
    overflow.  Backward: the float chain's, straight through the
    quantizers."""
    return _Chain.apply(cfg, x, *ws)


def _float_vjp(fn, inputs, g):
    """The gradients of the float function ``fn`` at ``inputs`` against
    the cotangent ``g``, each in its input's dtype: the straight-through
    backward of a residue-domain forward."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in inputs]
        y = fn(*leaves)
        grads = torch.autograd.grad(y, leaves, g.to(y.dtype))
    return tuple(gr.to(t.dtype) for gr, t in zip(grads, inputs))


def rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = (tree_sum(torch.square(xf), -1) / xf.shape[-1])[..., None]
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32)).to(x.dtype)


class RMSNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _param(torch.ones(d, device=device))

    def forward(self, x):
        return rmsnorm(self.scale, x)


def layernorm(scale: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
              eps: float = 1e-5):
    """LayerNorm over the last dim with float32 statistics, the mean and
    the variance each a :func:`tree_sum` (batch-invariant)."""
    xf = x.to(torch.float32)
    d = xf.shape[-1]
    mu = (tree_sum(xf, -1) / d)[..., None]
    var = (tree_sum(torch.square(xf - mu), -1) / d)[..., None]
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.to(torch.float32) + bias.to(torch.float32)).to(x.dtype)


class LayerNorm(nn.Module):
    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = _param(torch.ones(d, device=device))
        self.bias = _param(torch.zeros(d, device=device))

    def forward(self, x):
        return layernorm(self.scale, self.bias, x)


def norm(kind: str, d: int, device=None) -> nn.Module:
    """The config's norm (``cfg.norm``): RMSNorm or LayerNorm."""
    if kind == "rmsnorm":
        return RMSNorm(d, device)
    if kind == "layernorm":
        return LayerNorm(d, device)
    raise ValueError(f"norm={kind!r}")


def embed(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    return table[ids]


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied LM head: x @ table.T."""
    return matmul_rows(x, table.T)


@functools.lru_cache(maxsize=None)
def _sinusoid_table(length: int, d: int, device: torch.device):
    pos = np.arange(length)[:, None]
    dim = np.arange(d // 2)[None, :]
    ang = pos * (1.0 / (10000 ** (2 * dim / d)))
    out = np.concatenate([np.sin(ang), np.cos(ang)], axis=-1)
    return torch.as_tensor(out.astype(np.float32), device=device)


def sinusoidal_positions(length: int, d: int, device=None) -> torch.Tensor:
    """The [length, d] float32 table of absolute positions, ``sin`` then
    ``cos`` halves: computed in float64 on the host, as numpy does in
    the JAX package, and rounded once to float32 (a float32 table
    computed on the card gives other bits).  Cached per device, so that
    a captured step reads a table copied there before its capture."""
    return _sinusoid_table(length, d, torch.device(device or "cpu"))


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


def _mlp_float_ref(x, wi, *rest, gated: bool, act: str):
    """The float MLP on the masters wi, (wg,) wo."""
    h = x @ wi
    h = act_fn(act)(x @ rest[0]) * h if gated else act_fn(act)(h)
    return h @ rest[-1]


def _masters(p: MLP, gated: bool) -> tuple:
    return (p.wi, p.wg, p.wo) if gated else (p.wi, p.wo)


class _MlpSTE(torch.autograd.Function):
    """An RNS MLP forward (``fwd()``) with the JAX package's
    float-reference backward: the gradients of the float MLP over the
    masters at ``x`` (float32), straight through every quantizer;
    resident digits take none."""

    @staticmethod
    def forward(ctx, fwd, gated, act, x, *ws):
        ctx.gated, ctx.act = gated, act
        ctx.save_for_backward(x, *ws)
        return fwd()

    @staticmethod
    def backward(ctx, g):
        x, *ws = ctx.saved_tensors
        grads = _float_vjp(
            lambda x, *ws: _mlp_float_ref(x.to(torch.float32), *ws,
                                          gated=ctx.gated, act=ctx.act),
            (x, *ws), g.to(torch.float32))
        return (None, None, None) + grads


def mlp_rns_deferred(p: MLP, x: torch.Tensor, gated: bool, act: str,
                     cfg: RnsDotConfig):
    """The MLP block with a residue-domain main datapath (see
    :func:`_mlp_deferred`); its backward is the float MLP's over the
    masters."""
    return _MlpSTE.apply(lambda: _mlp_deferred(p, x, gated, act, cfg),
                         gated, act, x, *_masters(p, gated))


def _mlp_deferred(p: MLP, x: torch.Tensor, gated: bool, act: str,
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
    if dispatch.fusion_active(cfg.profile, be) and not cfg.slice_parallel:
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
    weight conversions.  Its backward is the float MLP's over the
    masters."""
    return _MlpSTE.apply(lambda: _mlp_resident_perop(p, x, gated, act, cfg),
                         gated, act, x, *_masters(p, gated))


def _mlp_resident_perop(p: MLP, x: torch.Tensor, gated: bool, act: str,
                        cfg: RnsDotConfig):
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
    of x for wi and wg).  A biased MLP, or ``slice_parallel`` (whose
    layout the deferred chain does not keep), falls back to per-op."""
    if rns is not None and rns.defer and (p.has_bias()
                                          or rns.slice_parallel):
        warnings.warn(
            "rns.defer requested but the MLP has biases or slice_parallel "
            "is set; falling back to per-op normalization", stacklevel=2)
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
