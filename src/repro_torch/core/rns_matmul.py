"""Digit-sliced RNS matmul with one normalization per output -- the core.

  float x --quantize--> int --convert--> residues [K, ..., D]
  float w --quantize--> int --convert--> residues [K, D, N]
      per-slice matmul, lazy modular reduction
  residues [K, ..., N] --MRC normalize--> float y

Training: ``rns_dot`` and ``rns_multi_dot`` are ``torch.autograd.Function``s
with the JAX package's straight-through gradients (its ``custom_vjp``s):
the quantizer passes gradients through unchanged, and with
``RnsDotConfig.backward_rns`` (the default) the backward's two products,
``gx = g @ w.T`` and ``gw = x.T @ g``, run through the RNS datapath too,
on the forward's backend; otherwise they are float matmuls.  Under
``torch.no_grad`` / ``inference_mode`` (serving) only the forward runs.
On a fused backend each projection is one fused kernel
(``dispatch.fused_dot``).  The backward runs under the forward's digit
and batch layouts (``distributed/sharding.py``): on the card autograd
runs it on a thread of its own.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dispatch
from repro_torch.core.moduli import get_profile
from repro_torch.core.quantize import absmax_scale
from repro_torch.core.rns import moduli_vec
from repro_torch.distributed import sharding

__all__ = ["RnsDotConfig", "modular_matmul", "rns_matmul_res", "rns_dot",
           "rns_dot_fwd_only", "rns_multi_dot", "rns_resident_dot",
           "rns_resident_multi_dot"]


@dataclasses.dataclass(frozen=True)
class RnsDotConfig:
    profile: str = "rns9"
    qx: int = 16            # activation fixed-point bits
    qw: int = 16            # weight fixed-point bits
    qg: int = 16            # gradient fixed-point bits (backward)
    # "auto" (None) | "reference" | "cuda" | "cuda_fused" -- see
    # core/dispatch.py
    backend: str | None = None
    backward_rns: bool = True   # the backward's products through RNS too
    # residue-domain chaining: the MLP block runs wi -> gate multiply ->
    # wo in residues with one main-path normalize (models/layers.py)
    defer: bool = False
    # one digit slice per compute unit (paper Fig. 5): keep the
    # per-primitive path, whose residues the digit mesh lays out (JAX
    # adds layout constraints there; a program of one rank needs none)
    slice_parallel: bool = False


def _check_capacity(cfg: RnsDotConfig, contract_dim: int, qa: int, qb: int):
    p = get_profile(cfg.profile)
    cap = p.dot_capacity(qa, qb)
    if contract_dim > cap:
        raise ValueError(
            f"RNS profile {p.name} ({p.range_bits:.1f} bits) cannot hold an "
            f"exact {contract_dim}-term {qa}x{qb}-bit dot product "
            f"(capacity {cap}); use a wider profile or fewer bits")


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer product-sum of residues through a float64 matmul, as
    float64.

    Exact: every partial sum is an integer below chunk * (m-1)**2 < 2**31,
    far inside float64's 2**53 of exact integers, and a float remainder
    of such integers is exact too (IEEE fmod).  (CUDA PyTorch has no
    integer matmul; float64 keeps this on the operand's device.)
    """
    return torch.matmul(a.to(torch.float64), b.to(torch.float64))


def modular_matmul(a_res: torch.Tensor, b_res: torch.Tensor,
                   mvec: torch.Tensor, chunk: int) -> torch.Tensor:
    """Digit-batched matmul with a modular reduction every ``chunk`` terms.

    ``a_res`` [K, ..., M, D], ``b_res`` [K, D, N]; ``mvec`` moduli shaped
    (K, 1, ..., 1); ``chunk`` = ``profile.lazy_chunk``.
    """
    K, D = a_res.shape[0], a_res.shape[-1]
    lead = a_res.shape[1:-1]
    a2 = a_res.reshape(K, -1, D)
    m = mvec.reshape(K, 1, 1).to(torch.float64)
    acc = None
    for c in range(-(-D // chunk)):
        sl = slice(c * chunk, min((c + 1) * chunk, D))
        part = torch.remainder(_exact_matmul(a2[..., sl], b_res[:, sl, :]), m)
        acc = part if acc is None else torch.remainder(acc + part, m)
    return acc.to(torch.int32).reshape((K,) + tuple(lead) + (b_res.shape[-1],))


def rns_matmul_res(profile, a_res: torch.Tensor,
                   b_res: torch.Tensor) -> torch.Tensor:
    """Per-digit-slice modular matmul (the plain reference)."""
    p = get_profile(profile)
    return modular_matmul(a_res, b_res, moduli_vec(p, 3, a_res.device),
                          p.lazy_chunk)


def _encode_operand(cfg: RnsDotConfig, x, bits: int, weight: bool = False):
    s = absmax_scale(x, bits)
    res = dispatch.convert(cfg.profile, x, s, bits=bits, backend=cfg.backend,
                           weight=weight)
    return res, s


def _unscale(y: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor):
    """y * (1.0 / (sx * sw)) in float32, with a true division (PyTorch's
    ``1.0 / tensor`` multiplies by a reciprocal)."""
    prod = sx * sw
    return y * (prod.new_ones(()) / prod)


def _fused_path(cfg: RnsDotConfig) -> bool:
    return (dispatch.fusion_active(cfg.profile, cfg.backend)
            and not cfg.slice_parallel)


def _rns_matmul_float(cfg: RnsDotConfig, x: torch.Tensor, w: torch.Tensor,
                      qa: int, qb: int, w_static: bool = True):
    """The float -> float RNS product x @ w, no autograd: the forward of
    :func:`rns_dot` and each product of its RNS backward.  ``w_static``:
    whether ``w`` is a model weight (its convert tallies a
    ``weight_converts``; the backward's weight gradient passes False for
    its cotangent operand)."""
    _check_capacity(cfg, x.shape[-1], qa, qb)
    if _fused_path(cfg):
        sx = absmax_scale(x, qa)
        b_res, sw = _encode_operand(cfg, w, qb, weight=w_static)
        y = dispatch.fused_dot(cfg.profile, x, sx, b_res, bits=qa,
                               backend=cfg.backend)
        return _unscale(y, sx, sw)
    a_res, sx = _encode_operand(cfg, x, qa)
    b_res, sw = _encode_operand(cfg, w, qb, weight=w_static)
    y_res = dispatch.matmul(cfg.profile, a_res, b_res, backend=cfg.backend)
    y = dispatch.normalize(cfg.profile, y_res, backend=cfg.backend)
    return _unscale(y, sx, sw)


class _RnsDot(torch.autograd.Function):
    """``rns_dot``'s straight-through gradients (JAX's ``_rns_dot_bwd``):
    ``gx = g @ w.T`` at (qg, qw) bits and ``gw = x.T @ g`` at (qx, qg)
    bits through RNS under ``backward_rns``, float matmuls otherwise."""

    @staticmethod
    def forward(ctx, x, w, cfg):
        ctx.cfg = cfg
        ctx.layout = sharding.snapshot()
        ctx.save_for_backward(x, w)
        return _rns_matmul_float(cfg, x, w, cfg.qx, cfg.qw)

    @staticmethod
    def backward(ctx, g):
        with sharding.restore(ctx.layout):
            return _RnsDot._backward(ctx, g)

    @staticmethod
    def _backward(ctx, g):
        x, w = ctx.saved_tensors
        cfg = ctx.cfg
        xf = x.reshape(-1, x.shape[-1])                     # [T, D]
        gf = g.reshape(-1, g.shape[-1])                     # [T, N]
        if cfg.backward_rns:
            gx = _rns_matmul_float(cfg, gf, w.T, cfg.qg, cfg.qw)
            gw = _rns_matmul_float(cfg, xf.T, gf, cfg.qx, cfg.qg,
                                   w_static=False)
        else:
            gx, gw = gf @ w.T, xf.T @ gf
        return gx.reshape(x.shape).to(x.dtype), gw.to(w.dtype), None


def rns_dot(x: torch.Tensor, w: torch.Tensor, cfg: RnsDotConfig):
    """y = x @ w through the RNS digit-sliced datapath: x [..., D] float32,
    w [D, N] float32.  Differentiable (straight-through quantizer, RNS
    backward products under ``cfg.backward_rns``)."""
    return _RnsDot.apply(x, w, cfg)


def rns_dot_fwd_only(x: torch.Tensor, w: torch.Tensor, cfg: RnsDotConfig):
    """The inference entry: :func:`rns_dot`'s forward, no autograd."""
    return _rns_matmul_float(cfg, x, w, cfg.qx, cfg.qw)


def _rns_multi_impl(cfg: RnsDotConfig, x: torch.Tensor, ws):
    """(x @ w for w in ws) with ONE shared forward conversion of x.  On a
    fused backend every weight's kernel quantizes x on the same grid, and
    ``shared_encode`` keeps the tally at one conversion."""
    _check_capacity(cfg, x.shape[-1], cfg.qx, cfg.qw)
    if _fused_path(cfg):
        sx = absmax_scale(x, cfg.qx)
        outs = []
        for i, w in enumerate(ws):
            b_res, sw = _encode_operand(cfg, w, cfg.qw, weight=True)
            y = dispatch.fused_dot(cfg.profile, x, sx, b_res, bits=cfg.qx,
                                   backend=cfg.backend, shared_encode=i > 0)
            outs.append(_unscale(y, sx, sw))
        return tuple(outs)
    a_res, sx = _encode_operand(cfg, x, cfg.qx)
    outs = []
    for w in ws:
        b_res, sw = _encode_operand(cfg, w, cfg.qw, weight=True)
        y_res = dispatch.matmul(cfg.profile, a_res, b_res,
                                backend=cfg.backend)
        y = dispatch.normalize(cfg.profile, y_res, backend=cfg.backend)
        outs.append(_unscale(y, sx, sw))
    return tuple(outs)


def _normalized(cfg: RnsDotConfig, a_res, b_res, sa, sb):
    y = dispatch.matmul(cfg.profile, a_res, b_res, backend=cfg.backend)
    return _unscale(dispatch.normalize(cfg.profile, y, backend=cfg.backend),
                    sa, sb)


class _RnsMulti(torch.autograd.Function):
    """``rns_multi_dot``'s straight-through gradients (JAX's
    ``_rns_multi_bwd``).  Under ``backward_rns`` the backward shares
    conversions as the forward does: ``x.T`` is encoded once for every
    weight's gradient and each cotangent once for its two products, on
    the primitives of the forward's backend (a fused backend's unfused
    kernels); ``gx`` sums the weights' terms in order from zeros."""

    @staticmethod
    def forward(ctx, cfg, x, *ws):
        ctx.cfg = cfg
        ctx.layout = sharding.snapshot()
        ctx.save_for_backward(x, *ws)
        return _rns_multi_impl(cfg, x, ws)

    @staticmethod
    def backward(ctx, *gs):
        with sharding.restore(ctx.layout):
            return _RnsMulti._backward(ctx, *gs)

    @staticmethod
    def _backward(ctx, *gs):
        x, *ws = ctx.saved_tensors
        cfg = ctx.cfg
        xf = x.reshape(-1, x.shape[-1])                     # [T, D]
        gx = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
        gws = []
        if cfg.backward_rns:
            _check_capacity(cfg, xf.shape[0], cfg.qx, cfg.qg)
            xt_res, sxt = _encode_operand(cfg, xf.T, cfg.qx)   # [K, D, T]
        for w, g in zip(ws, gs):
            gf = g.reshape(-1, g.shape[-1])                 # [T, N_i]
            if cfg.backward_rns:
                _check_capacity(cfg, gf.shape[-1], cfg.qg, cfg.qw)
                g_res, sg = _encode_operand(cfg, gf, cfg.qg)
                wt_res, sw = _encode_operand(cfg, w.T, cfg.qw, weight=True)
                gx_i = _normalized(cfg, g_res, wt_res, sg, sw)
                gw = _normalized(cfg, xt_res, g_res, sxt, sg)
            else:
                gx_i, gw = gf @ w.T, xf.T @ gf
            gx = gx + gx_i
            gws.append(gw.to(w.dtype))
        return (None, gx.reshape(x.shape).to(x.dtype), *gws)


def rns_multi_dot(x: torch.Tensor, ws: tuple, cfg: RnsDotConfig):
    """(x @ w for w in ws) with ONE shared forward conversion of x;
    differentiable as :func:`rns_dot`."""
    return _RnsMulti.apply(cfg, x, *ws)


# --------------------------------------------- resident-weight forwards ----
def _for_resident(cfg: RnsDotConfig, w_res) -> RnsDotConfig:
    """Align cfg.profile with the resident weight's profile."""
    if cfg.profile != w_res.profile:
        cfg = dataclasses.replace(cfg, profile=w_res.profile)
    return cfg


def rns_resident_dot(x: torch.Tensor, w_res, cfg: RnsDotConfig):
    """y = x @ w_res for a weight encoded once (an ``RnsTensor``): the
    arithmetic of :func:`rns_dot` (same grids, primitives and
    ``y * (1.0 / (sx * w.scale))``) without its weight conversion.  The
    exactness guard is the magnitude ledger."""
    from repro_torch.core.tensor import _encode_out_bits

    cfg = _for_resident(cfg, w_res)
    _encode_out_bits(get_profile(cfg.profile), cfg.qx, w_res, x.shape[-1])
    sx = absmax_scale(x, cfg.qx)
    if _fused_path(cfg):
        y = dispatch.fused_dot(cfg.profile, x, sx, w_res.digits, bits=cfg.qx,
                               backend=cfg.backend)
        return _unscale(y, sx, w_res.scale)
    a_res = dispatch.convert(cfg.profile, x, sx, bits=cfg.qx,
                             backend=cfg.backend)
    y_res = dispatch.matmul(cfg.profile, a_res, w_res.digits,
                            backend=cfg.backend)
    y = dispatch.normalize(cfg.profile, y_res, backend=cfg.backend)
    return _unscale(y, sx, w_res.scale)


def rns_resident_multi_dot(x: torch.Tensor, ws_res: tuple,
                           cfg: RnsDotConfig):
    """(x @ w for w in ws_res) with one shared conversion of x: the
    resident mirror of :func:`rns_multi_dot`."""
    from repro_torch.core.tensor import _encode_out_bits

    cfg = _for_resident(cfg, ws_res[0])
    p = get_profile(cfg.profile)
    for w_res in ws_res:
        if w_res.profile != cfg.profile:
            raise ValueError("resident fan-out weights must share a profile "
                             "(one shared conversion of x feeds them all)")
        _encode_out_bits(p, cfg.qx, w_res, x.shape[-1])
    sx = absmax_scale(x, cfg.qx)
    if _fused_path(cfg):
        return tuple(
            _unscale(dispatch.fused_dot(cfg.profile, x, sx, w_res.digits,
                                        bits=cfg.qx, backend=cfg.backend,
                                        shared_encode=i > 0),
                     sx, w_res.scale)
            for i, w_res in enumerate(ws_res))
    a_res = dispatch.convert(cfg.profile, x, sx, bits=cfg.qx,
                             backend=cfg.backend)
    outs = []
    for w_res in ws_res:
        y_res = dispatch.matmul(cfg.profile, a_res, w_res.digits,
                                backend=cfg.backend)
        y = dispatch.normalize(cfg.profile, y_res, backend=cfg.backend)
        outs.append(_unscale(y, sx, w_res.scale))
    return tuple(outs)
