"""Digit-sliced RNS matmul with one normalization per output -- the core.

  float x --quantize--> int --convert--> residues [K, ..., D]
  float w --quantize--> int --convert--> residues [K, D, N]
      per-slice matmul, lazy modular reduction
  residues [K, ..., N] --MRC normalize--> float y

Serving is forward-only, so ``rns_dot``/``rns_multi_dot`` and the
resident dots here are the forward of ``repro.core.rns_matmul``'s (the
custom_vjp comes with the training slice).  On a fused backend each
projection is one fused kernel (``dispatch.fused_dot``).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import dispatch
from repro_torch.core.moduli import get_profile
from repro_torch.core.quantize import absmax_scale
from repro_torch.core.rns import moduli_vec

__all__ = ["RnsDotConfig", "modular_matmul", "rns_matmul_res", "rns_dot",
           "rns_multi_dot", "rns_resident_dot", "rns_resident_multi_dot"]


@dataclasses.dataclass(frozen=True)
class RnsDotConfig:
    profile: str = "rns9"
    qx: int = 16            # activation fixed-point bits
    qw: int = 16            # weight fixed-point bits
    # "auto" (None) | "reference" | "cuda" | "cuda_fused" -- see
    # core/dispatch.py
    backend: str | None = None
    # residue-domain chaining: the MLP block runs wi -> gate multiply ->
    # wo in residues with one main-path normalize (models/layers.py)
    defer: bool = False


def _check_capacity(cfg: RnsDotConfig, contract_dim: int, qa: int, qb: int):
    p = get_profile(cfg.profile)
    cap = p.dot_capacity(qa, qb)
    if contract_dim > cap:
        raise ValueError(
            f"RNS profile {p.name} ({p.range_bits:.1f} bits) cannot hold an "
            f"exact {contract_dim}-term {qa}x{qb}-bit dot product "
            f"(capacity {cap}); use a wider profile or fewer bits")


def _exact_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Integer product-sum of residues through a float64 matmul.

    Exact: every partial sum is an integer below chunk * (m-1)**2 < 2**31,
    far inside float64's 2**53 of exact integers.  (CUDA PyTorch has no
    integer matmul; float64 keeps this on the operand's device.)
    """
    return torch.matmul(a.to(torch.float64), b.to(torch.float64)).to(
        torch.int64)


def modular_matmul(a_res: torch.Tensor, b_res: torch.Tensor,
                   mvec: torch.Tensor, chunk: int) -> torch.Tensor:
    """Digit-batched matmul with a modular reduction every ``chunk`` terms.

    ``a_res`` [K, ..., M, D], ``b_res`` [K, D, N]; ``mvec`` moduli shaped
    (K, 1, ..., 1); ``chunk`` = ``profile.lazy_chunk``.
    """
    K, D = a_res.shape[0], a_res.shape[-1]
    lead = a_res.shape[1:-1]
    a2 = a_res.reshape(K, -1, D)
    m = mvec.reshape(K, 1, 1).to(torch.int64)
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
    return dispatch.fusion_active(cfg.profile, cfg.backend)


def rns_dot(x: torch.Tensor, w: torch.Tensor, cfg: RnsDotConfig):
    """y = x @ w through the RNS digit-sliced datapath (forward)."""
    _check_capacity(cfg, x.shape[-1], cfg.qx, cfg.qw)
    if _fused_path(cfg):
        sx = absmax_scale(x, cfg.qx)
        b_res, sw = _encode_operand(cfg, w, cfg.qw, weight=True)
        y = dispatch.fused_dot(cfg.profile, x, sx, b_res, bits=cfg.qx,
                               backend=cfg.backend)
        return _unscale(y, sx, sw)
    a_res, sx = _encode_operand(cfg, x, cfg.qx)
    b_res, sw = _encode_operand(cfg, w, cfg.qw, weight=True)
    y_res = dispatch.matmul(cfg.profile, a_res, b_res, backend=cfg.backend)
    y = dispatch.normalize(cfg.profile, y_res, backend=cfg.backend)
    return _unscale(y, sx, sw)


def rns_multi_dot(x: torch.Tensor, ws: tuple, cfg: RnsDotConfig):
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
