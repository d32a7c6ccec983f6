"""Resident residue-domain weights: encode once at build time, serve on.

:func:`encode_resident` walks a model, finds every RNS-target MLP
(``wi``/``wg``/``wo``) and keeps each weight encoded once on its module
(``MLP.set_resident``), next to the float master; ``models/layers.mlp``
then takes the resident paths, with zero weight conversions per step.
Each weight gets its own absmax grid, the scale the re-encode path
computes for it, so serving stays token-identical.

**Per-layer moduli profiles** (``per_layer_profiles=True``): the
quantized weights' maximum column abs-sums bound each product summation
tightly (``|sum_d q_x[d] q_w[d, j]| <= 2**(qx-1) * max_j sum_d
|q_w[d, j]|``), and the MLP chain's bound picks the narrowest registered
profile that still holds it (``core/moduli.narrowest_profile``).  The
bound enters the ledger as the resident ``mag_bits`` amortized over the
contraction, ``log2(colsum) - log2(D)``, so ``a.mag + w.mag + log2(D)``
gives back ``(qx-1) + log2(colsum)``.  The JAX package stacks the layers
of one period slot (``i % period``) as one ``[P, d, n]`` master and
selects once for the stack, the worst case over its layers; the port
keeps one block a layer and gives every block of a slot the slot's
profile and ``mag_bits``.

The port of ``repro.models.resident`` without masters dropped, the
traced train-step attach or a digit mesh (later slices).
"""

from __future__ import annotations

import math

import torch

from repro_torch.core import dispatch
from repro_torch.core.moduli import get_profile, narrowest_profile
from repro_torch.core.quantize import absmax_scale, quantize_with_scale
from repro_torch.core.tensor import _SAFETY_BITS, RnsTensor
from repro_torch.models.layers import MLP

__all__ = ["encode_resident", "has_resident", "resident_profiles"]


def _encode_one(w: torch.Tensor, profile: str, qw: int, mag_bits: float,
                backend: str | None) -> RnsTensor:
    """Encode one master weight [d, n] on its own absmax grid, through
    ``backend``'s convert (on the card: the convert kernel, bit-equal to
    the plain version)."""
    p = get_profile(profile)
    wf = w.detach().to(torch.float32)
    s = absmax_scale(wf, qw)
    digits = dispatch.convert(p, wf, s, bits=qw, backend=backend,
                              weight=True)
    return RnsTensor(digits, s, p.name, float(mag_bits))


def _mlps(model):
    return [(name, m) for name, m in model.named_modules()
            if isinstance(m, MLP)]


def _colsum_bits(ws, qw: int) -> float:
    """log2 of the largest column abs-sum of the ``qw``-bit quantized
    weights ``ws`` (one slot's layers, each on its own absmax grid): the
    tight bound on one activation row's product summation."""
    col = 0
    for w in ws:
        wf = w.detach().to(torch.float32)
        q = quantize_with_scale(wf, absmax_scale(wf, qw), qw)
        col = max(col, int(q.abs().sum(dim=-2, dtype=torch.int64).max()))
    return math.log2(max(col, 1))


def _select_profile(mlps, rns, gated: bool):
    """The narrowest registered profile covering one slot's deferred
    chain, and each weight's amortized ledger bound.

    Gated chain worst case (defer on, which dominates the per-op path):
    encode(x) -> qx-1; @ wi -> + cb_wi; * encode(gate) -> + (qx-1);
    @ wo -> + cb_wo; the decoded gate branch needs (qx-1) + cb_wg on its
    own; ``cb_* = log2(max colsum of the quantized weight)``.
    """
    names = [n for n in MLP.NAMES if getattr(mlps[0], n) is not None]
    cb = {n: _colsum_bits([getattr(m, n) for m in mlps], rns.qw)
          for n in names}
    x_bits = float(rns.qx - 1)
    if gated and "wg" in cb:
        chain = x_bits + cb["wi"] + x_bits + cb["wo"]
        need = max(chain, x_bits + cb["wg"])
    else:
        need = max(x_bits + cb["wi"], x_bits + cb["wo"])
    prof = narrowest_profile(need + _SAFETY_BITS, cap=rns.profile)
    mags = {n: cb[n] - math.log2(max(getattr(mlps[0], n).shape[-2], 1))
            for n in cb}
    return prof.name, mags


def encode_resident(model, cfg, *, per_layer_profiles: bool = False):
    """Encode every RNS-target MLP weight of ``model`` once, in place, on
    the weights' device; returns ``model``.  Biased MLPs keep the float
    per-op path.  ``per_layer_profiles`` selects each period slot's
    profile from its weights (never wider than ``cfg.rns.profile``)."""
    if cfg.rns is None or cfg.rns_targets not in ("all", "mlp"):
        return model
    rns = cfg.rns
    mlps = [m for _, m in _mlps(model) if not m.has_bias()]
    period = cfg.period if per_layer_profiles else 1
    for slot in range(period):
        members = mlps[slot::period]
        if not members:
            continue
        if per_layer_profiles:
            prof, mags = _select_profile(members, rns,
                                         members[0].wg is not None)
        else:
            prof = rns.profile
            mags = {n: float(rns.qw - 1) for n in MLP.NAMES}
        for mlp in members:
            for name in MLP.NAMES:
                w = getattr(mlp, name)
                if w is not None:
                    mlp.set_resident(name, _encode_one(
                        w, prof, rns.qw, mags[name], rns.backend))
    return model


def has_resident(model) -> bool:
    return any(m.resident(n) is not None for _, m in _mlps(model)
               for n in MLP.NAMES)


def resident_profiles(model) -> dict:
    """{module path: profile name} for every resident MLP, one entry a
    layer (wi, wg and wo share their MLP's profile)."""
    return {path: m.resident("wi").profile for path, m in _mlps(model)
            if m.resident("wi") is not None}
