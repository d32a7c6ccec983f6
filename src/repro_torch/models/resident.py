"""Resident residue-domain weights: encode once at build time, serve on.

:func:`encode_resident` walks a model, finds every RNS-target MLP
(``wi``/``wg``/``wo``) and keeps each weight encoded once on its module
(``MLP.set_resident``), next to the float master; ``models/layers.mlp``
then takes the resident paths, with zero weight conversions per step.
Each weight gets its own absmax grid, the scale the re-encode path
computes for it, so serving stays token-identical.  The port of
``repro.models.resident`` without per-layer profiles, masters dropped or
a digit mesh (later slices).
"""

from __future__ import annotations

import torch

from repro_torch.core import dispatch
from repro_torch.core.moduli import get_profile
from repro_torch.core.quantize import absmax_scale
from repro_torch.core.tensor import RnsTensor
from repro_torch.models.layers import MLP

__all__ = ["encode_resident", "has_resident", "resident_profiles"]


def _is_mlp(module) -> bool:
    return isinstance(module, MLP)


def _mlp_has_bias(mlp: MLP) -> bool:
    return mlp.has_bias()


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
    return [(name, m) for name, m in model.named_modules() if _is_mlp(m)]


def encode_resident(model, cfg):
    """Encode every RNS-target MLP weight of ``model`` once, in place, on
    the weights' device; returns ``model``.  Biased MLPs keep the float
    per-op path."""
    if cfg.rns is None or cfg.rns_targets not in ("all", "mlp"):
        return model
    rns = cfg.rns
    for _, mlp in _mlps(model):
        if _mlp_has_bias(mlp):
            continue
        for name in MLP.NAMES:
            w = getattr(mlp, name)
            if w is not None:
                mlp.set_resident(name, _encode_one(
                    w, rns.profile, rns.qw, float(rns.qw - 1), rns.backend))
    return model


def has_resident(model) -> bool:
    return any(m.resident(n) is not None for _, m in _mlps(model)
               for n in MLP.NAMES)


def resident_profiles(model) -> dict:
    """{module path: profile name} for every resident MLP (wi, wg and wo
    share their MLP's profile)."""
    return {path: m.resident("wi").profile for path, m in _mlps(model)
            if m.resident("wi") is not None}
