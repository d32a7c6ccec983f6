"""Public model API of the slice: init, ragged prefill, paged decode and
the packed mixed-phase step."""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.core.quantize import token_mask
from repro_torch.models import transformer as tf
from repro_torch.models.layers import RMSNorm, _param, embed, unembed

__all__ = ["Model", "init_model", "prefill_ragged", "decode_step",
           "mixed_step"]


def _check_supported(cfg):
    if cfg.norm != "rmsnorm" or not cfg.tie_embeddings or not cfg.causal:
        raise NotImplementedError(
            f"{cfg.arch_id}: this slice ports the causal, rmsnorm, tied-"
            "embedding decoder (smollm-135m); other families are later slices")


class Model(nn.Module):
    """Decoder-only LM: tied embedding, ``n_layers`` blocks, final norm."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = _param(torch.empty(cfg.vocab, cfg.d_model, device=device))
        self.blocks = nn.ModuleList(
            tf.Block(cfg, device) for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg.d_model, device)


def init_model(cfg, seed: int = 0, device="cuda") -> Model:
    """Random weights from ``seed`` with the JAX package's scales:
    embedding N(0, 0.02), projections N(0, 1/d_in), norms one.  The
    generator lives on ``device`` (on the card, the full model is drawn
    there); the same seed on another device gives other numbers."""
    model = Model(cfg, device)
    g = torch.Generator(device=device).manual_seed(seed)
    for name, p in model.named_parameters():
        if name.endswith("scale"):
            continue                        # norms stay at one
        std = 0.02 if name == "embed" else 1.0 / math.sqrt(p.shape[0])
        p.normal_(0.0, std, generator=g)
    return model


def _logits(model: Model, h):
    return unembed(model.embed, model.final_norm(h))


@torch.inference_mode()
def prefill_ragged(model: Model, cfg, tokens: torch.Tensor,
                   lengths: torch.Tensor):
    """Mixed-length prefill: tokens [B, Tpad] right-padded, per-row
    ``lengths`` [B].  Returns (logits at each row's last prompt token
    [B, V], per-layer (k, v) planes [B, Tpad, Hk, D]).

    On the RNS path every prompt token quantizes on its own (row, token)
    absmax grid (a per-token :class:`token_mask`), invariant to padding.
    """
    B, Tpad = tokens.shape
    valid = torch.arange(Tpad, device=tokens.device)[None, :] < lengths[:, None]
    with token_mask(valid if cfg.rns is not None else None, per_token=True):
        h = embed(model.embed, tokens)
        h, ys = tf.apply_blocks(model.blocks, h, cfg, mode="prefill")
        h_last = h[torch.arange(B, device=h.device), lengths - 1][:, None]
        return _logits(model, h_last)[:, 0], ys


@torch.inference_mode()
def decode_step(model: Model, cfg, token: torch.Tensor, cache, active=None):
    """token [B, 1] -> logits [B, V]; writes the token's KV into the paged
    ``cache`` and advances the lengths of ``active`` rows, in place.

    On the RNS path ``active`` is the per-row quantization mask, so each
    row's grid is its own (a batched step is bit-identical per row to a
    solo one).
    """
    mask = active[:, None] if (active is not None
                               and cfg.rns is not None) else None
    with token_mask(mask):
        h = embed(model.embed, token)
        h, _ = tf.apply_blocks(model.blocks, h, cfg, mode="decode",
                               cache=cache)
        logits = _logits(model, h)[:, 0]
    step = 1 if active is None else active.to(cache.lengths.dtype)
    cache.lengths += step
    return logits


@torch.inference_mode()
def mixed_step(model: Model, cfg, tokens, seg, pos, dec, valid, cache):
    """ONE packed chunked-prefill + decode step (paged cache, in place).

    ``tokens``/``seg``/``pos`` [N] int64, ``dec``/``valid`` [N] bool:
    lane i carries the token of row ``seg[i]`` at absolute position
    ``pos[i]`` -- a decode row's next token (``dec``) or one token of a
    prefill chunk.  Pad lanes (``~valid``) carry ``seg = -1``: their KV
    lands on the trash page and their logits are garbage the engine
    drops.  N is the engine's fixed ``token_budget``, so one program
    serves every prefill/decode mix.

    Returns logits [N, V]: ``logits[i]`` is the next-token distribution
    after lane i.  Cache ``lengths`` are not advanced; the engine owns
    them on the host and pushes fresh tables before every step.

    On the RNS path every lane quantizes on its own (lane) grid
    (``token_mask(valid[None], per_token=True)``), so a chunk's
    quantization does not depend on how the prompt is split.
    """
    mask = valid[None] if cfg.rns is not None else None
    with token_mask(mask, per_token=True):
        h = embed(model.embed, tokens[None])
        h, _ = tf.apply_blocks(model.blocks, h, cfg, mode="decode",
                               cache=cache, packed=(seg, pos, dec))
        return _logits(model, h)[0]
