"""Public model API of the slice: init, the bucketed engine's prefill
into a dense cache, ragged prefill, decode over a dense or a paged cache,
the speculative-verify window and the packed mixed-phase step."""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from repro_torch.core.quantize import token_mask
from repro_torch.models import transformer as tf
from repro_torch.models.layers import RMSNorm, _param, embed, unembed

__all__ = ["Model", "init_model", "DenseKV", "make_cache",
           "set_cache_lengths", "prefill", "prefill_ragged", "decode_step",
           "decode_window", "mixed_step"]


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


@dataclasses.dataclass
class DenseKV:
    """The bucketed engine's decode cache: every attention layer's K/V
    ``[n_layers, B, S_max, Hk, D]`` and the rows' ``lengths`` [B]."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor       # [B] int64


def make_cache(cfg, B: int, S_max: int, *, dtype=torch.float32,
               device="cuda") -> DenseKV:
    """Zero dense decode cache, lengths 0 (attention layers: the only
    layer type of this slice's family)."""
    shape = (cfg.n_layers, B, S_max, cfg.n_kv_heads, cfg.d_head)
    return DenseKV(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   lengths=torch.zeros((B,), dtype=torch.int64,
                                       device=device))


def set_cache_lengths(cache, lengths):
    """Overwrite the rows' lengths of a dense or paged cache, in place;
    returns ``cache``."""
    cache.lengths.copy_(torch.as_tensor(lengths, dtype=cache.lengths.dtype))
    return cache


@torch.inference_mode()
def prefill(model: Model, cfg, tokens: torch.Tensor, S_max: int, *,
            cache_dtype=torch.float32, cache: DenseKV | None = None):
    """Run equal-length prompts ``tokens`` [B, T] and fill a dense decode
    cache.  Returns (logits at the last prompt token [B, V], cache).

    ``cache``: a dense cache of B rows and ``S_max`` positions to fill in
    place (its positions past T keep what they held; ``lengths`` masks
    them), else a new one.  On the RNS path every prompt token quantizes
    on its own grid (an all-ones per-token :class:`token_mask`): the grid
    :func:`prefill_ragged` and :func:`mixed_step` give it too.
    """
    B, T = tokens.shape
    if T > S_max:
        raise ValueError(f"prompt length {T} > cache capacity {S_max}")
    mask = (torch.ones((B, T), dtype=torch.bool, device=tokens.device)
            if cfg.rns is not None else None)
    with token_mask(mask, per_token=True):
        h = embed(model.embed, tokens)
        h, ys = tf.apply_blocks(model.blocks, h, cfg, mode="prefill")
        logits = _logits(model, h[:, -1:])[:, 0]
    if cache is None:
        cache = make_cache(cfg, B, S_max, dtype=cache_dtype,
                           device=tokens.device)
    cache.k[:, :, :T] = torch.stack([k for k, _ in ys]).to(cache.k.dtype)
    cache.v[:, :, :T] = torch.stack([v for _, v in ys]).to(cache.v.dtype)
    cache.lengths.fill_(T)
    return logits, cache


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
    """token [B, 1] -> logits [B, V]; writes the token's KV into ``cache``
    (paged, or the bucketed engine's :class:`DenseKV`) and advances the
    lengths of ``active`` rows, in place.

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
def decode_window(model: Model, cfg, tokens: torch.Tensor, cache,
                  active=None):
    """Speculative-verify window: tokens [R, W] -> logits [R, W, V].

    Row r's window is [last token, draft 1, ..., draft W-1]; all W
    tokens' KV is written into the paged ``cache`` (in place) at
    positions ``lengths .. lengths + W - 1`` and ``logits[:, i]`` is the
    next-token distribution after window position i -- what W
    consecutive :func:`decode_step` calls would give, so a greedy accept
    over them keeps the stream that of plain decoding.  ``lengths`` is
    not advanced: the caller adds ``accepted + 1`` once it knows them.

    On the RNS path the token mask is per token: each window position
    quantizes on its own (row, token) grid, the grid of its solo decode
    step.
    """
    R, W = tokens.shape
    mask = None
    if active is not None and cfg.rns is not None:
        mask = active[:, None].expand(R, W)
    with token_mask(mask, per_token=True):
        h = embed(model.embed, tokens)
        h, _ = tf.apply_blocks(model.blocks, h, cfg, mode="decode",
                               cache=cache)
        return _logits(model, h)


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
