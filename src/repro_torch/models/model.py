"""Public model API of the slice: init, the bucketed engine's prefill
into a dense cache, ragged prefill, decode over a dense or a paged cache,
the speculative-verify window and the packed mixed-phase step."""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch.core.quantize import token_mask
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (RMSNorm, _param, embed, init_normal_,
                                       linear, unembed)

__all__ = ["Model", "init_model", "DenseKV", "make_cache", "plane_shapes",
           "stack_planes", "set_cache_lengths", "prefill", "prefill_ragged",
           "decode_step", "decode_window", "mixed_step"]

#: the cache planes of each layer type, in the order its prefill returns
#: them (``transformer.apply_blocks``)
PLANES = {"attn": ("k", "v"), "mla": ("c_kv", "k_rope")}


def _check_supported(cfg):
    """The port has the causal, rmsnorm, decoder-only model with GQA or
    MLA attention, dense or MoE MLPs, tied or untied head (smollm-135m,
    deepseek-v2-236b, llama4-scout-17b-a16e); the rest are later
    slices."""
    later = []
    if cfg.norm != "rmsnorm":
        later.append(f"norm={cfg.norm!r}")
    if not cfg.causal:
        later.append("non-causal attention")
    if cfg.enc_dec:
        later.append("enc_dec")
    if cfg.frontend is not None:
        later.append(f"frontend={cfg.frontend!r}")
    bad = sorted(set(cfg.layer_types) - set(PLANES))
    if bad:
        later.append(f"layer types {bad} (SSM / hybrid)")
    bad = sorted(set(cfg.mlp_types) - {"dense", "moe"})
    if bad:
        later.append(f"MLP types {bad}")
    if later:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(later)} come with later slices of "
            "the port (ROADMAP A)")


class Model(nn.Module):
    """Decoder-only LM: embedding, ``n_layers`` blocks, final norm and
    the head: the embedding transposed (tied) or ``lm_head`` [d, V]."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg
        self.embed = _param(torch.empty(cfg.vocab, cfg.d_model, device=device))
        self.blocks = nn.ModuleList(
            tf.Block(cfg, lt, mt, device)
            for lt, mt in zip(cfg.layer_types, cfg.mlp_types))
        self.final_norm = RMSNorm(cfg.d_model, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        _param(torch.empty(cfg.d_model, cfg.vocab,
                                           device=device)))


def init_model(cfg, seed: int = 0, device="cuda") -> Model:
    """Random weights from ``seed`` with the JAX package's scales:
    embedding N(0, 0.02), projections and expert stacks N(0, 1/d_in),
    norms one.  The generator lives on ``device`` (on the card, the full
    model is drawn there); the same seed on another device gives other
    numbers."""
    model = Model(cfg, device)
    g = torch.Generator(device=device).manual_seed(seed)
    with torch.no_grad():
        model.embed.normal_(0.0, 0.02, generator=g)     # drawn first
    init_normal_(model, g, skip=("embed",))
    return model


def _logits(model: Model, h):
    h = model.final_norm(h)
    if model.lm_head is None:
        return unembed(model.embed, h)
    return linear(model.lm_head, h)


@dataclasses.dataclass
class DenseKV:
    """The bucketed engine's decode cache: the GQA layers' K/V ``[n_attn,
    B, S_max, Hk, D]``, the MLA layers' latents ``c_kv`` [n_mla, B,
    S_max, r] and ``k_rope`` [n_mla, B, S_max, dr] (None where the model
    has no such layer) and the rows' ``lengths`` [B]."""

    k: torch.Tensor | None
    v: torch.Tensor | None
    lengths: torch.Tensor       # [B] int64
    c_kv: torch.Tensor | None = None
    k_rope: torch.Tensor | None = None


def plane_shapes(cfg) -> dict[str, tuple[int, tuple[int, ...]]]:
    """{plane name: (layers of its type, one token's shape)} for the
    layer types ``cfg`` has (JAX's ``_layer_cache_shape``)."""
    feat = {"k": (cfg.n_kv_heads, cfg.d_head),
            "v": (cfg.n_kv_heads, cfg.d_head)}
    if cfg.mla is not None:
        feat["c_kv"] = (cfg.mla.kv_lora_rank,)
        feat["k_rope"] = (cfg.mla.qk_rope_dim,)
    out = {}
    for lt, names in PLANES.items():
        n = cfg.layer_types.count(lt)
        if n:
            out.update({name: (n, feat[name]) for name in names})
    return out


def stack_planes(cfg, ys) -> dict[str, torch.Tensor]:
    """Prefill's per-layer planes (``apply_blocks``' ``ys``) stacked per
    name: {"k": [n_attn, B, T, Hk, D], "c_kv": [n_mla, B, T, r], ...}."""
    out = {}
    for lt, names in PLANES.items():
        idx = [i for i, t in enumerate(cfg.layer_types) if t == lt]
        for j, name in enumerate(names if idx else ()):
            out[name] = torch.stack([ys[i][j] for i in idx])
    return out


def make_cache(cfg, B: int, S_max: int, *, dtype=torch.float32,
               device="cuda") -> DenseKV:
    """Zero dense decode cache, lengths 0: the planes of every layer
    type the model has."""
    planes = {name: torch.zeros((n, B, S_max) + feat, dtype=dtype,
                                device=device)
              for name, (n, feat) in plane_shapes(cfg).items()}
    return DenseKV(k=planes.pop("k", None), v=planes.pop("v", None),
                   lengths=torch.zeros((B,), dtype=torch.int64,
                                       device=device), **planes)


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
    for name, planes in stack_planes(cfg, ys).items():
        dst = getattr(cache, name)
        dst[:, :, :T] = planes.to(dst.dtype)
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
