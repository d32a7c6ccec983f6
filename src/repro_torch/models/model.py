"""Public model API of the slice: init, parameter counts, the training
forward and loss, the bucketed engine's prefill into a dense cache (with
the recurrent layers' states and an encoder-decoder's cross planes; a
frontend's embeddings ahead of the prompt or through the encoder),
ragged prefill, decode over a dense or a paged cache, the
speculative-verify window and the packed mixed-phase step."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from repro_torch.core.quantize import token_mask
from repro_torch.models import transformer as tf
from repro_torch.models.layers import (_param, embed, init_normal_, linear,
                                       norm, sinusoidal_positions, unembed)

__all__ = ["Model", "init_model", "count_params", "count_params_analytic",
           "forward_train", "loss_fn", "loss_denominator",
           "DenseKV", "make_cache", "plane_shapes", "stack_planes",
           "set_cache_lengths", "prefill", "prefill_ragged", "decode_step",
           "decode_window", "mixed_step"]

#: the cache planes of each layer type, in the order its prefill returns
#: them (``transformer.apply_blocks``, nested tuples flattened)
PLANES = {"attn": ("k", "v"), "mla": ("c_kv", "k_rope"),
          "mamba": ("h", "conv"), "rwkv": ("S", "x_tm", "x_cm")}
#: the recurrent layers' planes: one state a row, no sequence axis
STATE_PLANES = frozenset({"h", "conv", "S", "x_tm", "x_cm"})
#: an encoder-decoder model's cross planes (its attention layers' k and
#: v of the encoder's output): ``Te`` frames a row, not ``S_max``
CROSS_PLANES = ("xk", "xv")


def _check_supported(cfg):
    """Every config of the port builds; an unknown MLP type does not."""
    bad = sorted(set(cfg.mlp_types) - {"dense", "moe", "channelmix"})
    if bad:
        raise ValueError(f"{cfg.arch_id}: unknown MLP types {bad}")


class Model(nn.Module):
    """The LM: embedding, ``n_layers`` decoder blocks, final norm and the
    head: the embedding transposed (tied) or ``lm_head`` [d, V].  An
    encoder-decoder model also has ``enc_blocks`` (``n_enc_layers``
    encoder layers) and ``enc_norm``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        _check_supported(cfg)
        if cfg.param_dtype != "float32":
            raise NotImplementedError(
                f"param_dtype={cfg.param_dtype!r}: the port holds float32 "
                "parameters")
        self.cfg = cfg
        self.embed = _param(torch.empty(cfg.vocab, cfg.d_model, device=device))
        self.blocks = nn.ModuleList(
            tf.Block(cfg, lt, mt, device)
            for lt, mt in zip(cfg.layer_types, cfg.mlp_types))
        self.final_norm = norm(cfg.norm, cfg.d_model, device)
        self.lm_head = (None if cfg.tie_embeddings else
                        _param(torch.empty(cfg.d_model, cfg.vocab,
                                           device=device)))
        self.enc_blocks = self.enc_norm = None
        if cfg.enc_dec:
            self.enc_blocks = nn.ModuleList(
                tf.Block(cfg, "attn", "__enc__", device)
                for _ in range(cfg.n_enc_layers))
            self.enc_norm = norm(cfg.norm, cfg.d_model, device)


def init_model(cfg, seed: int = 0, device="cuda") -> Model:
    """Random weights from ``seed`` with the JAX package's scales:
    embedding N(0, 0.02), projections and expert stacks N(0, 1/d_in),
    norms one (and zero), biases zero; a Mamba or RWKV-6 layer draws its
    own (``init_``: conv taps, decays, mixes, ...).  The generator lives
    on ``device`` (on the card, the full model is drawn there); the same
    seed on another device gives other numbers."""
    model = Model(cfg, device)
    g = torch.Generator(device=device).manual_seed(seed)
    own = [(name, m) for name, m in model.named_modules()
           if hasattr(m, "init_")]
    skip = {"embed"} | {f"{name}.{p}" for name, m in own
                        for p, _ in m.named_parameters()}
    with torch.no_grad():
        model.embed.normal_(0.0, 0.02, generator=g)     # drawn first
    init_normal_(model, g, skip=skip)
    for _, m in own:
        m.init_(g)
    return model


def count_params(cfg) -> tuple[int, int]:
    """(total, active) parameter counts, as JAX's ``count_params``: the
    model is built on the ``meta`` device (no memory), and a parameter
    counts as routed when its path has ``moe`` and ``wi``/``wg``/``wo``
    (the shared experts too, as in JAX); active keeps ``top_k /
    n_experts`` of the routed ones."""
    model = Model(cfg, device="meta")
    total = routed = 0
    for name, p in model.named_parameters():
        total += p.numel()
        keys = name.split(".")
        if "moe" in keys and any(k in ("wi", "wg", "wo") for k in keys):
            routed += p.numel()
    active = total
    if cfg.moe is not None and routed:
        frac = cfg.moe.top_k / cfg.moe.n_experts
        active = total - routed + int(routed * frac)
    return total, active


def count_params_analytic(cfg, active_only: bool = False) -> int:
    total, active = count_params(cfg)
    return active if active_only else total


def _logits(model: Model, h):
    h = model.final_norm(h)
    if model.lm_head is None:
        return unembed(model.embed, h)
    return linear(model.lm_head, h)


def _embed_tokens(model: Model, cfg, tokens):
    """The tokens' embeddings, times ``sqrt(d_model)`` rounded to float32
    under ``cfg.emb_scale`` (gemma)."""
    h = embed(model.embed, tokens)
    if cfg.emb_scale:
        h = h * float(np.float32(np.sqrt(cfg.d_model)))
    return h


def _add_abs_pos(cfg, h):
    """``h`` [B, T, d] plus the sinusoidal rows 0 .. T-1 (sinusoidal
    positions only)."""
    if cfg.pos_emb != "sinusoidal":
        return h
    return h + sinusoidal_positions(h.shape[1], cfg.d_model,
                                    h.device).to(h.dtype)[None]


def _add_pos_at(cfg, h, pos, cache):
    """``h`` [R, W, d] plus the sinusoidal rows at ``pos`` [R, W], from a
    table of as many rows as a row of the dense or paged ``cache`` holds
    (built once per device)."""
    if cfg.pos_emb != "sinusoidal":
        return h
    if hasattr(cache, "block_table"):
        capacity = cache.block_table.shape[-1] * cache.k_pages.shape[2]
    else:
        capacity = cache.k.shape[2]
    table = sinusoidal_positions(capacity, cfg.d_model, h.device)
    return h + table[pos].to(h.dtype)


def _row_grids(cfg, x):
    """A per-row quantization mask for ``x`` [B, T, ...] on the RNS path
    (one grid a row over all its positions), else none."""
    if cfg.rns is None:
        return token_mask(None)
    return token_mask(torch.ones(x.shape[:2], dtype=torch.bool,
                                 device=x.device))


def _encode(model: Model, cfg, frames, *, train: bool = False):
    """The encoder over the frontend's frames [B, Te, d]: sinusoidal
    positions, ``enc_blocks``, ``enc_norm``.  Its attention follows
    ``cfg.causal``, as JAX's does (``enc_causal`` is never read, ROADMAP
    C.15).  Serving (``train=False``): on the RNS path every conversion
    of the encoder's stream takes one grid a row over all its frames
    (C.11).  ``train``: the stack in train mode with no token mask, so
    every conversion takes one grid over the whole [B, Te, d] tensor, as
    JAX's ``forward_train``."""
    if train:
        h = _add_abs_pos(cfg, frames)
        h, _ = tf.apply_blocks(model.enc_blocks, h, cfg, mode="train",
                               enc=True)
        return model.enc_norm(h)
    with _row_grids(cfg, frames):
        h = _add_abs_pos(cfg, frames)
        h, _ = tf.apply_blocks(model.enc_blocks, h, cfg, mode="prefill",
                               enc=True)
        return model.enc_norm(h)


def _frontend_len(cfg, batch: dict) -> int:
    """The frontend positions ahead of a decoder-only model's tokens:
    ``batch["frontend"]``'s length, else 0 (an encoder-decoder model's
    frames go through its encoder)."""
    if cfg.frontend is None or cfg.enc_dec or "frontend" not in batch:
        return 0
    return batch["frontend"].shape[1]


def forward_train(model: Model, cfg, batch: dict):
    """The training forward: ``batch["tokens"]`` [B, T] (and
    ``batch["frontend"]`` [B, F, d], the stub embeddings of an audio or
    vision model) -> (logits [B, F + T, V], the layers' summed MoE aux
    loss, a float32 scalar).  An encoder-decoder model runs its encoder
    over the frontend and cross-attends to its output; a frontend model
    puts the embeddings ahead of the tokens'.  No cache and no token
    mask, so every RNS conversion takes one absmax grid over its whole
    tensor, as JAX's ``forward_train``."""
    tokens = batch["tokens"]
    h = _embed_tokens(model, cfg, tokens.long())
    enc_out = None
    if cfg.enc_dec:
        if "frontend" not in batch:
            raise ValueError(f"{cfg.arch_id}: an encoder-decoder batch "
                             "needs its frontend frames")
        enc_out = _encode(model, cfg, batch["frontend"].to(h.dtype),
                          train=True)
    elif _frontend_len(cfg, batch):
        h = torch.cat([batch["frontend"].to(h.dtype), h], dim=1)
    h = _add_abs_pos(cfg, h)
    h, aux = tf.apply_blocks(model.blocks, h, cfg, mode="train",
                             enc_out=enc_out)
    return _logits(model, h), aux


def _loss_mask(batch: dict) -> torch.Tensor:
    """[B, T - 1] float32 weights of the next-token targets."""
    tokens = batch["tokens"]
    mask = batch.get("loss_mask")
    if mask is None:
        return torch.ones((tokens.shape[0], tokens.shape[1] - 1),
                          dtype=torch.float32, device=tokens.device)
    return mask[:, 1:].to(torch.float32)


def loss_denominator(batch: dict) -> torch.Tensor:
    """The token count :func:`loss_fn` divides its cross-entropy by."""
    return torch.clamp(_loss_mask(batch).sum(), min=1.0)


def loss_fn(model: Model, cfg, batch: dict, denom=None):
    """Next-token cross-entropy in float32 over ``batch["tokens"]``,
    weighted by ``batch["loss_mask"]`` [B, T] where given (its first
    column unused), plus the aux loss; a frontend model's frontend
    positions are out of it.  ``denom``: the token count to divide by
    (default this batch's, :func:`loss_denominator`; a data-parallel
    rank divides its rows' sum by the whole batch's).  Returns (loss,
    {"ce", "aux"})."""
    logits, aux = forward_train(model, cfg, batch)
    F = _frontend_len(cfg, batch)
    tokens = batch["tokens"].long()
    lg = logits[:, F:-1].to(torch.float32)
    tg = tokens[:, 1:]
    mask = _loss_mask(batch)
    logz = torch.logsumexp(lg, dim=-1)
    gold = torch.gather(lg, -1, tg[..., None])[..., 0]
    if denom is None:
        denom = loss_denominator(batch)
    ce = ((logz - gold) * mask).sum() / denom
    return ce + aux, {"ce": ce, "aux": aux}


@dataclasses.dataclass
class DenseKV:
    """The bucketed engine's decode cache: the GQA layers' K/V ``[n_attn,
    B, S_max, Hk, D]``, the MLA layers' latents ``c_kv`` [n_mla, B,
    S_max, r] and ``k_rope`` [n_mla, B, S_max, dr], an encoder-decoder
    model's cross planes ``xk``/``xv`` [n_attn, B, Te, Hk, D] (the
    encoder output's k and v, written by the prefill, read-only after),
    the Mamba layers' states ``h`` [n_mamba, B, d_in, N] and ``conv`` [n_mamba, B, K-1,
    d_in], the RWKV layers' ``S`` [n_rwkv, B, H, D, D] and previous
    tokens ``x_tm``, ``x_cm`` [n_rwkv, B, 1, d] (None where the model has
    no such layer), the rows' ``lengths`` [B] and ``dtype``, the cache
    dtype the K/V and latent planes are held in.

    The state planes are float32.  ``conv``, ``x_tm`` and ``x_cm`` hold
    the prefill's values rounded to ``dtype`` and a decode step's in
    float32: JAX writes them to the cache at its dtype, and its decode
    step's concatenate with the float32 activations promotes them, so
    from the first step on they are float32 there too."""

    k: torch.Tensor | None
    v: torch.Tensor | None
    lengths: torch.Tensor       # [B] int64
    c_kv: torch.Tensor | None = None
    k_rope: torch.Tensor | None = None
    h: torch.Tensor | None = None
    conv: torch.Tensor | None = None
    S: torch.Tensor | None = None
    x_tm: torch.Tensor | None = None
    x_cm: torch.Tensor | None = None
    xk: torch.Tensor | None = None
    xv: torch.Tensor | None = None
    dtype: torch.dtype = torch.float32


def plane_shapes(cfg) -> dict[str, tuple[int, tuple[int, ...]]]:
    """{plane name: (layers of its type, one token's shape)} for the
    layer types ``cfg`` has (JAX's ``_layer_cache_shape``); a state
    plane's (``STATE_PLANES``) shape is one row's."""
    feat = {name: (cfg.n_kv_heads, cfg.d_head)
            for name in ("k", "v") + CROSS_PLANES}
    if cfg.mla is not None:
        feat["c_kv"] = (cfg.mla.kv_lora_rank,)
        feat["k_rope"] = (cfg.mla.qk_rope_dim,)
    if cfg.ssm is not None:
        d_in, D = cfg.ssm.expand * cfg.d_model, cfg.ssm.head_dim
        feat.update(h=(d_in, cfg.ssm.d_state),
                    conv=(cfg.ssm.d_conv - 1, d_in),
                    S=(cfg.d_model // D, D, D), x_tm=(1, cfg.d_model),
                    x_cm=(1, cfg.d_model))
    out = {}
    for lt, names in _planes(cfg).items():
        n = cfg.layer_types.count(lt)
        if n:
            out.update({name: (n, feat[name]) for name in names})
    return out


def _planes(cfg) -> dict[str, tuple[str, ...]]:
    """PLANES, with an encoder-decoder model's cross planes after its
    attention layers' k and v."""
    if not cfg.enc_dec:
        return PLANES
    return dict(PLANES, attn=PLANES["attn"] + CROSS_PLANES)


def _flat(y) -> tuple:
    """A layer's prefill planes as a flat tuple (RWKV's ((S, x_tm),
    x_cm) nesting undone)."""
    if not isinstance(y, tuple):
        return (y,)
    return tuple(t for part in y for t in _flat(part))


def stack_planes(cfg, ys) -> dict[str, torch.Tensor]:
    """Prefill's per-layer planes (``apply_blocks``' ``ys``) stacked per
    name: {"k": [n_attn, B, T, Hk, D], "c_kv": [n_mla, B, T, r], "h":
    [n_mamba, B, d_in, N], ...}."""
    out = {}
    for lt, names in _planes(cfg).items():
        idx = [i for i, t in enumerate(cfg.layer_types) if t == lt]
        for j, name in enumerate(names if idx else ()):
            out[name] = torch.stack([_flat(ys[i])[j] for i in idx])
    return out


def make_cache(cfg, B: int, S_max: int, *, dtype=torch.float32,
               device="cuda", enc_frames: int | None = None) -> DenseKV:
    """Zero dense decode cache, lengths 0: the planes of every layer
    type the model has (state planes in float32; an encoder-decoder
    model's cross planes ``enc_frames`` long, default
    ``cfg.n_frontend_tokens``)."""
    planes = {}
    for name, (n, feat) in plane_shapes(cfg).items():
        state = name in STATE_PLANES
        seq = (enc_frames or cfg.n_frontend_tokens if name in CROSS_PLANES
               else S_max)
        planes[name] = torch.zeros(
            (n, B) + (() if state else (seq,)) + feat,
            dtype=torch.float32 if state else dtype, device=device)
    return DenseKV(k=planes.pop("k", None), v=planes.pop("v", None),
                   lengths=torch.zeros((B,), dtype=torch.int64,
                                       device=device), dtype=dtype, **planes)


def set_cache_lengths(cache, lengths):
    """Overwrite the rows' lengths of a dense or paged cache, in place;
    returns ``cache``."""
    cache.lengths.copy_(torch.as_tensor(lengths, dtype=cache.lengths.dtype))
    return cache


@torch.inference_mode()
def prefill(model: Model, cfg, tokens: torch.Tensor, S_max: int, *,
            frontend: torch.Tensor | None = None, cache_dtype=torch.float32,
            cache: DenseKV | None = None):
    """Run equal-length prompts ``tokens`` [B, T] and fill a dense decode
    cache.  Returns (logits at the last prompt token [B, V], cache).

    ``frontend`` [B, F, d]: the prompts' precomputed embeddings.  An
    encoder-decoder model runs its encoder over them (the cross planes
    take the encoder output's k and v; the rows' lengths are T); a
    frontend model puts them ahead of the tokens' embeddings (lengths F +
    T).

    ``cache``: a dense cache of B rows and ``S_max`` positions to fill in
    place (its positions past the prompt keep what they held; ``lengths``
    masks them), else a new one.  On the RNS path every prompt token of a
    decoder-only prompt quantizes on its own grid (an all-ones per-token
    :class:`token_mask`): the grid :func:`prefill_ragged` and
    :func:`mixed_step` give it too.  A prompt with a frontend quantizes
    on one grid a row over all its positions, and the encoder's stream
    and output likewise over their frames: at B = 1 the JAX package's
    whole-tensor grid, and a row of a batch that row served alone
    (ROADMAP C.11).
    """
    B, T = tokens.shape
    if cfg.enc_dec and frontend is None:
        raise ValueError(f"{cfg.arch_id}: an encoder-decoder prompt needs "
                         "its frontend frames")
    mixes = cfg.enc_dec or (cfg.frontend is not None
                            and frontend is not None)
    F = frontend.shape[1] if mixes and not cfg.enc_dec else 0
    if T + F > S_max:
        raise ValueError(f"prompt length {T + F} > cache capacity {S_max}")
    h = _embed_tokens(model, cfg, tokens)
    enc_out = None
    if cfg.enc_dec:
        enc_out = _encode(model, cfg, frontend.to(h.dtype))
    elif F:
        h = torch.cat([frontend.to(h.dtype), h], dim=1)
    if mixes:
        grids = _row_grids(cfg, h)
    else:
        grids = token_mask(torch.ones((B, T), dtype=torch.bool,
                                      device=tokens.device)
                           if cfg.rns is not None else None,
                           per_token=True)
    with grids:
        h = _add_abs_pos(cfg, h)
        h, ys = tf.apply_blocks(model.blocks, h, cfg, mode="prefill",
                                enc_out=enc_out)
        logits = _logits(model, h[:, -1:])[:, 0]
    if cache is None:
        cache = make_cache(cfg, B, S_max, dtype=cache_dtype,
                           device=tokens.device,
                           enc_frames=None if enc_out is None
                           else enc_out.shape[1])
    for name, planes in stack_planes(cfg, ys).items():
        dst = getattr(cache, name)
        if name in ("h", "S"):
            dst.copy_(planes)
        elif name in STATE_PLANES:
            dst.copy_(planes.to(cache.dtype))
        elif name in CROSS_PLANES:
            dst.copy_(planes.to(dst.dtype))
        else:
            dst[:, :, :T + F] = planes.to(dst.dtype)
    cache.lengths.fill_(T + F)
    return logits, cache


@torch.inference_mode()
def prefill_ragged(model: Model, cfg, tokens: torch.Tensor,
                   lengths: torch.Tensor):
    """Mixed-length prefill: tokens [B, Tpad] right-padded, per-row
    ``lengths`` [B].  Returns (logits at each row's last prompt token
    [B, V], per-layer (k, v) planes [B, Tpad, Hk, D]).  Attention layers
    only: a recurrent layer's state would run on through the padding.

    On the RNS path every prompt token quantizes on its own (row, token)
    absmax grid (a per-token :class:`token_mask`), invariant to padding.
    """
    B, Tpad = tokens.shape
    valid = torch.arange(Tpad, device=tokens.device)[None, :] < lengths[:, None]
    with token_mask(valid if cfg.rns is not None else None, per_token=True):
        h = _add_abs_pos(cfg, _embed_tokens(model, cfg, tokens))
        h, ys = tf.apply_blocks(model.blocks, h, cfg, mode="prefill")
        h_last = h[torch.arange(B, device=h.device), lengths - 1][:, None]
        return _logits(model, h_last)[:, 0], ys


@torch.inference_mode()
def decode_step(model: Model, cfg, token: torch.Tensor, cache, active=None):
    """token [B, 1] -> logits [B, V]; writes the token's KV into ``cache``
    (paged, or the bucketed engine's :class:`DenseKV`), and the recurrent
    layers' new states into a dense cache's state planes, and advances
    the lengths of ``active`` rows, in place.

    A sinusoidal-position model adds each row's position at its length
    (a table built once per device; an encoder-decoder model's
    cross-attention reads the cache's cross planes).

    On the RNS path ``active`` is the per-row quantization mask, so each
    row's grid is its own (a batched step is bit-identical per row to a
    solo one).
    """
    mask = active[:, None] if (active is not None
                               and cfg.rns is not None) else None
    with token_mask(mask):
        h = _add_pos_at(cfg, _embed_tokens(model, cfg, token),
                        cache.lengths[:, None], cache)
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
        h = _embed_tokens(model, cfg, tokens)
        if cfg.pos_emb == "sinusoidal":
            pos = cache.lengths[:, None] + torch.arange(
                W, device=tokens.device)
            h = _add_pos_at(cfg, h, pos, cache)
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
        h = _add_pos_at(cfg, _embed_tokens(model, cfg, tokens[None]),
                        pos[None], cache)
        h, _ = tf.apply_blocks(model.blocks, h, cfg, mode="decode",
                               cache=cache, packed=(seg, pos, dec))
        return _logits(model, h)[0]
