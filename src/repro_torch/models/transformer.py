"""The layer stacks: a Python loop over layers (the JAX package scans over
stacked periods; eager PyTorch needs no scan).  A decoder layer is GQA
or MLA attention, a Mamba layer or an RWKV-6 time-mix, followed by a
dense or a MoE MLP or (RWKV) the channel-mix, as its config's
``layer_types`` / ``mlp_types`` say; in an encoder-decoder model each
attention layer also cross-attends to the encoder's output.  An encoder
layer (MLP type ``"__enc__"``, as in JAX) is self-attention and a dense
MLP.

``mode="train"`` runs the stack with no cache and no token mask, its
attention JAX's train rule (dense up to ``cfg.attn_dense_max`` tokens,
else the q-tiled flash; GQA or MLA, and an encoder-decoder's
cross-attention dense over the encoder's output), sums the MoE layers'
aux losses in layer order from a float32 zero, and under ``cfg.remat ==
"full"`` recomputes each layer in the backward (``torch.utils.
checkpoint``, non-reentrant, the aux loss its second output): the
counterpart of JAX's ``jax.checkpoint`` around its scanned period."""

from __future__ import annotations

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.distributed import sharding
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import MLP, mlp, norm

__all__ = ["Block", "layer_slots", "apply_blocks"]


def _rns_for(cfg, target: str):
    if cfg.rns is None:
        return None
    if cfg.rns_targets in ("all", target):
        return cfg.rns
    return None


class Block(nn.Module):
    """One layer (pre-norm, residual), with JAX's parameter names: ``ln1``
    and the mixer -- ``attn`` an :class:`~repro_torch.models.attention.
    Attention` (GQA) or :class:`~repro_torch.models.attention.MLA`,
    ``mamba`` a :class:`~repro_torch.models.ssm.Mamba` or ``rwkv`` an
    :class:`~repro_torch.models.ssm.RWKV6` --; then ``ln2`` and ``mlp``
    an :class:`MLP` or ``moe`` a :class:`~repro_torch.models.moe.MoE`.
    An RWKV layer has no ``ln2``: its channel-mix lives in ``rwkv`` with
    its own norm ``rwkv.ln_cm``.  A decoder attention layer of an
    encoder-decoder model has ``lnx`` and ``xattn`` (cross-attention,
    after the self-attention, before the MLP); an encoder layer (MLP type
    ``"__enc__"``) has none.  Norms follow ``cfg.norm``."""

    def __init__(self, cfg, layer_type: str = "attn",
                 mlp_type: str = "dense", device=None):
        super().__init__()
        self.ln1 = norm(cfg.norm, cfg.d_model, device)
        if layer_type == "mla":
            self.attn = attn.MLA(cfg, device)
        elif layer_type == "attn":
            self.attn = attn.Attention(cfg, device)
        elif layer_type == "mamba":
            self.mamba = ssm_lib.Mamba(cfg.d_model, cfg.ssm, device)
        elif layer_type == "rwkv":
            self.rwkv = ssm_lib.RWKV6(cfg.d_model, cfg.ssm, cfg.d_ff, device)
        else:
            raise ValueError(layer_type)
        if cfg.enc_dec and layer_type == "attn" and mlp_type != "__enc__":
            self.lnx = norm(cfg.norm, cfg.d_model, device)
            self.xattn = attn.Attention(cfg, device)
        if mlp_type in ("dense", "moe", "__enc__"):
            self.ln2 = norm(cfg.norm, cfg.d_model, device)
        if mlp_type == "moe":
            self.moe = moe_lib.MoE(cfg.d_model, cfg.moe, device)
        elif mlp_type in ("dense", "__enc__"):
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, device)


def layer_slots(cfg) -> list[int]:
    """Each layer's index among the layers of its type: its plane of the
    caches, which keep one stack per layer type."""
    return [cfg.layer_types[:i].count(t)
            for i, t in enumerate(cfg.layer_types)]


def _attend(blk: Block, hn, cfg, *, mode: str, cache, slot: int, packed,
            rns):
    """The layer's self-attention: (y, prefill cache planes or None)."""
    mla = isinstance(blk.attn, attn.MLA)
    if mode == "train":
        T = hn.shape[1]
        amode = "dense" if T <= cfg.attn_dense_max else "flash"
        fn = attn.mla_attend if mla else attn.gqa_attend
        return fn(blk.attn, hn, cfg, rns=rns, mode=amode)
    if mode != "decode":
        if mla:
            return attn.mla_attend(blk.attn, hn, cfg, rns=rns)
        return attn.gqa_attend(blk.attn, hn, cfg, rns=rns)
    if packed is not None:
        seg, pos, dec = packed
        if mla:
            y = attn.mla_decode_packed(blk.attn, hn, cfg, cache, slot, seg,
                                       pos, dec, rns=rns)
        else:
            y = attn.gqa_decode_packed(blk.attn, hn, cfg, cache, slot, seg,
                                       pos, rns=rns)
    elif not hasattr(cache, "block_table"):
        if hn.shape[1] > 1:
            raise NotImplementedError(
                "multi-token decode windows (speculative verify) need a "
                "paged cache")
        fn = attn.mla_decode if mla else attn.gqa_decode
        y = fn(blk.attn, hn, cfg, cache, slot, rns=rns)
    elif hn.shape[1] > 1:
        fn = attn.mla_decode_paged_window if mla \
            else attn.gqa_decode_paged_window
        y = fn(blk.attn, hn, cfg, cache, slot, rns=rns)
    else:
        fn = attn.mla_decode_paged if mla else attn.gqa_decode_paged
        y = fn(blk.attn, hn, cfg, cache, slot, rns=rns)
    return y, None


def _dense_state(cache, name: str):
    """The bucketed engine's state plane ``name`` [n, B, ...] of a
    :class:`~repro_torch.models.model.DenseKV`; a paged cache has none
    (the continuous engine refuses recurrent layers)."""
    if hasattr(cache, "block_table"):
        raise NotImplementedError("recurrent layers decode over the "
                                  "bucketed engine's dense cache only")
    return getattr(cache, name)


def _mix(blk: Block, hn, cfg, *, mode: str, cache, slot: int, packed, rns_a,
         rns_m):
    """The layer's mixer: (y, prefill cache planes or None).  A decode
    step of a recurrent layer reads its state planes and writes the new
    state back in place; its prefill returns the state in JAX's order:
    ``(h_last, conv_tail)``, ``(S, x_tm)`` (the channel-mix's ``x_cm``
    joins it in :func:`_apply_layer`)."""
    if hasattr(blk, "attn"):
        return _attend(blk, hn, cfg, mode=mode, cache=cache, slot=slot,
                       packed=packed, rns=rns_a)
    decode = mode == "decode"
    if hasattr(blk, "mamba"):
        names = ("h", "conv")
        state = tuple(_dense_state(cache, n)[slot] for n in names) \
            if decode else (None, None)
        y, new = ssm_lib.mamba_seq(blk.mamba, hn, cfg.ssm, rns=rns_m,
                                   h0=state[0], conv0=state[1])
    else:
        names = ("S", "x_tm")
        state = tuple(_dense_state(cache, n)[slot] for n in names) \
            if decode else None
        y, new = ssm_lib.rwkv6_timemix(blk.rwkv, hn, cfg.ssm, rns=rns_m,
                                       state=state)
    if not decode:
        return y, new
    for name, t in zip(names, new):
        getattr(cache, name)[slot].copy_(t)
    return y, None


def _cross(blk: Block, h, cfg, *, mode: str, cache, slot: int, enc_out,
           rns):
    """The decoder layer's cross-attention: (y, the prefill's encoder
    planes (xk, xv), or None in decode mode, which reads them from the
    dense cache)."""
    hx = blk.lnx(h)
    if mode == "decode":
        if hasattr(cache, "block_table"):
            raise NotImplementedError("cross-attention decodes over the "
                                      "bucketed engine's dense cache only")
        return attn.cross_decode(blk.xattn, hx, cfg, cache, slot,
                                 rns=rns), None
    return attn.gqa_attend(blk.xattn, hx, cfg, rns=rns, xkv=enc_out,
                           mode="dense" if mode == "train" else "prefill")


def _apply_layer(blk: Block, h, cfg, *, mode: str, cache, slot: int,
                 packed=None, enc_out=None):
    """Returns (h, prefill cache planes or None, the MoE block's aux loss
    or None)."""
    rns_a, rns_m = _rns_for(cfg, "attn"), _rns_for(cfg, "mlp")
    y, planes = _mix(blk, blk.ln1(h), cfg, mode=mode, cache=cache,
                     slot=slot, packed=packed, rns_a=rns_a, rns_m=rns_m)
    h = h + y
    if hasattr(blk, "xattn"):
        y, xkv = _cross(blk, h, cfg, mode=mode, cache=cache, slot=slot,
                        enc_out=enc_out, rns=rns_a)
        h = h + y
        if mode != "decode":
            planes = (planes, xkv)
    aux = None
    if hasattr(blk, "moe"):
        y, aux = moe_lib.moe_ffn(blk.moe, blk.ln2(h), cfg.moe, act=cfg.act,
                                 rns=rns_m)
    elif hasattr(blk, "mlp"):
        y = mlp(blk.mlp, blk.ln2(h), gated=cfg.gated_mlp, act=cfg.act,
                rns=rns_m)
    elif hasattr(blk, "rwkv"):                  # channel-mix
        state = (_dense_state(cache, "x_cm")[slot] if mode == "decode"
                 else None)
        y, x_cm = ssm_lib.rwkv6_channelmix(blk.rwkv, blk.rwkv.ln_cm(h),
                                           rns=rns_m, state=state)
        if mode == "decode":
            cache.x_cm[slot].copy_(x_cm)
        else:
            planes = (planes, x_cm)
    else:
        return h, planes, aux
    return h + y, planes, aux


def _train_layer_under(layout, blk: Block, h, cfg, enc_out):
    with sharding.restore(layout):
        return _train_layer(blk, h, cfg, enc_out)


def _train_layer(blk: Block, h, cfg, enc_out):
    """(h, aux: the layer's MoE aux loss, else a float32 zero)."""
    h, _, aux = _apply_layer(blk, h, cfg, mode="train", cache=None, slot=0,
                             enc_out=enc_out)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
    return h, aux


def apply_blocks(blocks, h, cfg, *, mode: str, cache=None, packed=None,
                 enc_out=None, enc: bool = False):
    """Run every layer.  ``mode``: "prefill" (returns each layer's cache
    planes: (k, v) of a GQA layer, ((k, v), (xk, xv)) of an
    encoder-decoder model's, the cross planes from ``enc_out`` [B, Te,
    d], (c_kv, k_rope) of an MLA layer, (h_last, conv_tail) of a Mamba
    layer, ((S, x_tm), x_cm) of an RWKV layer) or
    "decode" (against ``cache``, in place: a paged cache, [R, W] tokens
    with W > 1 being a speculative-verify window, or the bucketed
    engine's dense cache, one token a row, which also holds the
    recurrent layers' states).  ``packed`` (decode mode): a
    ``(seg, pos, dec)`` triple of [N] tensors giving every token of the
    [1, N, d] stream its own row, absolute position and phase -- the
    mixed chunked-prefill/decode layout.  ``enc``: ``blocks`` is the
    encoder stack (its prefill planes are not kept).  "train": the
    stack for a loss (see the module docstring); returns (h, the summed
    aux loss, a float32 scalar) in place of the planes."""
    if mode == "train":
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        for blk in blocks:
            if cfg.remat == "full" and torch.is_grad_enabled():
                # the recompute runs in the backward (on the card, on
                # autograd's thread): under the forward's digit and batch
                # layouts
                h, a = torch.utils.checkpoint.checkpoint(
                    _train_layer_under, sharding.snapshot(), blk, h, cfg,
                    enc_out, use_reentrant=False, preserve_rng_state=False)
            else:
                h, a = _train_layer(blk, h, cfg, enc_out)
            aux = aux + a
        return h, aux
    ys = []
    slots = range(len(blocks)) if enc else layer_slots(cfg)
    for blk, slot in zip(blocks, slots):
        h, planes, _ = _apply_layer(blk, h, cfg, mode=mode, cache=cache,
                                    slot=slot, packed=packed,
                                    enc_out=enc_out)
        ys.append(planes)
    return h, ys
