"""The decoder stack: a Python loop over layers (the JAX package scans over
stacked periods; eager PyTorch needs no scan).  A layer is GQA or MLA
attention followed by a dense or a MoE MLP, as its config's
``layer_types`` / ``mlp_types`` say."""

from __future__ import annotations

from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models.layers import MLP, RMSNorm, mlp

__all__ = ["Block", "layer_slots", "apply_blocks"]


def _rns_for(cfg, target: str):
    if cfg.rns is None:
        return None
    if cfg.rns_targets in ("all", target):
        return cfg.rns
    return None


class Block(nn.Module):
    """One attention + MLP layer (pre-norm, residual): ``attn`` an
    :class:`~repro_torch.models.attention.Attention` (GQA) or an
    :class:`~repro_torch.models.attention.MLA`; ``mlp`` an :class:`MLP`,
    or ``moe`` a :class:`~repro_torch.models.moe.MoE`."""

    def __init__(self, cfg, layer_type: str = "attn",
                 mlp_type: str = "dense", device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = (attn.MLA(cfg, device) if layer_type == "mla"
                     else attn.Attention(cfg, device))
        self.ln2 = RMSNorm(cfg.d_model, device)
        if mlp_type == "moe":
            self.moe = moe_lib.MoE(cfg.d_model, cfg.moe, device)
        else:
            self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, device)


def layer_slots(cfg) -> list[int]:
    """Each layer's index among the layers of its type: its plane of the
    caches, which keep one stack per layer type."""
    return [cfg.layer_types[:i].count(t)
            for i, t in enumerate(cfg.layer_types)]


def _attend(blk: Block, hn, cfg, *, mode: str, cache, slot: int, packed,
            rns):
    """The layer's attention: (y, prefill cache planes or None)."""
    mla = isinstance(blk.attn, attn.MLA)
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


def _apply_layer(blk: Block, h, cfg, *, mode: str, cache, slot: int,
                 packed=None):
    """Returns (h, prefill cache planes or None); a MoE block's aux loss
    (a training term) is dropped."""
    rns_a, rns_m = _rns_for(cfg, "attn"), _rns_for(cfg, "mlp")
    y, planes = _attend(blk, blk.ln1(h), cfg, mode=mode, cache=cache,
                        slot=slot, packed=packed, rns=rns_a)
    h = h + y
    hn = blk.ln2(h)
    if hasattr(blk, "moe"):
        y, _aux = moe_lib.moe_ffn(blk.moe, hn, cfg.moe, act=cfg.act,
                                  rns=rns_m)
    else:
        y = mlp(blk.mlp, hn, gated=cfg.gated_mlp, act=cfg.act, rns=rns_m)
    return h + y, planes


def apply_blocks(blocks, h, cfg, *, mode: str, cache=None, packed=None):
    """Run every layer.  ``mode``: "prefill" (returns each layer's cache
    planes: (k, v) of a GQA layer, (c_kv, k_rope) of an MLA layer) or
    "decode" (against ``cache``, in place: a paged cache, [R, W] tokens
    with W > 1 being a speculative-verify window, or the bucketed
    engine's dense cache, one token a row).  ``packed`` (decode mode): a
    ``(seg, pos, dec)`` triple of [N] tensors giving every token of the
    [1, N, d] stream its own row, absolute position and phase -- the
    mixed chunked-prefill/decode layout."""
    ys = []
    for blk, slot in zip(blocks, layer_slots(cfg)):
        h, planes = _apply_layer(blk, h, cfg, mode=mode, cache=cache,
                                 slot=slot, packed=packed)
        ys.append(planes)
    return h, ys
