"""The decoder stack: a Python loop over layers (the JAX package scans over
stacked periods; eager PyTorch needs no scan)."""

from __future__ import annotations

from torch import nn

from repro_torch.models import attention as attn
from repro_torch.models.layers import MLP, RMSNorm, mlp

__all__ = ["Block", "apply_blocks"]


def _rns_for(cfg, target: str):
    if cfg.rns is None:
        return None
    if cfg.rns_targets in ("all", target):
        return cfg.rns
    return None


class Block(nn.Module):
    """One attention + MLP layer (pre-norm, residual)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.ln1 = RMSNorm(cfg.d_model, device)
        self.attn = attn.Attention(cfg, device)
        self.ln2 = RMSNorm(cfg.d_model, device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, device)


def _apply_layer(blk: Block, h, cfg, *, mode: str, cache, layer: int,
                 packed=None):
    """Returns (h, prefill (k, v) or None)."""
    rns_a, rns_m = _rns_for(cfg, "attn"), _rns_for(cfg, "mlp")
    hn = blk.ln1(h)
    kv = None
    if mode == "decode" and packed is not None:
        seg, pos, _dec = packed
        y = attn.gqa_decode_packed(blk.attn, hn, cfg, cache, layer, seg, pos,
                                   rns=rns_a)
    elif mode == "decode" and not hasattr(cache, "block_table"):
        if hn.shape[1] > 1:
            raise NotImplementedError(
                "multi-token decode windows (speculative verify) need a "
                "paged cache")
        y = attn.gqa_decode(blk.attn, hn, cfg, cache, layer, rns=rns_a)
    elif mode == "decode":
        fn = (attn.gqa_decode_paged_window if hn.shape[1] > 1
              else attn.gqa_decode_paged)
        y = fn(blk.attn, hn, cfg, cache, layer, rns=rns_a)
    else:
        y, kv = attn.gqa_attend(blk.attn, hn, cfg, rns=rns_a)
    h = h + y
    h = h + mlp(blk.mlp, blk.ln2(h), gated=cfg.gated_mlp, act=cfg.act,
                rns=rns_m)
    return h, kv


def apply_blocks(blocks, h, cfg, *, mode: str, cache=None, packed=None):
    """Run every layer.  ``mode``: "prefill" (returns the per-layer
    (k, v) planes) or "decode" (against ``cache``, in place: a paged
    cache, [R, W] tokens with W > 1 being a speculative-verify window,
    or the bucketed engine's dense cache, one token a row).
    ``packed`` (decode mode): a ``(seg, pos, dec)`` triple of [N] tensors
    giving every token of the [1, N, d] stream its own row, absolute
    position and phase -- the mixed chunked-prefill/decode layout."""
    ys = []
    for i, blk in enumerate(blocks):
        h, kv = _apply_layer(blk, h, cfg, mode=mode, cache=cache, layer=i,
                             packed=packed)
        ys.append(kv)
    return h, ys
