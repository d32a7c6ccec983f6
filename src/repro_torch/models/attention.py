"""GQA attention with RoPE: prefill (online-softmax over KV chunks) and
paged one-token decode.  Plain PyTorch, as in the JAX package, whose model
paths compute attention outside any Pallas kernel."""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from repro_torch.core.rns_matmul import rns_multi_dot
from repro_torch.models.layers import _param, linear

__all__ = ["rope", "chunked_attention", "flash_attention", "decode_attention",
           "Attention", "gqa_qkv", "gqa_attend", "gqa_decode_paged"]

NEG_INF = -1e30


@functools.lru_cache(maxsize=None)
def _rope_freqs(d2: int, theta: float, device: torch.device) -> torch.Tensor:
    """The float32 rotation frequencies on ``device``, copied there once
    (a copy from the host inside a captured step would break the
    capture)."""
    freqs = 1.0 / (theta ** (np.arange(d2, dtype=np.float32) / d2))
    return torch.as_tensor(freqs, device=device)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """x [B, T, H, D], positions [B, T] -> rotated x (half-split)."""
    d2 = x.shape[-1] // 2
    freqs = _rope_freqs(d2, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs        # [B, T, d2]
    sin, cos = torch.sin(ang)[:, :, None, :], torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :d2], x[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _scale(D: int, device) -> torch.Tensor:
    """sqrt(D) in float32 as a tensor on ``device``: dividing by it is a
    true division (a python or CPU scalar divisor becomes a multiply by its
    reciprocal on the card)."""
    return torch.full((), float(np.sqrt(D).astype(np.float32)),
                      device=device)


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024,
                      q_offset: int = 0):
    """Online-softmax over KV chunks (prefill).  q [B,Tq,H,D], k/v
    [B,Tk,Hk,D] -> [B,Tq,H,Dv]."""
    B, Tq, H, D = q.shape
    Tk, Hk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hk
    dev = q.device
    qf = q.to(torch.float32).reshape(B, Tq, Hk, G, D)
    qpos = torch.arange(Tq, device=dev) + q_offset
    m = torch.full((B, Hk, G, Tq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hk, G, Tq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hk, G, Tq, Dv), dtype=torch.float32, device=dev)
    scale = _scale(D, dev)
    for c in range(-(-Tk // chunk)):
        kb = k[:, c * chunk:(c + 1) * chunk].to(torch.float32)
        vb = v[:, c * chunk:(c + 1) * chunk].to(torch.float32)
        n = kb.shape[1]
        if n < chunk:               # zero-pad the ragged last chunk
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, chunk - n))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, chunk - n))
        s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb) / scale
        kpos = c * chunk + torch.arange(chunk, device=dev)
        valid = (kpos < Tk)[None, :].expand(Tq, chunk)
        if causal:
            valid = valid & (qpos[:, None] >= kpos[None, :])
        s = torch.where(valid, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, Dv).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool, q_chunk: int = 512,
                    kv_chunk: int = 1024):
    """Q-tiled :func:`chunked_attention` for long prompts."""
    outs = [chunked_attention(q[:, i:i + q_chunk], k, v, causal=causal,
                              chunk=kv_chunk, q_offset=i)
            for i in range(0, q.shape[1], q_chunk)]
    return torch.cat(outs, dim=1)


def decode_attention(q, k_cache, v_cache, lengths):
    """q [B,Tq,H,D] against cache [B,S,Hk,D]; ``lengths`` [B] valid
    prefix sizes.  Returns out [B,Tq,H,D]."""
    B, Tq, H, D = q.shape
    S, Hk = k_cache.shape[1], k_cache.shape[2]
    G = H // Hk
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None])
    mask = mask[:, None, None, None, :]
    qg = q.to(torch.float32).reshape(B, Tq, Hk, G, D)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg,
                     k_cache.to(torch.float32)) / _scale(D, q.device)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    out = torch.einsum("bhgqk,bkhd->bhgqd", p, v_cache.to(torch.float32))
    out = out / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, D).to(q.dtype)


class Attention(nn.Module):
    """GQA projection weights: wq [d, H*D], wk/wv [d, Hk*D], wo [H*D, d]."""

    def __init__(self, cfg, device=None):
        super().__init__()
        H, Hk, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
        self.wq = _param(torch.empty(d, H * D, device=device))
        self.wk = _param(torch.empty(d, Hk * D, device=device))
        self.wv = _param(torch.empty(d, Hk * D, device=device))
        self.wo = _param(torch.empty(H * D, d, device=device))


def _multi_proj(x, ws, rns):
    """Several projections of ``x``; ONE shared forward conversion on the
    RNS path."""
    if rns is None:
        return tuple(x @ w for w in ws)
    ys = rns_multi_dot(x.to(torch.float32),
                       tuple(w.to(torch.float32) for w in ws), rns)
    return tuple(y.to(x.dtype) for y in ys)


def gqa_qkv(p: Attention, x, cfg, positions, rns=None):
    B, T, _ = x.shape
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = _multi_proj(x, (p.wq, p.wk, p.wv), rns)
    q = rope(q.reshape(B, T, H, D), positions, cfg.rope_theta)
    k = rope(k.reshape(B, T, Hk, D), positions, cfg.rope_theta)
    return q, k, v.reshape(B, T, Hk, D)


def gqa_attend(p: Attention, x, cfg, *, rns=None):
    """Causal self-attention over a whole (padded) prompt; returns
    (y, (k, v)) so the caller can fill the KV cache."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    q, k, v = gqa_qkv(p, x, cfg, positions, rns)
    if T <= cfg.attn_dense_max:
        out = chunked_attention(q, k, v, causal=cfg.causal,
                                chunk=cfg.attn_kv_chunk)
    else:
        out = flash_attention(q, k, v, causal=cfg.causal,
                              q_chunk=cfg.attn_q_chunk,
                              kv_chunk=cfg.attn_kv_chunk)
    return linear(p.wo, out.reshape(B, T, -1), rns), (k, v)


def gqa_decode_paged(p: Attention, x, cfg, cache, layer: int, *, rns=None):
    """One-token decode against layer ``layer`` of a paged KV cache.

    The new token's K/V are written into the row's current page (in
    place), then the row's pages are gathered into a dense
    [R, nb*bs, Hk, D] view; positions past ``lengths`` are masked.
    """
    from repro_torch.serve.kv_cache import gather_pages, write_token

    B = x.shape[0]
    positions = cache.lengths[:, None]
    q, k, v = gqa_qkv(p, x, cfg, positions, rns)
    write_token(cache.k_pages[layer], cache.block_table, cache.lengths,
                k[:, 0])
    write_token(cache.v_pages[layer], cache.block_table, cache.lengths,
                v[:, 0])
    kd = gather_pages(cache.k_pages[layer], cache.block_table)
    vd = gather_pages(cache.v_pages[layer], cache.block_table)
    out = decode_attention(q, kd, vd, cache.lengths + 1)
    return linear(p.wo, out.reshape(B, 1, -1), rns)
