"""GQA attention with RoPE: prefill, one-token decode over a dense or a
paged cache, the speculative-verify window and the packed mixed-phase
step.  Plain PyTorch, as in the JAX package, whose model paths compute
attention outside any Pallas kernel.

``cfg.attn_window`` (a sliding window) narrows every one of them alike:
query ``q`` attends keys ``[q - window + 1, q]``, the rest weigh exactly
0, so a windowed prefill and windowed decode steps agree with a windowed
solo run after the scheduler recycled the evicted positions' pages.

Every serving path attends through :func:`lane_attention`: each query
token (a *lane*) against its own keys, with its sums as fixed trees of
elementwise adds (``layers.tree_sum``), so a token's attention is the
same float ops whether it is prefilled with its whole prompt, in a
packed chunk, or decoded in a batch of any size (ROADMAP C.10).  The
JAX package's prefill computes the same function as an online softmax
over KV chunks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.rns_matmul import rns_multi_dot
from repro_torch.models.layers import _param, linear, matmul_rows, tree_sum

__all__ = ["rope", "lane_attention", "Attention", "gqa_qkv", "gqa_attend",
           "gqa_decode", "gqa_decode_paged", "gqa_decode_paged_window",
           "gqa_decode_packed"]

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


#: lanes one pass of :func:`lane_attention` takes (bounds its memory;
#: the result does not depend on it)
LANE_BLOCK = 64
#: keys summed as one tree in :func:`lane_attention` (a page's worth)
KEY_BLOCK = 16


def _key_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum over the key axis ``dim`` (a multiple of KEY_BLOCK long): a
    tree within each block of KEY_BLOCK keys, then the blocks added in
    order.  Trailing all-masked blocks add exact zeros, so the sum does
    not depend on how far the keys are padded."""
    dim = dim % x.ndim
    nblk = x.shape[dim] // KEY_BLOCK
    x = tree_sum(x.unflatten(dim, (nblk, KEY_BLOCK)), dim + 1)
    acc = x.select(dim, 0)
    for j in range(1, nblk):
        acc = acc + x.select(dim, j)
    return acc


def lane_attention(q, k, v, lengths, window=None):
    """Each lane's query against its own keys: q [N, H, D], k/v [N or 1,
    S, Hk, D] (1: every lane reads the same keys), ``lengths`` [N] valid
    keys per lane.  Returns out [N, H, D] in q's dtype.

    ``window``: a sliding window -- a lane with ``n`` valid keys (its
    position is ``n - 1``) also masks the keys below ``n - window``.

    Scores are trees of elementwise products and adds over D
    (``tree_sum``); the softmax sum and the weighted sum of values are
    trees over blocks of KEY_BLOCK keys added block by block
    (:func:`_key_sum`), the keys zero-padded to whole blocks; masked
    keys weigh exactly 0 and the max is exact.  So a lane's result does
    not depend on the other lanes, on ``LANE_BLOCK``, or on how many
    masked keys follow its valid ones.  A masked key's value is set to 0
    as well, not only its probability, so that a recycled or trash page
    holding a non-finite value cannot turn ``0 * v`` into NaN (with
    finite values this changes no bit).
    """
    N, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    Sp = -(-S // KEY_BLOCK) * KEY_BLOCK
    pad = (0, 0, 0, 0, 0, Sp - S)
    # [N or 1, Hk, 1, Sp, D]: keys and values per KV head, zero-padded
    kt = F.pad(k.to(torch.float32), pad).permute(0, 2, 1, 3)[:, :, None]
    vt = F.pad(v.to(torch.float32), pad).permute(0, 2, 1, 3)[:, :, None]
    scale = _scale(D, q.device)
    keys = torch.arange(Sp, device=q.device)
    outs = []
    for i in range(0, N, LANE_BLOCK):
        qb = q[i:i + LANE_BLOCK].to(torch.float32)
        n = qb.shape[0]
        kb = kt if kt.shape[0] == 1 else kt[i:i + n]
        vb = vt if vt.shape[0] == 1 else vt[i:i + n]
        qg = qb.reshape(n, Hk, G, 1, D)
        s = tree_sum(qg * kb, -1) / scale                    # [n, Hk, G, Sp]
        ln = lengths[i:i + n, None]
        valid = keys < ln
        if window is not None:
            valid = valid & (keys >= ln - window)
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = _key_sum(p, -1)                                  # [n, Hk, G]
        # masked values to 0 before the product: [n, Hk, 1, Sp, D],
        # G times smaller than the product
        vm = torch.where(valid[..., None], vb, 0.0)
        o = _key_sum(p[..., None] * vm, -2)                  # [n, Hk, G, D]
        o = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.reshape(n, H, D))
    return torch.cat(outs).to(q.dtype)


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
        return tuple(matmul_rows(x, w) for w in ws)
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
    (y, (k, v)) so the caller can fill the KV cache.  Every prompt token
    is a lane of :func:`lane_attention` over the prompt's own keys, as a
    packed chunk's tokens are over their row's pages."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    q, k, v = gqa_qkv(p, x, cfg, positions, rns)
    lengths = torch.arange(1, T + 1, device=x.device)
    out = torch.stack([lane_attention(q[b], k[b:b + 1], v[b:b + 1], lengths,
                                      cfg.attn_window)
                       for b in range(B)])
    return linear(p.wo, out.reshape(B, T, -1), rns), (k, v)


def gqa_decode(p: Attention, x, cfg, cache, layer: int, *, rns=None):
    """One-token decode against layer ``layer`` of a dense cache
    (``model.DenseKV``, the bucketed engine's): the new token's K/V are
    written at each row's length (in place), then each row attends its
    ``lengths + 1`` keys."""
    B = x.shape[0]
    positions = cache.lengths[:, None]
    q, k, v = gqa_qkv(p, x, cfg, positions, rns)
    rows = torch.arange(B, device=x.device)
    cache.k[layer, rows, cache.lengths] = k[:, 0].to(cache.k.dtype)
    cache.v[layer, rows, cache.lengths] = v[:, 0].to(cache.v.dtype)
    out = lane_attention(q[:, 0], cache.k[layer], cache.v[layer],
                         cache.lengths + 1, cfg.attn_window)
    return linear(p.wo, out.reshape(B, 1, -1), rns)


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
    out = lane_attention(q[:, 0], kd, vd, cache.lengths + 1,
                         cfg.attn_window)
    return linear(p.wo, out.reshape(B, 1, -1), rns)


def gqa_decode_paged_window(p: Attention, x, cfg, cache, layer: int, *,
                            rns=None):
    """W-token speculative-verify decode against layer ``layer`` of a
    paged KV cache.

    ``x`` [R, W, d]: the window [last token, draft 1, ..., draft W-1].
    All W tokens' K/V are written (in place) at positions ``lengths ..
    lengths + W - 1`` (past the row's pages: the trash page), then window
    token i of row r attends ``lengths[r] + 1 + i`` keys of its row --
    each a lane of :func:`lane_attention`, the same float ops as the
    solo decode step at that position.  ``lengths`` is not advanced.
    """
    from repro_torch.serve.kv_cache import gather_pages, write_token_window

    R, W = x.shape[:2]
    ar = torch.arange(W, device=x.device)
    positions = cache.lengths[:, None] + ar[None]
    q, k, v = gqa_qkv(p, x, cfg, positions, rns)
    write_token_window(cache.k_pages[layer], cache.block_table,
                       cache.lengths, k)
    write_token_window(cache.v_pages[layer], cache.block_table,
                       cache.lengths, v)
    rows = torch.arange(R, device=x.device).repeat_interleave(W)
    kd = gather_pages(cache.k_pages[layer], cache.block_table)[rows]
    vd = gather_pages(cache.v_pages[layer], cache.block_table)[rows]
    out = lane_attention(q.reshape(R * W, *q.shape[2:]), kd, vd,
                         (positions + 1).reshape(-1), cfg.attn_window)
    return linear(p.wo, out.reshape(R, W, -1), rns)


def gqa_decode_packed(p: Attention, x, cfg, cache, layer: int, seg, pos, *,
                      rns=None):
    """Packed mixed-phase step against layer ``layer`` of a paged cache.

    ``x`` [1, N, d]: token i belongs to row ``seg[i]`` at absolute
    position ``pos[i]`` -- any mix of prefill-chunk tokens and decode
    rows (pad lanes carry ``seg = -1`` and write to the trash page).
    Every lane's K/V is written (in place) BEFORE the gather, so a chunk
    token attends earlier chunks' pages and its own chunk predecessors;
    each lane attends ``pos + 1`` keys of its own row through
    :func:`lane_attention` over the row's gathered pages.
    """
    from repro_torch.serve.kv_cache import gather_pages, write_packed_tokens

    N = x.shape[1]
    q, k, v = gqa_qkv(p, x, cfg, pos[None], rns)
    write_packed_tokens(cache.k_pages[layer], cache.block_table, seg, pos,
                        k[0])
    write_packed_tokens(cache.v_pages[layer], cache.block_table, seg, pos,
                        v[0])
    segc = seg.clamp(0, cache.block_table.shape[0] - 1)
    kd = gather_pages(cache.k_pages[layer], cache.block_table)[segc]
    vd = gather_pages(cache.v_pages[layer], cache.block_table)[segc]
    out = lane_attention(q[0], kd, vd, pos + 1, cfg.attn_window)
    return linear(p.wo, out.reshape(1, N, -1), rns)
