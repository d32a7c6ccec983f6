"""GQA attention with RoPE and DeepSeek-V2's multi-head latent attention
(MLA): prefill, one-token decode over a dense or a paged cache, the
speculative-verify window and the packed mixed-phase step; and the
encoder-decoder's pieces: non-causal self-attention, cross-attention
over the encoder's output at prefill and :func:`cross_decode` over its
cached planes.  Plain PyTorch, as in the JAX package, whose model paths
compute attention outside any Pallas kernel.

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

Training (``gqa_attend`` / ``mla_attend(mode="dense" | "flash")``, the
cross-attention ``gqa_attend(mode="dense", xkv=)``) attends as the JAX
package's train mode does, in plain PyTorch with autograd:
:func:`dense_attention` for up to ``cfg.attn_dense_max`` tokens, else the
q-tiled online softmax :func:`flash_attention` (JAX's ``jnp`` one, not the
Pallas kernel, which has no gradient), each KV chunk's body recomputed
in the backward.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from repro_torch.core.quantize import current_token_mask, token_mask
from repro_torch.core.rns_matmul import rns_multi_dot
from repro_torch.models.layers import (RMSNorm, _param, bmm_rows, linear,
                                       matmul_rows, tree_sum)

__all__ = ["rope", "lane_attention", "dense_attention", "chunked_attention",
           "flash_attention", "Attention", "gqa_qkv", "gqa_attend",
           "cross_decode", "gqa_decode", "gqa_decode_paged",
           "gqa_decode_paged_window",
           "gqa_decode_packed", "MLA", "mla_qkv", "mla_attend",
           "mla_decode", "mla_decode_paged", "mla_decode_paged_window",
           "mla_decode_packed"]

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


#: lanes one pass of :func:`lane_attention` takes at most (bounds its
#: memory; the result does not depend on it)
LANE_BLOCK = 64
#: elements one pass's products may hold: fewer lanes a pass where the
#: heads, keys and widths are large (MLA's absorbed form at full width)
LANE_ELEMS = 1 << 26
#: keys summed as one tree in :func:`lane_attention` (a page's worth)
KEY_BLOCK = 16
#: elements one pass may hold in a whole-prompt prefill
#: (:func:`gqa_attend`): fewer, larger passes over long key axes
PREFILL_LANE_ELEMS = 1 << 30
#: a causal prefill's lanes go to :func:`lane_attention` in runs of this
#: many, each over the keys up to its last lane's position only
CAUSAL_LANES = 256


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


def _pow2(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def lane_attention(q, k, v, lengths, window=None, *, scale_dim=None,
                   lane_block=LANE_BLOCK, lane_elems=LANE_ELEMS):
    """Each lane's query against its own keys: q [N, H, D], k [N or 1, S,
    Hk, D] (1: every lane reads the same keys), v [N or 1, S, Hk, Dv],
    ``lengths`` [N] valid keys per lane.  Returns out [N, H, Dv] in q's
    dtype.

    ``q`` and ``k`` may also be equal-length tuples of parts (q_i [N, H,
    D_i], k_i [N or 1, S, Hk or 1, D_i], a one-head part read by every
    head): the score is the sum of the parts' dot products, added in
    order -- MLA's ``[nope | rope]`` halves, kept apart rather than
    concatenated.  Scores are divided by ``sqrt(scale_dim)`` (default:
    the query width, the parts' widths summed).

    ``window``: a sliding window -- a lane with ``n`` valid keys (its
    position is ``n - 1``) also masks the keys below ``n - window``.

    Scores are trees of elementwise products and adds over D
    (``tree_sum``); the softmax sum and the weighted sum of values are
    trees over blocks of KEY_BLOCK keys added block by block
    (:func:`_key_sum`), the keys zero-padded to whole blocks; masked
    keys weigh exactly 0 and the max is exact.  So a lane's result does
    not depend on the other lanes, on how many lanes one pass takes
    (``lane_block``, fewer where the products would pass ``lane_elems``
    elements), or on how many masked keys follow its valid ones.  A
    masked key's value is set to 0 as well, not only its probability, so
    that a recycled or trash page holding a non-finite value cannot turn
    ``0 * v`` into NaN (with finite values this changes no bit).
    """
    qs = q if isinstance(q, tuple) else (q,)
    ks = k if isinstance(k, tuple) else (k,)
    N, H = qs[0].shape[:2]
    S, Hk, Dv = v.shape[1], v.shape[2], v.shape[3]
    G = H // Hk
    Sp = -(-S // KEY_BLOCK) * KEY_BLOCK

    def lay(t):
        # [N or 1, S, h, d] -> [N or 1, h, 1, Sp, d] float32, zero-padded
        t = F.pad(t.to(torch.float32), (0, 0, 0, 0, 0, Sp - S))
        return t.permute(0, 2, 1, 3)[:, :, None]

    kts = [lay(t) for t in ks]
    vt = lay(v)
    scale = _scale(scale_dim or sum(t.shape[-1] for t in qs), qs[0].device)
    keys = torch.arange(Sp, device=qs[0].device)
    widest = max([_pow2(t.shape[-1]) for t in qs] + [Dv])
    step = max(1, min(lane_block, lane_elems // (H * Sp * widest)))
    outs = []
    for i in range(0, N, step):
        n = min(step, N - i)
        s = None
        for qp, kt in zip(qs, kts):
            qg = qp[i:i + n].to(torch.float32).reshape(n, Hk, G, 1,
                                                       qp.shape[-1])
            kb = kt if kt.shape[0] == 1 else kt[i:i + n]
            part = tree_sum(qg * kb, -1)                 # [n, Hk, G, Sp]
            s = part if s is None else s + part
        s = s / scale
        vb = vt if vt.shape[0] == 1 else vt[i:i + n]
        ln = lengths[i:i + n, None]
        valid = keys < ln
        if window is not None:
            valid = valid & (keys >= ln - window)
        valid = valid[:, None, None, :]
        s = torch.where(valid, s, NEG_INF)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = _key_sum(p, -1)                                  # [n, Hk, G]
        # masked values to 0 before the product: [n, Hk, 1, Sp, Dv],
        # G times smaller than the product
        vm = torch.where(valid[..., None], vb, 0.0)
        o = _key_sum(p[..., None] * vm, -2)                  # [n, Hk, G, Dv]
        o = o / torch.clamp(l, min=1e-30)[..., None]
        outs.append(o.reshape(n, H, Dv))
    return torch.cat(outs).to(qs[0].dtype)


def _gqa_scores(q, k):
    """q [B, Tq, H, D], k [B, Tk, Hk, D] float32 -> scores [B, Hk, G, Tq,
    Tk] divided by sqrt(D)."""
    B, Tq, H, D = q.shape
    Hk = k.shape[2]
    qg = q.reshape(B, Tq, Hk, H // Hk, D)
    return torch.einsum("bqhgd,bkhd->bhgqk", qg, k) / _scale(D, q.device)


def _keep(qpos, kpos, window):
    """[Tq, Tk] the keys each query sees causally (``window``: only the
    last ``window`` of them)."""
    keep = qpos[:, None] >= kpos[None, :]
    if window is not None:
        keep = keep & (qpos[:, None] - kpos[None, :] < window)
    return keep


def dense_attention(q, k, v, *, causal: bool, kv_mask=None, window=None):
    """Training-mode attention (JAX's ``dense_attention``): q [B, Tq, H,
    D], k [B, Tk, Hk, D], v [B, Tk, Hk, Dv]; ``kv_mask`` [B, Tk] optional;
    ``window`` a sliding window (causal only).  Masked scores are
    NEG_INF; the softmax's max takes no gradient, as ``jax.nn.softmax``'s."""
    scores = _gqa_scores(q.to(torch.float32), k.to(torch.float32))
    Tq, Tk = scores.shape[-2:]
    if causal:
        keep = _keep(torch.arange(Tq, device=q.device),
                     torch.arange(Tk, device=q.device), window)
        scores = torch.where(keep, scores, NEG_INF)
    if kv_mask is not None:
        scores = torch.where(kv_mask[:, None, None, None, :], scores, NEG_INF)
    m = scores.amax(dim=-1, keepdim=True).detach()
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    B, Hk, G = probs.shape[:3]
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.to(torch.float32))
    return out.reshape(B, Tq, Hk * G, v.shape[-1]).to(q.dtype)


def _chunk_body(qf, kb, vb, mb, c, m, l, acc, *, chunk: int, qpos, causal,
                window):
    """One KV chunk of :func:`chunked_attention`'s online softmax."""
    D = qf.shape[-1]
    s = torch.einsum("bqhgd,bkhd->bhgqk", qf, kb.to(torch.float32))
    s = s / _scale(D, qf.device)
    kpos = c * chunk + torch.arange(chunk, device=qf.device)
    valid = mb[:, None, None, None, :]
    if causal:
        valid = valid & _keep(qpos, kpos, window)[None, None, None]
    s = torch.where(valid, s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhgqk,bkhd->bhgqd", p, vb.to(torch.float32))
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, *, causal: bool, chunk: int = 1024,
                      kv_mask=None, q_offset=0, window=None):
    """JAX's ``chunked_attention``: an online softmax over KV chunks of
    ``chunk`` keys (the last zero-padded and masked), each chunk's body
    recomputed in the backward (``torch.utils.checkpoint``, JAX's
    ``jax.checkpoint``).  A fully masked chunk adds exactly nothing (its
    weights are cancelled by the next valid chunk's correction)."""
    B, Tq, H, D = q.shape
    Tk, Hk, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // Hk
    nchunk = -(-Tk // chunk)
    pad = nchunk * chunk - Tk
    if kv_mask is None:
        kv_mask = torch.ones((B, Tk), dtype=torch.bool, device=q.device)
    if pad:
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        kv_mask = F.pad(kv_mask, (0, pad))
    qf = q.to(torch.float32).reshape(B, Tq, Hk, G, D)
    qpos = torch.arange(Tq, device=q.device) + q_offset
    m = torch.full((B, Hk, G, Tq), NEG_INF, device=q.device)
    l = torch.zeros((B, Hk, G, Tq), device=q.device)
    acc = torch.zeros((B, Hk, G, Tq, Dv), device=q.device)
    body = functools.partial(_chunk_body, chunk=chunk, qpos=qpos,
                             causal=causal, window=window)
    for c in range(nchunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        args = (qf, k[:, sl], v[:, sl], kv_mask[:, sl], c, m, l, acc)
        if torch.is_grad_enabled():
            m, l, acc = torch.utils.checkpoint.checkpoint(
                body, *args, use_reentrant=False, preserve_rng_state=False)
        else:
            m, l, acc = body(*args)
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Tq, H, Dv).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool, kv_mask=None,
                    q_chunk: int = 512, kv_chunk: int = 1024, window=None):
    """JAX's ``jnp`` ``flash_attention``: q in tiles of ``q_chunk`` (the
    last zero-padded), each tile a :func:`chunked_attention` over the KV
    chunks at its own query offset: O(T) live memory forward and
    backward."""
    B, Tq, H, D = q.shape
    nq = -(-Tq // q_chunk)
    qp = F.pad(q, (0, 0, 0, 0, 0, nq * q_chunk - Tq))
    outs = [chunked_attention(qp[:, i * q_chunk:(i + 1) * q_chunk], k, v,
                              causal=causal, kv_mask=kv_mask, chunk=kv_chunk,
                              q_offset=i * q_chunk, window=window)
            for i in range(nq)]
    return torch.cat(outs, dim=1)[:, :Tq]


class Attention(nn.Module):
    """GQA projection weights: wq [d, H*D], wk/wv [d, Hk*D], wo [H*D, d],
    and under ``cfg.qkv_bias`` the biases bq [H*D], bk/bv [Hk*D] (zero
    at build, as JAX's ``init_gqa`` draws them)."""

    def __init__(self, cfg, device=None):
        super().__init__()
        H, Hk, D, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_model
        self.wq = _param(torch.empty(d, H * D, device=device))
        self.wk = _param(torch.empty(d, Hk * D, device=device))
        self.wv = _param(torch.empty(d, Hk * D, device=device))
        self.wo = _param(torch.empty(H * D, d, device=device))
        self.bq = self.bk = self.bv = None
        if cfg.qkv_bias:
            self.bq = _param(torch.zeros(H * D, device=device))
            self.bk = _param(torch.zeros(Hk * D, device=device))
            self.bv = _param(torch.zeros(Hk * D, device=device))


def _multi_proj(x, ws, rns, bs=None):
    """Several projections of ``x``; ONE shared forward conversion on the
    RNS path.  ``bs``: a bias (or None) each, added to its product after
    the conversion, as JAX's ``_multi_proj`` does."""
    if rns is None:
        ys = tuple(matmul_rows(x, w) for w in ws)
    else:
        ys = tuple(y.to(x.dtype) for y in rns_multi_dot(
            x.to(torch.float32), tuple(w.to(torch.float32) for w in ws),
            rns))
    if bs is None:
        return ys
    return tuple(y if b is None else y + b.to(y.dtype)
                 for y, b in zip(ys, bs))


def gqa_qkv(p: Attention, x, cfg, positions, rns=None):
    """q [B, T, H, D], k, v [B, T, Hk, D]; q and k rotated when
    ``cfg.pos_emb`` is rope (JAX's ``use_rope``)."""
    B, T, _ = x.shape
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q, k, v = _multi_proj(x, (p.wq, p.wk, p.wv), rns, (p.bq, p.bk, p.bv))
    q, k = q.reshape(B, T, H, D), k.reshape(B, T, Hk, D)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v.reshape(B, T, Hk, D)


def gqa_attend(p: Attention, x, cfg, *, rns=None, xkv=None,
               mode: str = "prefill"):
    """Self-attention over a whole (padded) prompt, causal unless
    ``cfg.causal`` is False, or, with ``xkv`` [B, Tk, d] (the encoder's
    output), cross-attention: q from ``x`` through ``wq``, k and v from
    ``xkv`` through ``wk``/``wv`` with one shared conversion, no mask and
    no rope.  Returns (y, (k, v)) so the caller can fill the cache.

    Every query token is a lane of :func:`lane_attention` over its row's
    keys, as a packed chunk's tokens are over their row's pages: a causal
    lane sees the keys up to its own position, any other lane all ``Tk``
    of them.  A row's causal lanes go in runs of ``CAUSAL_LANES``, each
    run over the keys its last lane sees (the keys after a lane's own
    weigh exactly 0 and add exact zeros, so a lane's floats are those of
    one call over all keys: whisper's causal encoder reads 58% of its
    1500 x 1500 scores); the lanes of a call go through in as few passes
    as ``PREFILL_LANE_ELEMS`` allows (the result does not depend on
    it).

    ``mode`` "dense" or "flash" (training): the sequence through
    :func:`dense_attention` or :func:`flash_attention` (JAX's train
    modes, with its chunk sizes) instead of lanes; training installs no
    token mask, so the cross k/v conversion takes one grid over the
    whole encoder output, as JAX's."""
    B, T, _ = x.shape
    H, Hk, D = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    if mode not in ("prefill", "dense", "flash"):
        raise ValueError(f"mode={mode!r}: prefill, dense or flash")
    if xkv is None:
        positions = torch.arange(T, device=x.device)[None].expand(B, T)
        q, k, v = gqa_qkv(p, x, cfg, positions, rns)
        Tk, causal = T, cfg.causal
    else:
        q = linear(p.wq, x, rns, b=p.bq).reshape(B, T, H, D)
        # under a prompt's per-row grids (an enc-dec prefill on the RNS
        # path) the encoder's output takes one grid a row too
        rows = None if current_token_mask() is None else torch.ones(
            xkv.shape[:2], dtype=torch.bool, device=xkv.device)
        with token_mask(rows):
            k, v = _multi_proj(xkv, (p.wk, p.wv), rns, (p.bk, p.bv))
        Tk, causal = xkv.shape[1], False
        k, v = k.reshape(B, Tk, Hk, D), v.reshape(B, Tk, Hk, D)
    window = cfg.attn_window if causal else None
    if mode != "prefill":
        fn = dense_attention if mode == "dense" else flash_attention
        out = fn(q, k, v, causal=causal, window=window)
        return linear(p.wo, out.reshape(B, T, -1), rns), (k, v)
    # runs of (first lane, end lane, keys read)
    if causal:
        lengths = torch.arange(1, T + 1, device=x.device)
        runs = [(i, min(i + CAUSAL_LANES, T), min(i + CAUSAL_LANES, T))
                for i in range(0, T, CAUSAL_LANES)]
    else:
        lengths = torch.full((T,), Tk, device=x.device)
        runs = [(0, T, Tk)]
    out = torch.stack([torch.cat([
        lane_attention(q[b, i:j], k[b:b + 1, :n], v[b:b + 1, :n],
                       lengths[i:j], window, lane_block=j - i,
                       lane_elems=PREFILL_LANE_ELEMS)
        for i, j, n in runs]) for b in range(B)])
    return linear(p.wo, out.reshape(B, T, -1), rns), (k, v)


def cross_decode(p: Attention, x, cfg, cache, layer: int, *, rns=None):
    """One-token cross-attention against attention layer ``layer``'s
    encoder planes of a dense cache (``cache.xk``/``cache.xv`` [L, B, Te,
    Hk, D], written by the prefill and read-only after): each row's
    query through ``wq`` against all ``Te`` of its frames."""
    B = x.shape[0]
    q = linear(p.wq, x, rns, b=p.bq).reshape(B, cfg.n_heads, cfg.d_head)
    xk, xv = cache.xk[layer], cache.xv[layer]
    lengths = torch.full((B,), xk.shape[1], device=x.device)
    out = lane_attention(q, xk, xv, lengths)
    return linear(p.wo, out.reshape(B, 1, -1), rns)


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


# ----------------------------------------------------------- MLA (DSv2) ---
class MLA(nn.Module):
    """Multi-head latent attention weights with the JAX package's names:
    the query down/up projections ``wdq`` [d, q_lora], ``wuqn`` [q_lora,
    H*dn], ``wuqr`` [q_lora, H*dr]; the KV down projection ``wdkv`` [d,
    r] and the shared rope key ``wkr`` [d, dr]; the up projections
    ``wuk`` [r, H*dn], ``wuv`` [r, H*v_dim]; ``wo`` [H*v_dim, d]; and the
    latent norms ``q_norm``, ``kv_norm``."""

    def __init__(self, cfg, device=None):
        super().__init__()
        m, H, d = cfg.mla, cfg.n_heads, cfg.d_model

        def w(*shape):
            return _param(torch.empty(*shape, device=device))

        self.wdq = w(d, m.q_lora_rank)
        self.wuqn = w(m.q_lora_rank, H * m.qk_nope_dim)
        self.wuqr = w(m.q_lora_rank, H * m.qk_rope_dim)
        self.wdkv = w(d, m.kv_lora_rank)
        self.wkr = w(d, m.qk_rope_dim)
        self.wuk = w(m.kv_lora_rank, H * m.qk_nope_dim)
        self.wuv = w(m.kv_lora_rank, H * m.v_dim)
        self.wo = w(H * m.v_dim, d)
        self.q_norm = RMSNorm(m.q_lora_rank, device)
        self.kv_norm = RMSNorm(m.kv_lora_rank, device)


def _mla_proj_at(p: MLA, x, cfg, positions, rns):
    """MLA projections at absolute ``positions`` [B, T]: (q_nope [B,T,H,
    dn], q_rope [B,T,H,dr] roped, c_kv [B,T,r], k_rope [B,T,dr] roped).
    The down-projection triple (wdq, wdkv, wkr) and the up-projection
    pair (wuqn, wuqr) each share one forward conversion on the RNS path.
    Per token the same math as :func:`mla_qkv` before the k/v expansion,
    so the latents a decode step caches are those a prefill caches."""
    m = cfg.mla
    B, T = x.shape[:2]
    H = cfg.n_heads
    dq, dkv, kr = _multi_proj(x, (p.wdq, p.wdkv, p.wkr), rns)
    q_nope, q_rope = _multi_proj(p.q_norm(dq), (p.wuqn, p.wuqr), rns)
    q_nope = q_nope.reshape(B, T, H, m.qk_nope_dim)
    q_rope = rope(q_rope.reshape(B, T, H, m.qk_rope_dim), positions,
                  cfg.rope_theta)
    c_kv = p.kv_norm(dkv)
    k_rope = rope(kr[:, :, None, :], positions, cfg.rope_theta)[:, :, 0]
    return q_nope, q_rope, c_kv, k_rope


def _mla_expand(p: MLA, cfg, c_kv, k_rope, rns):
    """The expanded (prefill) form's keys and values from latents c_kv
    [B, S, r], k_rope [B, S, dr]: ((k_nope [B,S,H,dn], k_rope [B,S,1,dr]),
    v [B,S,H,v_dim]) -- the keys as :func:`lane_attention` parts, the
    rope half one head read by every head."""
    m = cfg.mla
    B, S = c_kv.shape[:2]
    H = cfg.n_heads
    k_nope, v = _multi_proj(c_kv, (p.wuk, p.wuv), rns)
    return ((k_nope.reshape(B, S, H, m.qk_nope_dim), k_rope[:, :, None]),
            v.reshape(B, S, H, m.v_dim))


def mla_qkv(p: MLA, x, cfg, positions, rns=None):
    """q, k, v expanded per head ([B,T,H,dn+dr] q and k, [B,T,H,v_dim]
    v) and the latent pair (c_kv [B,T,r], k_rope [B,T,dr]) the cache
    keeps, as JAX's ``mla_qkv``."""
    q_nope, q_rope, c_kv, k_rope = _mla_proj_at(p, x, cfg, positions, rns)
    (k_nope, kr), v = _mla_expand(p, cfg, c_kv, k_rope, rns)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, kr.expand(-1, -1, k_nope.shape[2], -1)], dim=-1)
    return q, k, v, (c_kv, k_rope)


def mla_attend(p: MLA, x, cfg, *, rns=None, mode: str = "prefill"):
    """Causal MLA prefill over a whole (padded) prompt, in the expanded
    form; returns (y, (c_kv, k_rope)) for the latent cache.  Every
    prompt token is a lane of :func:`lane_attention` over the prompt's
    keys, as a packed chunk token is over its row's gathered latents.

    ``mode`` "dense" or "flash" (training): the expanded q, k, v of
    :func:`mla_qkv` through :func:`dense_attention` or
    :func:`flash_attention`, as JAX's train modes."""
    B, T, _ = x.shape
    positions = torch.arange(T, device=x.device)[None].expand(B, T)
    if mode in ("dense", "flash"):
        q, k, v, latent = mla_qkv(p, x, cfg, positions, rns)
        fn = dense_attention if mode == "dense" else flash_attention
        out = fn(q, k, v, causal=cfg.causal,
                 window=cfg.attn_window if cfg.causal else None)
        return linear(p.wo, out.reshape(B, T, -1), rns), latent
    if mode != "prefill":
        raise ValueError(f"mode={mode!r}: prefill, dense or flash")
    q_nope, q_rope, c_kv, k_rope = _mla_proj_at(p, x, cfg, positions, rns)
    ks, v = _mla_expand(p, cfg, c_kv, k_rope, rns)
    lengths = torch.arange(1, T + 1, device=x.device)
    out = torch.stack([
        lane_attention((q_nope[b], q_rope[b]),
                       tuple(t[b:b + 1] for t in ks), v[b:b + 1], lengths,
                       cfg.attn_window)
        for b in range(B)])
    return linear(p.wo, out.reshape(B, T, -1), rns), (c_kv, k_rope)


def _mla_absorbed_ctx(p: MLA, cfg, q_nope, q_rope, c_kv, k_rope, lengths,
                      window=None):
    """Absorbed-matrix latent attention (DeepSeek-V2's decode form), all
    before ``wo``: q_nope [N, H, dn], q_rope [N, H, dr] per lane against
    the latents c_kv [N or 1, S, r], k_rope [N or 1, S, dr]; ``lengths``
    [N] valid latents per lane.  Returns out [N, H, v_dim] float32.

    W_uk is absorbed into the query (q_abs = q_nope . W_uk per head) and
    W_uv into the output, so attention runs in the latent space, MQA-
    shaped (one KV head): the score is q_abs . c_kv + q_rope . k_rope
    over 1/sqrt(dn + dr).  The per-head products go through
    ``bmm_rows`` and the attention through :func:`lane_attention`, so a
    lane's floats do not depend on its batch (ROADMAP C.10).
    """
    m = cfg.mla
    H = cfg.n_heads
    r = m.kv_lora_rank
    wuk = p.wuk.reshape(r, H, m.qk_nope_dim).permute(1, 2, 0)  # [H,dn,r]
    q_abs = bmm_rows(q_nope.to(torch.float32).transpose(0, 1),
                     wuk.to(torch.float32)).transpose(0, 1)     # [N,H,r]
    lat = c_kv.to(torch.float32)[:, :, None]
    ctx = lane_attention((q_abs, q_rope), (lat, k_rope[:, :, None]), lat,
                         lengths, window,
                         scale_dim=m.qk_nope_dim + m.qk_rope_dim)
    wuv = p.wuv.reshape(r, H, m.v_dim).transpose(0, 1)          # [H,r,vd]
    out = bmm_rows(ctx.transpose(0, 1), wuv.to(torch.float32))
    return out.transpose(0, 1)                                  # [N,H,vd]


def _mla_out(p: MLA, x, out, rns):
    """``wo`` over the per-lane contexts out [R*W, H, v_dim] of x [R, W,
    d]."""
    R, W = x.shape[:2]
    return linear(p.wo, out.reshape(R, W, -1).to(x.dtype), rns)


def mla_decode(p: MLA, x, cfg, cache, layer: int, *, rns=None):
    """One-token absorbed MLA decode against MLA layer ``layer`` of a
    dense cache (``model.DenseKV``: the latent planes ``c_kv`` [L, B, S,
    r] and ``k_rope`` [L, B, S, dr]): the token's latents are written at
    each row's length (in place), then each row attends ``lengths + 1``
    latents."""
    B = x.shape[0]
    q_nope, q_rope, c_t, kr_t = _mla_proj_at(p, x, cfg,
                                             cache.lengths[:, None], rns)
    rows = torch.arange(B, device=x.device)
    cache.c_kv[layer, rows, cache.lengths] = c_t[:, 0].to(cache.c_kv.dtype)
    cache.k_rope[layer, rows, cache.lengths] = kr_t[:, 0].to(
        cache.k_rope.dtype)
    out = _mla_absorbed_ctx(p, cfg, q_nope[:, 0], q_rope[:, 0],
                            cache.c_kv[layer], cache.k_rope[layer],
                            cache.lengths + 1, cfg.attn_window)
    return _mla_out(p, x, out, rns)


def mla_decode_paged(p: MLA, x, cfg, cache, layer: int, *, rns=None):
    """One-token absorbed MLA decode against MLA layer ``layer`` of a
    paged latent cache (``ckv_pages`` [L, P, bs, r], ``krope_pages`` [L,
    P, bs, dr]): latents written into the row's current page (in
    place), the row's pages gathered, ``lengths + 1`` latents read."""
    from repro_torch.serve.kv_cache import gather_pages, write_token

    q_nope, q_rope, c_t, kr_t = _mla_proj_at(p, x, cfg,
                                             cache.lengths[:, None], rns)
    ckv, krp = cache.ckv_pages[layer], cache.krope_pages[layer]
    write_token(ckv, cache.block_table, cache.lengths, c_t[:, 0])
    write_token(krp, cache.block_table, cache.lengths, kr_t[:, 0])
    out = _mla_absorbed_ctx(p, cfg, q_nope[:, 0], q_rope[:, 0],
                            gather_pages(ckv, cache.block_table),
                            gather_pages(krp, cache.block_table),
                            cache.lengths + 1, cfg.attn_window)
    return _mla_out(p, x, out, rns)


def mla_decode_paged_window(p: MLA, x, cfg, cache, layer: int, *,
                            rns=None):
    """W-token speculative-verify MLA decode against a paged latent
    cache: x [R, W, d]; all W tokens' latents are written (in place) at
    positions ``lengths .. lengths + W - 1``, then window token i of row
    r attends ``lengths[r] + 1 + i`` latents of its row -- a lane of the
    absorbed attention, the solo decode step's float ops at that
    position.  ``lengths`` is not advanced."""
    from repro_torch.serve.kv_cache import gather_pages, write_token_window

    R, W = x.shape[:2]
    positions = cache.lengths[:, None] + torch.arange(W, device=x.device)
    q_nope, q_rope, c_t, kr_t = _mla_proj_at(p, x, cfg, positions, rns)
    ckv, krp = cache.ckv_pages[layer], cache.krope_pages[layer]
    write_token_window(ckv, cache.block_table, cache.lengths, c_t)
    write_token_window(krp, cache.block_table, cache.lengths, kr_t)
    rows = torch.arange(R, device=x.device).repeat_interleave(W)
    out = _mla_absorbed_ctx(
        p, cfg, q_nope.flatten(0, 1), q_rope.flatten(0, 1),
        gather_pages(ckv, cache.block_table)[rows],
        gather_pages(krp, cache.block_table)[rows],
        (positions + 1).reshape(-1), cfg.attn_window)
    return _mla_out(p, x, out, rns)


def mla_decode_packed(p: MLA, x, cfg, cache, layer: int, seg, pos, dec, *,
                      rns=None):
    """Packed mixed-phase MLA step against a paged latent cache: x [1, N,
    d], lane i of row ``seg[i]`` at position ``pos[i]``; ``dec`` [N]
    marks decode lanes.

    MLA's two forms are not bitwise interchangeable: a prefilled token
    attends in the expanded form, a decoded one in the absorbed form.
    So, as in JAX, the step computes both over each lane's gathered
    latents (written before the gather) and takes the absorbed context
    on decode lanes, the expanded one on chunk lanes, before the shared
    ``wo``.  Re-expanding gathered latents is exact: the pages are
    float32 (chunked prefill requires it) and the expansion's matmul
    treats each (lane, position) row on its own.  With ``rns`` on the
    attention the expansion's grids cannot be rebuilt from the cache, so
    the engine refuses chunked MLA with ``rns_targets="all"``.
    """
    from repro_torch.serve.kv_cache import gather_pages, write_packed_tokens

    q_nope, q_rope, c_t, kr_t = _mla_proj_at(p, x, cfg, pos[None], rns)
    ckv, krp = cache.ckv_pages[layer], cache.krope_pages[layer]
    write_packed_tokens(ckv, cache.block_table, seg, pos, c_t[0])
    write_packed_tokens(krp, cache.block_table, seg, pos, kr_t[0])
    segc = seg.clamp(0, cache.block_table.shape[0] - 1)
    c_kv = gather_pages(ckv, cache.block_table)[segc]              # [N,S,r]
    k_rope = gather_pages(krp, cache.block_table)[segc]            # [N,S,dr]
    qn, qr = q_nope[0], q_rope[0]
    abs_out = _mla_absorbed_ctx(p, cfg, qn, qr, c_kv, k_rope, pos + 1,
                                cfg.attn_window)
    ks, v = _mla_expand(p, cfg, c_kv, k_rope, rns)
    exp_out = lane_attention((qn, qr), ks, v, pos + 1, cfg.attn_window)
    out = torch.where(dec[:, None, None], abs_out,
                      exp_out.to(torch.float32))
    return _mla_out(p, x, out, rns)
