"""State-space / linear-recurrence layers: Mamba-1 (Jamba) and RWKV-6
(Finch), the port of ``repro.models.ssm``.

Each layer runs a whole prompt (chunks of ``SSMConfig.chunk`` time steps
with the state carried from chunk to chunk) or one decode token against
the state it carried.  The projections in and out of the recurrences go
through :func:`~repro_torch.models.layers.linear` (the RNS datapath when
``rns`` is given); the recurrences themselves are float32 elementwise
code, as in JAX, where no Pallas kernel computes them.

Padding: JAX pads every call to a whole chunk with identity steps (Mamba
``a = 1, bx = 0``; RWKV ``w = 1, r = k = v = 0``) and drops their outputs.
An identity step changes no bit of the state (``1 * h + 0 = h``) and of
no kept output, so the port runs the real steps only: a decode token is
one step, not a chunk of 256.

Every float sum is batch-invariant (ROADMAP C.10): the Mamba read-out over
``d_state``, RWKV's bonus, its stepwise read-out and its per-head norm
are :func:`~repro_torch.models.layers.tree_sum`; the chunked RWKV form's
contractions are :func:`~repro_torch.models.layers.bmm_rows` calls, one
row of the batch at a time over its heads, so their shapes do not depend
on the batch; its cumulative log-decay is a sequential sum over time.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import LayerNorm, _param, bmm_rows, linear, \
    tree_sum

__all__ = ["SSMConfig", "Mamba", "init_mamba", "mamba_seq", "mamba_step",
           "associative_scan", "RWKV6", "init_rwkv6", "rwkv6_timemix",
           "rwkv6_channelmix"]


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    kind: str = "mamba"       # "mamba" | "rwkv6"
    d_state: int = 16         # mamba N
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None
    head_dim: int = 64        # rwkv6 head size
    chunk: int = 256          # recurrence chunk length
    impl: str = "scan"        # rwkv6: "scan" (stepwise) | "chunked" (GLA form)


# ================================================================ Mamba ====
def _dt_rank(d_model: int, cfg: SSMConfig) -> int:
    return cfg.dt_rank or max(1, d_model // 16)


class Mamba(nn.Module):
    """Mamba-1 weights with JAX's names: ``in_proj`` [d, 2 d_in],
    ``conv_w`` [K, d_in], ``conv_b`` [d_in], ``x_proj`` [d_in, R + 2N],
    ``dt_proj`` [R, d_in] with its bias ``dt_proj_b`` [d_in], ``A_log``
    [d_in, N], ``D`` [d_in] and ``out_proj`` [d_in, d]."""

    def __init__(self, d_model: int, cfg: SSMConfig, device=None):
        super().__init__()
        d_in, N, R = cfg.expand * d_model, cfg.d_state, _dt_rank(d_model, cfg)

        def w(*shape):
            return _param(torch.empty(*shape, device=device))

        self.in_proj = w(d_model, 2 * d_in)
        self.conv_w = w(cfg.d_conv, d_in)
        self.conv_b = _param(torch.zeros(d_in, device=device))
        self.x_proj = w(d_in, R + 2 * N)
        self.dt_proj = w(R, d_in)
        self.dt_proj_b = w(d_in)
        self.A_log = w(d_in, N)
        self.D = _param(torch.ones(d_in, device=device))
        self.out_proj = w(d_in, d_model)

    @torch.no_grad()
    def init_(self, g: torch.Generator):
        """JAX's ``init_mamba`` scales: projections N(0, 1/d_in), the
        conv taps N(0, 0.2^2), ``dt_proj_b`` the inverse softplus of a
        log-uniform dt in [1e-3, 1e-1], ``A_log = log(1..N)``, ``D``
        ones."""
        for p in (self.in_proj, self.x_proj, self.dt_proj, self.out_proj):
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[0]), generator=g)
        self.conv_w.normal_(0.0, 0.2, generator=g)
        u = torch.empty_like(self.dt_proj_b).uniform_(
            math.log(1e-3), math.log(1e-1), generator=g)
        self.dt_proj_b.copy_(torch.log(torch.expm1(torch.exp(u))))
        a = np.log(np.arange(1, self.A_log.shape[1] + 1, dtype=np.float32))
        self.A_log.copy_(torch.as_tensor(a).expand_as(self.A_log))
        self.D.fill_(1.0)


def init_mamba(d_model: int, cfg: SSMConfig, *, seed: int = 0,
               device="cuda") -> Mamba:
    m = Mamba(d_model, cfg, device)
    m.init_(torch.Generator(device=device).manual_seed(seed))
    return m


def associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Prefix composition of the affine maps ``h -> a_t h + b_t`` along
    dim 0 (``comb(l, r) = (r.a * l.a, r.a * l.b + r.b)``), by JAX's
    ``lax.associative_scan`` recursion: pairs combined, the half scanned,
    the even entries filled in from the odd ones.  Entry t is the same
    float ops whatever the length past t."""
    n = a.shape[0]
    if n < 2:
        return a, b
    ra = a[1::2]
    odd_a, odd_b = associative_scan(ra * a[0:-1:2], ra * b[0:-1:2] + b[1::2])
    la, lb = (odd_a[:-1], odd_b[:-1]) if n % 2 == 0 else (odd_a, odd_b)
    ea, eb = a[2::2], b[2::2]
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[0], out_b[0] = a[0], b[0]
    out_a[2::2], out_b[2::2] = ea * la, ea * lb + eb
    out_a[1::2], out_b[1::2] = odd_a, odd_b
    return out_a, out_b


def mamba_seq(p: Mamba, x, cfg: SSMConfig, *, rns=None, h0=None, conv0=None):
    """x [B, T, d] -> (y [B, T, d], (h_last [B, d_in, N] float32,
    conv_tail [B, K-1, d_in])): the selective scan, chunk by chunk, from
    the state (``h0``, ``conv0``; zeros when None)."""
    B, T, d = x.shape
    N, K = cfg.d_state, cfg.d_conv
    xs, z = linear(p.in_proj, x, rns).chunk(2, dim=-1)     # [B, T, d_in]
    d_in = xs.shape[-1]
    tail = conv0 if conv0 is not None else xs.new_zeros((B, K - 1, d_in))
    xpad = torch.cat([tail, xs], dim=1)                    # promotes, as JAX
    xc = 0
    for i in range(K):
        xc = xc + xpad[:, i:i + T] * p.conv_w[i][None, None]
    xc = F.silu(xc + p.conv_b[None, None])
    new_tail = xpad[:, T:]

    dbc = linear(p.x_proj, xc, rns)
    R = dbc.shape[-1] - 2 * N
    dt, Bc, Cc = dbc.split([R, N, N], dim=-1)
    dt = F.softplus(linear(p.dt_proj, dt, rns, b=p.dt_proj_b))
    A = -torch.exp(p.A_log.to(torch.float32))              # [d_in, N]
    # time first: [T, B, d_in, N]
    a = torch.exp(dt.to(torch.float32).transpose(0, 1)[..., None] * A)
    bx = ((dt * xc).to(torch.float32).transpose(0, 1)[..., None]
          * Bc.to(torch.float32).transpose(0, 1)[:, :, None, :])
    h = h0 if h0 is not None else a.new_zeros((B, d_in, N))
    hs = []
    for t0 in range(0, T, cfg.chunk):
        a_all, b_all = associative_scan(a[t0:t0 + cfg.chunk],
                                        bx[t0:t0 + cfg.chunk])
        hc = a_all * h[None] + b_all
        hs.append(hc)
        h = hc[-1]
    h_seq = torch.cat(hs).transpose(0, 1)                  # [B, T, d_in, N]
    y = tree_sum(h_seq * Cc.to(torch.float32)[:, :, None, :], -1)
    y = (y + xc.to(torch.float32) * p.D[None, None]) * F.silu(
        z.to(torch.float32))
    return linear(p.out_proj, y.to(x.dtype), rns), (h, new_tail)


def mamba_step(p: Mamba, x, cfg: SSMConfig, state, *, rns=None):
    """One-token step.  state = (h [B, d_in, N], conv_tail [B, K-1, d_in])."""
    return mamba_seq(p, x, cfg, rns=rns, h0=state[0], conv0=state[1])


# ================================================================ RWKV-6 ===
#: rank of the data-dependent decay's low-rank (wA, wB) projection
DECAY_LORA = 64


class RWKV6(nn.Module):
    """RWKV-6 weights with JAX's names: time-mix ``wr wk wv wg wout`` [d,
    d], the token-shift mixes ``mix`` [5, d], the decay ``w0`` [d] and
    its low-rank ``wA`` [d, 64], ``wB`` [64, d], the bonus ``u`` [H, D],
    the per-head norm ``ln_x``; channel-mix ``ck`` [d, d_ff], ``cv``
    [d_ff, d], ``cr`` [d, d], ``cmix`` [2, d] and its norm ``ln_cm``."""

    def __init__(self, d_model: int, cfg: SSMConfig, d_ff: int, device=None):
        super().__init__()
        H = d_model // cfg.head_dim

        def w(*shape):
            return _param(torch.empty(*shape, device=device))

        self.wr, self.wk, self.wv, self.wg, self.wout = (
            w(d_model, d_model) for _ in range(5))
        self.mix = w(5, d_model)
        self.w0 = w(d_model)
        self.wA = w(d_model, DECAY_LORA)
        self.wB = w(DECAY_LORA, d_model)
        self.u = w(H, cfg.head_dim)
        self.ln_x = LayerNorm(d_model, device)
        self.ln_cm = LayerNorm(d_model, device)
        self.ck = w(d_model, d_ff)
        self.cv = w(d_ff, d_model)
        self.cr = w(d_model, d_model)
        self.cmix = w(2, d_model)

    @torch.no_grad()
    def init_(self, g: torch.Generator):
        """JAX's ``init_rwkv6`` scales: projections N(0, 1/d_in), the
        mixes U(0, 1), ``w0`` evenly from -6 to -1, ``u`` N(0, 0.1^2),
        norms one and zero."""
        for p in (self.wr, self.wk, self.wv, self.wg, self.wout, self.wA,
                  self.wB, self.ck, self.cv, self.cr):
            p.normal_(0.0, 1.0 / math.sqrt(p.shape[0]), generator=g)
        self.mix.uniform_(0.0, 1.0, generator=g)
        self.cmix.uniform_(0.0, 1.0, generator=g)
        self.u.normal_(0.0, 0.1, generator=g)
        self.w0.copy_(torch.as_tensor(np.linspace(
            -6.0, -1.0, self.w0.shape[0], dtype=np.float32)))
        for ln in (self.ln_x, self.ln_cm):
            ln.scale.fill_(1.0)
            ln.bias.zero_()


def init_rwkv6(d_model: int, cfg: SSMConfig, d_ff: int, *, seed: int = 0,
               device="cuda") -> RWKV6:
    m = RWKV6(d_model, cfg, d_ff, device)
    m.init_(torch.Generator(device=device).manual_seed(seed))
    return m


def _shift(x, x_prev_0):
    """Each token's predecessor: ``x_prev_0`` [B, 1, d] (zeros when None)
    before the first, in x's promoted dtype as JAX's concatenate gives."""
    if x_prev_0 is None:
        x_prev_0 = x.new_zeros((x.shape[0], 1, x.shape[2]))
    return torch.cat([x_prev_0, x[:, :-1]], dim=1)


def _rwkv_chunk(S, r, k, v, w, u):
    """The stepwise WKV recurrence over one chunk: S [B, H, D, D]
    (k-major), r/k/v/w [L, B, H, D], u [H, D] -> (S, outs [L, B, H, D])."""
    ub = u[None][..., None]                                 # [1, H, D, 1]
    outs = []
    for t in range(r.shape[0]):
        kv = k[t][..., :, None] * v[t][..., None, :]       # [B, H, D, D]
        outs.append(tree_sum(r[t][..., :, None] * (S + ub * kv), -2))
        S = w[t][..., None] * S + kv
    return S, torch.stack(outs)


def _per_row(x, w):
    """``x [G, M, K] @ w [G, K, N]`` batch row by batch row: x and w
    carry the batch first ([B, H, ...]) and each row is one
    :func:`bmm_rows` call over its H heads."""
    return torch.stack([bmm_rows(x[b], w[b]) for b in range(x.shape[0])])


def _rwkv_chunk_matmul(S0, r, k, v, w, u):
    """The chunked matmul (GLA) form of the WKV recurrence, as JAX's
    ``_rwkv_chunk_matmul``: per-channel decays factored as
    exp(cumsum(log w)), exponents clamped at +-30.  S0 [B, H, D, D],
    r/k/v/w [L, B, H, D], u [H, D] -> (S_next, outs [L, B, H, D])."""
    lw = torch.log(torch.clamp(w, min=1e-38))
    cum = [lw[0]]
    for t in range(1, lw.shape[0]):                     # inclusive, in order
        cum.append(cum[-1] + lw[t])
    cum = torch.stack(cum)
    q2 = r * torch.exp(cum - lw)                        # r_i * P_{i-1}
    k2 = k * torch.exp(-torch.clamp(cum, min=-30.0))    # k_j / P_j
    L = r.shape[0]

    def bh(t):                                          # [B, H, L, D]
        return t.permute(1, 2, 0, 3)

    scores = _per_row(bh(q2), bh(k2).transpose(-1, -2))  # [B, H, L, L]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    scores = torch.where(mask, scores, 0.0)
    inter = _per_row(scores, bh(v))                     # [B, H, L, D]
    direct = _per_row(bh(q2), S0)                       # [B, H, L, E]
    bonus = tree_sum(r * u[None, None] * k, -1)[..., None] * v
    outs = (inter + direct).permute(2, 0, 1, 3) + bonus
    p_last = cum[-1]                                    # [B, H, D]
    kdec = k * torch.exp(torch.clamp(p_last[None] - cum, max=30.0))
    S_next = torch.exp(p_last)[..., None] * S0 + _per_row(
        bh(kdec).transpose(-1, -2), bh(v))
    return S_next, outs


def rwkv6_timemix(p: RWKV6, x, cfg: SSMConfig, *, rns=None, state=None):
    """x [B, T, d] -> (y, (S_last [B, H, D, D] float32, x_last [B, 1,
    d])); ``state`` carries (S, the previous token)."""
    B, T, d = x.shape
    D = cfg.head_dim
    H = d // D
    x_prev = _shift(x, None if state is None else state[1])

    def mix(i):
        return x + (x_prev - x) * p.mix[i][None, None]

    xr, xk, xv, xw, xg = (mix(i) for i in range(5))
    r = linear(p.wr, xr, rns).reshape(B, T, H, D)
    k = linear(p.wk, xk, rns).reshape(B, T, H, D)
    v = linear(p.wv, xv, rns).reshape(B, T, H, D)
    g = F.silu(linear(p.wg, xg, rns))
    # data-dependent decay (Finch)
    wlog = p.w0[None, None] + linear(p.wB, torch.tanh(linear(p.wA, xw, rns)),
                                     rns)
    w = torch.exp(-torch.exp(wlog.to(torch.float32))).reshape(B, T, H, D)
    r, k, v, w = (t.to(torch.float32).transpose(0, 1) for t in (r, k, v, w))
    u = p.u.to(torch.float32)
    S = state[0] if state is not None else x.new_zeros(
        (B, H, D, D), dtype=torch.float32)
    step = _rwkv_chunk_matmul if cfg.impl == "chunked" else _rwkv_chunk
    outs = []
    for t0 in range(0, T, cfg.chunk):
        sl = slice(t0, t0 + cfg.chunk)
        S, o = step(S, r[sl], k[sl], v[sl], w[sl], u)
        outs.append(o)
    y = torch.cat(outs).transpose(0, 1)                 # [B, T, H, D]
    # GroupNorm over each head's D dims
    mu = (tree_sum(y, -1) / D)[..., None]
    var = (tree_sum(torch.square(y - mu), -1) / D)[..., None]
    y = ((y - mu) * torch.rsqrt(var + 1e-5)).reshape(B, T, d)
    y = (y * p.ln_x.scale[None, None] + p.ln_x.bias[None, None]).to(
        x.dtype) * g
    return linear(p.wout, y, rns), (S, x[:, -1:])


def rwkv6_channelmix(p: RWKV6, x, *, rns=None, state=None):
    """RWKV channel-mix (the FFN analogue); ``state`` carries the
    previous token.  Returns (y, x_last [B, 1, d])."""
    x_prev = _shift(x, state)
    xk = x + (x_prev - x) * p.cmix[0][None, None]
    xr = x + (x_prev - x) * p.cmix[1][None, None]
    kk = torch.square(F.relu(linear(p.ck, xk, rns)))
    out = torch.sigmoid(linear(p.cr, xr, rns)) * linear(p.cv, kk, rns)
    return out, x[:, -1:]
