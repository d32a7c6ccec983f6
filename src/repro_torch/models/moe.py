"""Mixture-of-Experts: top-k router, capacity dispatch, shared experts.

The port of ``repro.models.moe`` with both of its dispatches.  The
routing is JAX's to the integer: top-k through a stable descending sort
(``jax.lax.top_k`` puts the lower index first on ties), each (token,
expert) entry's slot its rank among the row's entries for that expert in
token order (JAX's stable argsort over the flat ``[S*k]`` ids), entries
at or past the row's capacity ``C = max(1, int(S * k / E *
capacity_factor))`` dropped.  The kept outputs are weighted by their
(renormalized) router probability and added per token: in expert order
with ``dispatch="gather"`` (JAX's scatter-add over the ``[E, C]``
slots), in the order of the token's k picks with ``dispatch="scatter"``
(JAX's sum over the picks); then the shared expert.

The routed experts are float on the RNS path too (JAX computes them as
einsums); only the shared MLP takes ``rns``.  Every float sum is
batch-invariant (ROADMAP C.10): the router goes through
``layers.matmul_rows``, the expert stacks through ``layers.bmm_rows``,
the softmax and top-k renormalization sums through ``layers.tree_sum``.
Every expert runs over every token of the call and its output is kept
where the token is routed to it, so the step's shapes do not depend on
the routing and it can be captured in a CUDA graph; a token's floats
are those of its routed rows alone (``bmm_rows`` treats rows
independently).  The cost: every expert's weights are read and every
row computed, E / k times the routed work (ROADMAP C.12).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models.layers import (MLP, ROW_BLOCK, _param, act_fn,
                                       bmm_rows, init_normal_, matmul_rows,
                                       mlp, tree_sum)

__all__ = ["MoEConfig", "MoE", "init_moe", "route", "moe_ffn"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0           # always-on shared experts (DeepSeek-style)
    capacity_factor: float = 1.25
    router_norm_topk: bool = True   # renormalize top-k probs to sum to 1
    aux_loss_weight: float = 0.01
    dispatch: str = "gather"    # gather|scatter: the combine's order


class MoE(nn.Module):
    """MoE weights with JAX's names: ``router`` [d, E], the expert stacks
    ``wi``/``wg`` [E, d, F] and ``wo`` [E, F, d], and ``shared`` (an
    :class:`MLP` of width ``F * n_shared``, or None)."""

    def __init__(self, d: int, cfg: MoEConfig, device=None):
        super().__init__()
        E, F_ = cfg.n_experts, cfg.d_ff_expert
        self.router = _param(torch.empty(d, E, device=device))
        self.wi = _param(torch.empty(E, d, F_, device=device))
        self.wg = _param(torch.empty(E, d, F_, device=device))
        self.wo = _param(torch.empty(E, F_, d, device=device))
        self.shared = (MLP(d, F_ * cfg.n_shared, True, device)
                       if cfg.n_shared else None)


def init_moe(d: int, cfg: MoEConfig, *, seed: int = 0,
             device="cuda") -> MoE:
    """Random weights with JAX's scales: router N(0, 1/d), ``wi``/``wg``
    N(0, 1/d), ``wo`` N(0, 1/F), the shared MLP N(0, 1/d_in)."""
    m = MoE(d, cfg, device)
    init_normal_(m, torch.Generator(device=device).manual_seed(seed))
    return m


def route(p: MoE, x: torch.Tensor, cfg: MoEConfig):
    """JAX's router and gather dispatch for ``x`` [B, S, d].

    Returns (top_i [B, S, k] expert ids, top_p [B, S, k] float32 weights,
    keep [B, S, k] bool: the entry is within its expert's capacity,
    aux scalar: the Switch load-balancing loss)."""
    B, S, _ = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = max(1, int(S * k / E * cfg.capacity_factor))
    logits = matmul_rows(x, p.router).to(torch.float32)          # [B,S,E]
    # the max takes no gradient, as in jax.nn.softmax
    ex = torch.exp(logits - logits.amax(dim=-1, keepdim=True).detach())
    probs = ex / tree_sum(ex, -1)[..., None]
    # stable descending sort: the lower expert id first on ties
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[..., :k], top_i[..., :k]
    if cfg.router_norm_topk:
        top_p = top_p / torch.clamp(tree_sum(top_p, -1), min=1e-9)[..., None]
    # slot = rank among the row's entries for the same expert, in flat
    # [S*k] order (JAX's stable argsort); kept below the capacity.  No
    # host sync (a captured step cannot have one): counts by comparison
    flat = top_i.reshape(B, S * k)
    experts = torch.arange(E, device=x.device)
    seen = (flat[..., None] == experts).to(torch.int64).cumsum(dim=1)
    rank = seen.gather(2, flat[..., None])[..., 0] - 1           # [B,S*k]
    keep = (rank < C).reshape(B, S, k)
    # Switch load balancing: E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    fe = seen[:, -1].sum(dim=0).to(torch.float32) / (B * S)
    aux = cfg.aux_loss_weight * E * torch.sum(me * fe)
    return top_i, top_p, keep, aux


def moe_ffn(p: MoE, x: torch.Tensor, cfg: MoEConfig, *, act: str = "silu",
            rns=None):
    """x [B, S, d] -> (y [B, S, d], aux scalar), JAX's ``moe_ffn``.
    ``rns`` applies to the shared MLP only."""
    if cfg.dispatch not in ("gather", "scatter"):
        raise ValueError(f"MoE dispatch={cfg.dispatch!r}: gather|scatter")
    B, S, d = x.shape
    E = cfg.n_experts
    top_i, top_p, keep, aux = route(p, x, cfg)
    # every expert over every token: [E, N, d] through the stacks, one
    # fixed-shape batched matmul per block of rows (``bmm_rows``); the
    # rows padded once before the expansion over experts (a view)
    N = B * S
    xs = F.pad(x.reshape(N, d), (0, 0, 0, -(-N // ROW_BLOCK) * ROW_BLOCK - N))
    xs = xs[None].expand(E, -1, -1)
    f = act_fn(act) if act == "silu" else act_fn("gelu")
    h = f(bmm_rows(xs, p.wg)) * bmm_rows(xs, p.wi)
    out = bmm_rows(h, p.wo)[:, :N].to(torch.float32)          # [E, N, d]
    if cfg.dispatch == "scatter":
        # each token's k picks in rank order, a dropped pick adding an
        # exact 0 (JAX's sum over the [B, S, k, d] gathered outputs)
        picks = top_i.reshape(N, -1)
        w = torch.where(keep, top_p, 0.0).reshape(N, -1)
        tok = torch.arange(N, device=x.device)
        y = None
        for j in range(picks.shape[1]):
            got = out[picks[:, j], tok] * w[:, j, None]
            y = got if y is None else y + got
    else:
        # each token's weight for every expert: its (renormalized) router
        # probability where routed and kept, else 0 (top-k ids are
        # distinct, so at most one of its k entries names an expert: an
        # exact sum)
        onehot = top_i[..., None] == torch.arange(E, device=x.device)
        hit = onehot & keep[..., None]                         # [B,S,k,E]
        gate = (torch.where(keep, top_p, 0.0)[..., None] * hit).sum(dim=2)
        routed = hit.any(dim=2).reshape(N, E).T[..., None]     # [E,N,1]
        out = out * gate.reshape(N, E).T[..., None]
        # added per token in expert order, as JAX's scatter-add over the
        # [E, C] slots: 0 + c_e1 + c_e2 + ..., an unrouted expert adding
        # nothing
        y = torch.zeros((N, d), dtype=torch.float32, device=x.device)
        for e in range(E):
            y = torch.where(routed[e], y + out[e], y)
    y = y.reshape(B, S, d)
    if p.shared is not None:
        y = y + mlp(p.shared, x, gated=True, act=act, rns=rns)
    return y.to(x.dtype), aux
