"""Weights carried across from the JAX package.

``repro.models.model.init_model`` returns a parameter tree (GQA or MLA
attention, Mamba or RWKV-6 layers, dense or MoE MLPs, an ``lm_head`` when
untied; an encoder-decoder's ``enc_blocks``, ``enc_norm`` and each
decoder attention layer's ``lnx`` and ``xattn``) whose blocks are
stacked per period (``repro/models/transformer.py:93``): leaf
``blocks["l{j}"][...]`` has a leading ``n_layers // period`` dim, and
layer ``i`` is entry ``i // period`` of sub-layer ``l{i % period}``;
the encoder stack's period is 1 (``enc_blocks["l0"]``, one entry a
layer).  :func:`params_from_jax` takes
that tree as numpy arrays (e.g. ``jax.tree.map(np.asarray, params)``),
undoes the stacking and fills the port's modules; it fails unless every
entry of every leaf landed in a parameter.  :func:`opt_state_from_jax`
does the same for JAX's AdamW state (``m`` and ``v`` are trees like the
parameters), giving the port's state keyed by parameter name.  The port
itself never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import MLA
from repro_torch.models.model import Model

__all__ = ["params_from_jax", "opt_state_from_jax"]

_MLA_LINEARS = ("wdq", "wuqn", "wuqr", "wdkv", "wkr", "wuk", "wuv", "wo")
# port name -> JAX path inside the layer's "mamba" / "rwkv" dict
_MAMBA = {"in_proj": ("in_proj", "w"), "conv_w": ("conv_w",),
          "conv_b": ("conv_b",), "x_proj": ("x_proj", "w"),
          "dt_proj": ("dt_proj", "w"), "dt_proj_b": ("dt_proj", "b"),
          "A_log": ("A_log",), "D": ("D",), "out_proj": ("out_proj", "w")}
_RWKV = {**{n: (n, "w") for n in ("wr", "wk", "wv", "wg", "wout", "wA",
                                  "wB", "ck", "cv", "cr")},
         **{n: (n,) for n in ("mix", "w0", "u", "cmix")},
         "ln_x.scale": ("ln_x", "scale"), "ln_x.bias": ("ln_x", "bias"),
         "ln_cm.scale": ("ln_cm", "scale"), "ln_cm.bias": ("ln_cm", "bias")}


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    else:
        yield path, tree


def params_from_jax(tree: dict, cfg, device="cuda") -> Model:
    """A :class:`Model` holding the JAX parameter ``tree`` (numpy leaves)."""
    model = Model(cfg, device)
    p = cfg.period
    taken: set = set()

    def put(param: torch.Tensor, *path, at=None):
        value = tree
        for k in path:
            value = value[k]
        if at is not None:
            value = value[at]
        value = np.array(value, np.float32)     # a writable copy
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"{'/'.join(path)}: shape {value.shape} for "
                             f"{tuple(param.shape)}")
        param.copy_(torch.from_numpy(value))
        taken.add((path, at))

    def put_norm(ln, *path, at):
        put(ln.scale, *path, "scale", at=at)
        if hasattr(ln, "bias"):
            put(ln.bias, *path, "bias", at=at)

    def put_gqa(a, *path, at):
        for name in ("wq", "wk", "wv", "wo"):
            put(getattr(a, name), *path, name, "w", at=at)
        for name in ("q", "k", "v"):
            b = getattr(a, "b" + name)
            if b is not None:
                put(b, *path, "w" + name, "b", at=at)

    layers = [(blk, ("blocks", f"l{i % p}"), i // p)
              for i, blk in enumerate(model.blocks)]
    if model.enc_blocks is not None:
        layers += [(blk, ("enc_blocks", "l0"), i)
                   for i, blk in enumerate(model.enc_blocks)]
    with torch.no_grad():
        put(model.embed, "embed", "table")
        put_norm(model.final_norm, "final_norm", at=None)
        if model.lm_head is not None:
            put(model.lm_head, "lm_head", "w")
        if model.enc_norm is not None:
            put_norm(model.enc_norm, "enc_norm", at=None)
        for blk, lp, at in layers:
            put_norm(blk.ln1, *lp, "ln1", at=at)
            if hasattr(blk, "ln2"):
                put_norm(blk.ln2, *lp, "ln2", at=at)
            if hasattr(blk, "xattn"):
                put_norm(blk.lnx, *lp, "lnx", at=at)
                put_gqa(blk.xattn, *lp, "xattn", at=at)
            if isinstance(getattr(blk, "attn", None), MLA):
                for name in _MLA_LINEARS:
                    put(getattr(blk.attn, name), *lp, "attn", name, "w",
                        at=at)
                put_norm(blk.attn.q_norm, *lp, "attn", "q_norm", at=at)
                put_norm(blk.attn.kv_norm, *lp, "attn", "kv_norm", at=at)
            elif hasattr(blk, "attn"):
                put_gqa(blk.attn, *lp, "attn", at=at)
            for kind, names in (("mamba", _MAMBA), ("rwkv", _RWKV)):
                mod = getattr(blk, kind, None)
                if mod is None:
                    continue
                params = dict(mod.named_parameters())
                for name, path in names.items():
                    put(params[name], *lp, kind, *path, at=at)
            if hasattr(blk, "moe"):
                put(blk.moe.router, *lp, "moe", "router", "w", at=at)
                for name in ("wi", "wg", "wo"):
                    put(getattr(blk.moe, name), *lp, "moe", name, at=at)
                if blk.moe.shared is not None:
                    for name in ("wi", "wg", "wo"):
                        put(getattr(blk.moe.shared, name), *lp, "moe",
                            "shared", name, "w", at=at)
            elif hasattr(blk, "mlp"):
                for name in ("wi", "wg", "wo"):
                    if getattr(blk.mlp, name) is not None:
                        put(getattr(blk.mlp, name), *lp, "mlp", name, "w",
                            at=at)
    want = set()
    for path, leaf in _leaves(tree):
        if path[0] in ("blocks", "enc_blocks"):
            want |= {(path, at) for at in range(np.shape(leaf)[0])}
        else:
            want.add((path, None))
    missed = sorted(want - taken)
    if missed:
        raise ValueError(f"{len(missed)} JAX leaf entries landed nowhere, "
                         f"e.g. {missed[:3]}")
    return model


def opt_state_from_jax(tree: dict, cfg, device="cuda") -> dict:
    """The port's AdamW state ({"m": {name: tensor}, "v": ..., "step":
    int32}, names those of ``Model.named_parameters``) from JAX's
    ``init_opt_state`` / ``adamw_update`` state (numpy leaves)."""
    out = {}
    for key in ("m", "v"):
        trees = params_from_jax(tree[key], cfg, device)
        out[key] = {n: p.detach() for n, p in trees.named_parameters()}
    out["step"] = torch.tensor(int(np.asarray(tree["step"])),
                               dtype=torch.int32, device=device)
    return out
