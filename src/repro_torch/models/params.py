"""Weights carried across from the JAX package.

``repro.models.model.init_model`` returns a parameter tree (GQA or MLA
attention, dense or MoE MLPs, an ``lm_head`` when untied) whose blocks
are stacked per period (``repro/models/transformer.py:93``): leaf
``blocks["l{j}"][...]`` has a leading ``n_layers // period`` dim, and
layer ``i`` is entry ``i // period`` of sub-layer ``l{i % period}``.
:func:`params_from_jax` takes that tree as numpy arrays (e.g.
``jax.tree.map(np.asarray, params)``), undoes the stacking and fills the
port's modules.  The port itself never imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.attention import MLA
from repro_torch.models.model import Model

__all__ = ["params_from_jax"]

_MLA_LINEARS = ("wdq", "wuqn", "wuqr", "wdkv", "wkr", "wuk", "wuv", "wo")


def params_from_jax(tree: dict, cfg, device="cuda") -> Model:
    """A :class:`Model` holding the JAX parameter ``tree`` (numpy leaves)."""
    model = Model(cfg, device)
    p = cfg.period

    def put(param: torch.Tensor, value):
        value = np.array(value, np.float32)     # a writable copy
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"shape {value.shape} for {tuple(param.shape)}")
        param.copy_(torch.from_numpy(value))

    def put_mlp(mlp, tp, at):
        for name in ("wi", "wg", "wo"):
            put(getattr(mlp, name), tp[name]["w"][at])

    with torch.no_grad():
        put(model.embed, tree["embed"]["table"])
        put(model.final_norm.scale, tree["final_norm"]["scale"])
        if model.lm_head is not None:
            put(model.lm_head, tree["lm_head"]["w"])
        for i, blk in enumerate(model.blocks):
            lp = tree["blocks"][f"l{i % p}"]
            at = i // p
            put(blk.ln1.scale, lp["ln1"]["scale"][at])
            put(blk.ln2.scale, lp["ln2"]["scale"][at])
            ta = lp["attn"]
            if isinstance(blk.attn, MLA):
                for name in _MLA_LINEARS:
                    put(getattr(blk.attn, name), ta[name]["w"][at])
                put(blk.attn.q_norm.scale, ta["q_norm"]["scale"][at])
                put(blk.attn.kv_norm.scale, ta["kv_norm"]["scale"][at])
            else:
                for name in ("wq", "wk", "wv", "wo"):
                    put(getattr(blk.attn, name), ta[name]["w"][at])
            if hasattr(blk, "moe"):
                tm = lp["moe"]
                put(blk.moe.router, tm["router"]["w"][at])
                for name in ("wi", "wg", "wo"):
                    put(getattr(blk.moe, name), tm[name][at])
                if blk.moe.shared is not None:
                    put_mlp(blk.moe.shared, tm["shared"], at)
            else:
                put_mlp(blk.mlp, lp["mlp"], at)
    return model
