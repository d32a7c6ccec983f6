"""Weights carried across from the JAX package.

``repro.models.model.init_model`` returns a parameter tree whose blocks
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

from repro_torch.models.model import Model

__all__ = ["params_from_jax"]


def params_from_jax(tree: dict, cfg, device="cuda") -> Model:
    """A :class:`Model` holding the JAX parameter ``tree`` (numpy leaves)."""
    model = Model(cfg, device)
    p = cfg.period

    def put(param: torch.Tensor, value):
        value = np.array(value, np.float32)     # a writable copy
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(f"shape {value.shape} for {tuple(param.shape)}")
        param.copy_(torch.from_numpy(value))

    with torch.no_grad():
        put(model.embed, tree["embed"]["table"])
        put(model.final_norm.scale, tree["final_norm"]["scale"])
        for i, blk in enumerate(model.blocks):
            lp = tree["blocks"][f"l{i % p}"]
            at = i // p
            put(blk.ln1.scale, lp["ln1"]["scale"][at])
            put(blk.ln2.scale, lp["ln2"]["scale"][at])
            for name in ("wq", "wk", "wv", "wo"):
                put(getattr(blk.attn, name), lp["attn"][name]["w"][at])
            for name in ("wi", "wg", "wo"):
                put(getattr(blk.mlp, name), lp["mlp"][name]["w"][at])
    return model
