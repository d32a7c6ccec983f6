"""AdamW, its learning-rate schedules and global-norm clipping: the JAX
package's ``repro.optim.adamw`` over the port's tensors.

The optimizer state is tensors keyed by parameter name (``m``, ``v``,
float32 like the parameters) and a device int32 ``step``.
:func:`adamw_update` writes the new parameters, ``m``, ``v`` and
``step`` in place, and computes the learning rate and the bias
corrections on the device from the step tensor, so a captured train step
(``train/train_step.py``) replays it with no host sync.  The arithmetic
is JAX's, in its order.
"""

from __future__ import annotations

import dataclasses
import math

import torch

__all__ = ["AdamWConfig", "schedule_lr", "init_opt_state", "global_norm",
           "clip_by_global_norm", "adamw_update"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine|linear|constant
    min_lr_ratio: float = 0.1


def schedule_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The float32 learning rate at ``step`` (a tensor): linear warmup
    over ``warmup_steps``, then cosine or linear decay to ``min_lr_ratio``
    of ``lr`` at ``total_steps`` (or constant)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    if cfg.schedule == "constant":
        return cfg.lr * warm
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * t))
    else:
        decay = 1.0 - t
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * decay
    return cfg.lr * warm * decay


def init_opt_state(params: dict) -> dict:
    """Zero ``m`` and ``v`` for every named parameter (``{name: tensor}``,
    e.g. ``dict(model.named_parameters())``) and ``step`` 0, on the
    parameters' device."""
    dev = next(iter(params.values())).device
    zeros = {n: torch.zeros_like(p, memory_format=torch.contiguous_format)
             for n, p in params.items()}
    return {"m": zeros,
            "v": {n: torch.zeros_like(z) for n, z in zeros.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict) -> torch.Tensor:
    """sqrt of the sum over the tensors (in order) of their float32
    squares' sums."""
    total = 0
    for x in tree.values():
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the global
    norm before)."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return {n: (g * scale).to(g.dtype) for n, g in grads.items()}, gn


def adamw_update(cfg: AdamWConfig, grads: dict, opt_state: dict,
                 params: dict):
    """One AdamW step on ``params`` ({name: tensor}) from ``grads`` (the
    same names): clipped to ``grad_clip``, then JAX's update with
    decoupled weight decay.  ``params``, ``opt_state["m"]``, ``["v"]`` and
    ``["step"]`` are written in place.  Returns (params, opt_state,
    {"grad_norm", "lr"} device scalars)."""
    gn = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12), max=1.0)
    step = opt_state["step"]
    step.add_(1)
    lr = schedule_lr(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    with torch.no_grad():
        for name, p in params.items():
            m, v = opt_state["m"][name], opt_state["v"][name]
            g = (grads[name] * scale).to(torch.float32)
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * torch.square(g))
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
                + cfg.weight_decay * p.to(torch.float32)
            p.copy_(p.to(torch.float32) - lr * delta)
    return params, opt_state, {"grad_norm": gn, "lr": lr}
