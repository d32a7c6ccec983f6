"""The train step: loss -> gradients -> AdamW, as one captured program.

The port's counterpart of ``jax.jit(make_train_step(...),
donate_argnums=(0,))``: :class:`TrainStep` runs one
:class:`~repro_torch.serve.graphs.StepProgram` (``"train"``) over static
batch buffers, which computes the loss and its gradients
(``torch.autograd.grad``; ``grad_accum`` microbatches summed in float32
in order, then divided, as JAX's scan does), then updates the
parameters, ``m``, ``v`` and ``step`` in place (``optim/adamw.py``).  On
the card the program is captured once, the first time a state and batch
shape meet, and replayed every step after: the CUDA graph holds the
forward, the backward (recomputed layers included) and the update.  The
warm-up that precedes the capture runs a real step, so the state is
copied to host memory (:class:`HostStage`) before it and written back
after: a captured run's steps are the eager run's.  ``graphs=False`` (or
the CPU) runs the same function eagerly; a capture that fails raises.

``resident_weights``: every step first encodes the MLP masters into
their resident buffers (``models/resident.attach_resident``), so the
forward reads residues, the straight-through backward the masters, and
the optimizer's state holds masters only.

``compress_dci`` and the data-parallel step wait for the distributed
slice (ROADMAP A.11).
"""

from __future__ import annotations

import torch

from repro_torch.core import dispatch
from repro_torch.models import model as M
from repro_torch.models.resident import attach_resident
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.serve.graphs import StepProgram, build_programs

__all__ = ["HostStage", "measure_rns_ops", "init_train_state", "state_tree",
           "TrainStep", "make_train_step", "make_eval_step",
           "make_dp_train_step"]


class HostStage:
    """A host buffer reused for copies of a model's state off the card:
    grown to the largest state it held (with an eighth to spare) and
    page-locked with ``cudaHostRegister``, so the copies run at the
    link's rate and the locking is paid once, not a copy.  (PyTorch's
    pinned tensors are rounded up to a power of two and kept by its host
    allocator once freed: two 1.6 B-parameter states ran a 96 GiB host
    out of memory.)"""

    def __init__(self):
        self._buf = None

    def release(self):
        if self._buf is not None:
            torch.cuda.cudart().cudaHostUnregister(self._buf.data_ptr())
        self._buf = None

    def copy(self, tensors) -> list:
        """Host copies of ``tensors`` (card tensors), as views of the
        buffer: the previous copy's views are overwritten."""
        sizes = [-(-t.numel() * t.element_size() // 64) * 64 for t in tensors]
        need = sum(sizes)
        if self._buf is None or self._buf.numel() < need:
            self.release()
            n = need + need // 8
            buf = torch.empty(n, dtype=torch.uint8)
            err = torch.cuda.cudart().cudaHostRegister(buf.data_ptr(), n, 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of {n} bytes: {err}")
            self._buf = buf
        out, at = [], 0
        for t, n in zip(tensors, sizes):
            raw = self._buf[at:at + t.numel() * t.element_size()]
            out.append(raw.view(t.dtype).view(t.shape).copy_(
                t.detach(), non_blocking=True))
            at += n
        torch.cuda.synchronize()
        return out


#: where :class:`TrainStep` keeps a state while its warm-up runs
_STAGE = HostStage()


def measure_rns_ops(model, cfg, batch) -> dispatch.OpCounts:
    """The RNS primitive calls of one loss evaluation (no backward: JAX
    traces ``loss_fn`` alone).  The port counts every layer's calls, the
    JAX package one scanned period's (ROADMAP C.3)."""
    with torch.no_grad(), dispatch.count_ops() as ops:
        M.loss_fn(model, cfg, batch)
    return ops


def init_train_state(cfg, seed: int = 0, device="cuda") -> dict:
    """{"model": a Model with random weights from ``seed`` (parameters
    that take gradients), "opt": its zero AdamW state}."""
    model = M.init_model(cfg, seed, device)
    model.requires_grad_(True)
    return {"model": model,
            "opt": init_opt_state(dict(model.named_parameters()))}


def state_tree(state: dict) -> dict:
    """The state as the nested dict of tensors a checkpoint stores:
    {"params": {name: tensor}, "opt": {"m": ..., "v": ..., "step"}}
    (resident digits are buffers, not parameters: never stored)."""
    return {"params": dict(state["model"].named_parameters()),
            "opt": state["opt"]}


class TrainStep:
    """``step(state, batch) -> (state, metrics)``: one optimizer step on
    ``state`` (in place) from ``batch`` ({"tokens": [B, T] ints,
    optionally "loss_mask": [B, T] and, for an audio or vision model,
    "frontend": [B, F, d] floats}, numpy or tensors; every entry split
    into ``grad_accum`` microbatches along its rows); ``metrics`` holds
    device scalars "loss", "ce", "aux", "grad_norm", "lr"."""

    def __init__(self, cfg, opt_cfg: AdamWConfig, *,
                 resident_weights: bool = False, graphs: bool = True):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.resident_weights = resident_weights
        self.graphs = graphs
        self.accum = max(1, cfg.grad_accum)
        self.program: StepProgram | None = None
        self._key = None

    @property
    def captures(self) -> int:
        return 0 if self.program is None else self.program.captures

    def _fn(self, state):
        """The step over ``state`` (it holds no reference to ``self``, so
        a dropped TrainStep frees its graph at once)."""
        model, opt = state["model"], state["opt"]
        params = dict(model.named_parameters())
        cfg, opt_cfg, accum = self.cfg, self.opt_cfg, self.accum
        resident = self.resident_weights

        def grads_of(batch):
            loss, parts = M.loss_fn(model, cfg, batch)
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            return loss, parts, dict(zip(params, grads))

        def step(**batch):
            if resident:
                attach_resident(model, cfg)
            if accum == 1:
                loss, parts, grads = grads_of(batch)
            else:
                rows = batch["tokens"].shape[0] // accum
                gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for n, p in params.items()}
                lsum = asum = torch.zeros((), device=model.embed.device)
                for i in range(accum):
                    sub = {k: v[i * rows:(i + 1) * rows]
                           for k, v in batch.items()}
                    loss, parts, g = grads_of(sub)
                    gsum = {n: gsum[n] + g[n].to(torch.float32)
                            for n in gsum}
                    lsum, asum = lsum + loss, asum + parts["aux"]
                grads = {n: (gsum[n] / accum).to(params[n].dtype)
                         for n in gsum}
                loss = lsum / accum
                parts = {"ce": loss - asum / accum, "aux": asum / accum}
            _, _, om = adamw_update(opt_cfg, grads, opt, params)
            return {"loss": loss.detach(), "ce": parts["ce"].detach(),
                    "aux": parts["aux"].detach(), **om}

        return step

    def _build(self, state, batch: dict):
        model = state["model"]
        model.requires_grad_(True)
        dev = model.embed.device
        if batch["tokens"].shape[0] % self.accum:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} rows "
                             f"does not split into {self.accum} "
                             "microbatches")
        inputs = {k: torch.zeros(tuple(v.shape), device=dev,
                                 dtype=torch.int64 if k == "tokens"
                                 else torch.float32)
                  for k, v in batch.items()}
        for k, v in batch.items():
            inputs[k].copy_(torch.as_tensor(v))
        self.program = StepProgram("train", self._fn(state), inputs)
        if self.graphs and dev.type == "cuda":
            # the warm-up runs a real step: keep the state in host memory
            # (not on the card, where it would add 12 bytes a parameter
            # to the peak) and put it back once the capture is taken
            live = [*model.parameters(), *state["opt"]["m"].values(),
                    *state["opt"]["v"].values(), state["opt"]["step"]]
            kept = _STAGE.copy(live)
            build_programs([self.program], dev, graphs=True)
            with torch.no_grad():
                for t, k in zip(live, kept):
                    t.copy_(k, non_blocking=True)
            torch.cuda.synchronize(dev)
            del kept

    def __call__(self, state: dict, batch: dict):
        key = (id(state["model"]), id(state["opt"]),
               tuple((k, tuple(v.shape)) for k, v in sorted(batch.items())))
        if key != self._key:
            self._build(state, batch)
            self._key = key
        out = self.program.run(**{k: torch.as_tensor(v)
                                  for k, v in batch.items()})
        return state, {k: v.clone() for k, v in out.items()}


def make_train_step(cfg, opt_cfg: AdamWConfig, *, compress_dci: bool = False,
                    resident_weights: bool = False,
                    graphs: bool = True) -> TrainStep:
    """The train step for ``cfg`` (see :class:`TrainStep`)."""
    if compress_dci:
        raise NotImplementedError(
            "compress_dci (int8 + error-feedback gradients over the "
            "pod-to-pod hop) comes with the distributed slice "
            "(ROADMAP A.11)")
    return TrainStep(cfg, opt_cfg, resident_weights=resident_weights,
                     graphs=graphs)


def make_eval_step(cfg):
    """``eval_step(model, batch) -> {"loss", "ce", "aux"}``, no
    gradients."""
    def eval_step(model, batch):
        with torch.no_grad():
            loss, parts = M.loss_fn(model, cfg, batch)
        return {"loss": loss, **parts}

    return eval_step


def make_dp_train_step(*args, **kwargs):
    """The data-parallel, digit-sharded train step: the distributed
    slice (ROADMAP A.11)."""
    raise NotImplementedError(
        "make_dp_train_step (data parallelism with a digit-sharded "
        "forward) comes with the distributed slice (ROADMAP A.11)")
