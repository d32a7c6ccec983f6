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

``compress_dci``: the gradients go through int8 with error feedback
(``distributed/compression.py``) before the update, as they would over
a slow hop between pods, with one scale a leaf of JAX's tree (the
layers of a period slot share one, :func:`leaf_groups`); the state gains
``ef`` (float32 residuals by parameter name, zeros at first, written in
place inside the step).

:class:`DPTrainStep` (``make_dp_train_step``): data parallelism over a
``DeviceMesh``'s ``data`` group, composed with digit sharding over its
``model`` group.  Every rank is given the whole batch, as JAX's caller
gives its jitted step; each microbatch (split first, as JAX's scan
splits the batch) is then split by rows over the data group.  A rank
divides its rows' cross-entropy sum by the whole microbatch's token
count, so the sum over ranks of its gradients and loss is the single
step's; every whole-tensor absmax scale is the max over the data group
(``use_batch_sharding``), as GSPMD's global reduction gives it, so the
RNS grids are the single step's too.  One ``all_reduce_sum`` a step
then sums the gradients and the loss over the data group.  With
``digit_shard`` and ``cfg.rns`` the step runs under
``use_digit_sharding`` over ``model``.
"""

from __future__ import annotations

import torch

from repro_torch.core import dispatch
from repro_torch.distributed import sharding
from repro_torch.models import model as M
from repro_torch.models.resident import attach_resident
from repro_torch.optim.adamw import AdamWConfig, adamw_update, init_opt_state
from repro_torch.serve.graphs import StepProgram, build_programs

__all__ = ["HostStage", "measure_rns_ops", "init_train_state", "state_tree",
           "TrainStep", "DPTrainStep", "make_train_step", "make_eval_step",
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
    {"params": {name: tensor}, "opt": {"m": ..., "v": ..., "step"}}, and
    ``compress_dci``'s error feedback "ef" where the state has it
    (resident digits are buffers, not parameters: never stored)."""
    tree = {"params": dict(state["model"].named_parameters()),
            "opt": state["opt"]}
    if "ef" in state:
        tree["ef"] = state["ef"]
    return tree


def leaf_groups(names, period: int) -> list[list[str]]:
    """The parameter names grouped as JAX's tree holds them: the layers
    of one period slot of the decoder stack (``blocks.<i>.<rest>``, i
    mod ``period``) stacked in one leaf, every encoder layer
    (``enc_blocks.<i>.<rest>``, period 1) in one, any other parameter
    alone."""
    groups: dict = {}
    for name in names:
        parts = name.split(".", 2)
        if parts[0] in ("blocks", "enc_blocks") and len(parts) == 3:
            slot = int(parts[1]) % period if parts[0] == "blocks" else 0
            key = (parts[0], slot, parts[2])
        else:
            key = (name,)
        groups.setdefault(key, []).append(name)
    return list(groups.values())


def _compress(grads: dict, ef: dict, groups) -> dict:
    """``compress_dci``: the gradients after int8 with error feedback,
    one scale a JAX leaf (``groups``); the new residuals are written
    into ``ef`` in place."""
    from repro_torch.distributed.compression import (decompress_tree,
                                                     ef_compress_tree)

    qtree, new_ef = ef_compress_tree(grads, ef, groups)
    for n, e in new_ef.items():
        ef[n].copy_(e)
    return {n: d.to(grads[n].dtype)
            for n, d in decompress_tree(qtree).items()}


class TrainStep:
    """``step(state, batch) -> (state, metrics)``: one optimizer step on
    ``state`` (in place) from ``batch`` ({"tokens": [B, T] ints,
    optionally "loss_mask": [B, T] and, for an audio or vision model,
    "frontend": [B, F, d] floats}, numpy or tensors; every entry split
    into ``grad_accum`` microbatches along its rows); ``metrics`` holds
    device scalars "loss", "ce", "aux", "grad_norm", "lr"."""

    def __init__(self, cfg, opt_cfg: AdamWConfig, *,
                 resident_weights: bool = False, graphs: bool = True,
                 compress_dci: bool = False):
        self.cfg = cfg
        self.opt_cfg = opt_cfg
        self.resident_weights = resident_weights
        self.graphs = graphs
        self.compress_dci = compress_dci
        self.accum = max(1, cfg.grad_accum)
        self.program: StepProgram | None = None
        self._key = None

    @property
    def captures(self) -> int:
        return 0 if self.program is None else self.program.captures

    def _grads_fn(self, state):
        """``grads(**batch) -> (loss, parts, grads)``: the loss and the
        gradients of one step (microbatches summed, a data-parallel
        step's reduced over its data group), no update.  It holds no
        reference to ``self``, so a dropped TrainStep frees its graph at
        once."""
        model = state["model"]
        params = dict(model.named_parameters())
        cfg, accum = self.cfg, self.accum
        resident = self.resident_weights
        rows_of, aux_share, reduce = self._dp_hooks(list(params))

        def grads_of(batch):
            batch = rows_of(batch)
            denom = batch.pop("denom", None)
            loss, parts = M.loss_fn(model, cfg, batch, denom=denom)
            if aux_share != 1:
                parts = {"ce": parts["ce"], "aux": parts["aux"] * aux_share}
                loss = parts["ce"] + parts["aux"]
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True,
                                        materialize_grads=True)
            return loss, parts, dict(zip(params, grads))

        def grads(**batch):
            if resident:
                attach_resident(model, cfg)
            if accum == 1:
                loss, parts, g = grads_of(batch)
            else:
                rows = batch["tokens"].shape[0] // accum
                gsum = {n: torch.zeros(p.shape, dtype=torch.float32,
                                       device=p.device)
                        for n, p in params.items()}
                lsum = asum = torch.zeros((), device=model.embed.device)
                for i in range(accum):
                    sub = {k: v[i * rows:(i + 1) * rows]
                           for k, v in batch.items()}
                    loss, parts, gi = grads_of(sub)
                    gsum = {n: gsum[n] + gi[n].to(torch.float32)
                            for n in gsum}
                    lsum, asum = lsum + loss, asum + parts["aux"]
                g = {n: (gsum[n] / accum).to(params[n].dtype)
                     for n in gsum}
                loss = lsum / accum
                parts = {"ce": loss - asum / accum, "aux": asum / accum}
            if reduce is not None:
                loss, parts, g = reduce(loss, parts, g)
            return loss, parts, g

        return grads

    def _fn(self, state):
        """The step over ``state``: :meth:`_grads_fn`, ``compress_dci``'s
        compression, the update."""
        opt = state["opt"]
        params = dict(state["model"].named_parameters())
        opt_cfg = self.opt_cfg
        grads_step = self._grads_fn(state)
        ef = state.get("ef")
        groups = leaf_groups(params, self.cfg.period)

        def step(**batch):
            loss, parts, grads = grads_step(**batch)
            if ef is not None:
                grads = _compress(grads, ef, groups)
            _, _, om = adamw_update(opt_cfg, grads, opt, params)
            return {"loss": loss.detach(), "ce": parts["ce"].detach(),
                    "aux": parts["aux"].detach(), **om}

        return step

    def _dp_hooks(self, names):
        """(this rank's rows of a microbatch, its share of the aux loss,
        the reduction of loss and gradients over the data group or None):
        nothing to split or reduce in a one-rank step."""
        return dict, 1, None

    def gradients(self, state: dict, batch: dict):
        """(loss, {name: gradient}) of one step on ``batch`` (tensors on
        the model's device), eagerly, without the update: what the step
        applies before ``compress_dci``."""
        state["model"].requires_grad_(True)
        loss, _, grads = self._grads_fn(state)(**batch)
        return loss.detach(), grads

    def _build(self, state, batch: dict):
        model = state["model"]
        model.requires_grad_(True)
        dev = model.embed.device
        if batch["tokens"].shape[0] % self.accum:
            raise ValueError(f"batch of {batch['tokens'].shape[0]} rows "
                             f"does not split into {self.accum} "
                             "microbatches")
        if self.compress_dci and "ef" not in state:
            state["ef"] = {n: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                           for n, p in model.named_parameters()}
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
                    *state["opt"]["v"].values(), state["opt"]["step"],
                    *state.get("ef", {}).values()]
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


class DPTrainStep(TrainStep):
    """:class:`TrainStep` over ``mesh``: batch rows split over its
    ``data`` group, residues over its ``model`` group (``digit_shard``
    and ``cfg.rns``); see the module docstring.  A gloo mesh runs eagerly
    on the card (``graphs=False``; captured, it raises)."""

    def __init__(self, cfg, opt_cfg: AdamWConfig, mesh, *,
                 compress_dci: bool = False, digit_shard: bool = True,
                 resident_weights: bool = False, graphs: bool = True):
        super().__init__(cfg, opt_cfg, resident_weights=resident_weights,
                         graphs=graphs, compress_dci=compress_dci)
        self.mesh = mesh
        sizes = sharding.axis_sizes(mesh)
        self.n_data = sizes.get("data", 1)
        self.data_index = mesh.get_local_rank("data") if self.n_data > 1 \
            else 0
        self.digit_mesh = mesh if digit_shard and cfg.rns is not None \
            else None

    def _dp_hooks(self, names):
        if self.n_data == 1:
            return dict, 1, None
        n_data, lo_rank = self.n_data, self.data_index
        group = self.mesh.get_group("data")

        def rows_of(batch: dict) -> dict:
            """This rank's rows of a microbatch, and the microbatch's
            token count as ``denom``."""
            B = batch["tokens"].shape[0]
            if B % n_data:
                raise ValueError(f"a microbatch of {B} rows does not split "
                                 f"over {n_data} data ranks")
            per = B // n_data
            lo = lo_rank * per
            out = {k: v[lo:lo + per] for k, v in batch.items()}
            out["denom"] = M.loss_denominator(batch)
            return out

        def reduce(loss, parts, grads):
            """One all-reduce of the gradients and the loss parts over
            the data group.  The aux loss is each rank's over its own
            rows (a MoE router's balance is not a sum over rows), so each
            rank took 1 / n_data of it: their mean."""
            flat = torch.cat([grads[n].reshape(-1).to(torch.float32)
                              for n in names]
                             + [parts[k].detach().reshape(1).to(torch.float32)
                                for k in ("ce", "aux")])
            sharding.all_reduce_sum(flat, group)
            out, at = {}, 0
            for n in names:
                k = grads[n].numel()
                out[n] = flat[at:at + k].view(grads[n].shape).to(
                    grads[n].dtype)
                at += k
            ce, aux = flat[at], flat[at + 1]
            return ce + aux, {"ce": ce, "aux": aux}, out

        return rows_of, 1.0 / n_data, reduce

    def _grads_fn(self, state):
        grads = super()._grads_fn(state)
        mesh, digit_mesh = self.mesh, self.digit_mesh

        def dp_grads(**batch):
            with sharding.use_digit_sharding(digit_mesh), \
                    sharding.use_batch_sharding(mesh):
                return grads(**batch)

        return dp_grads

    def _build(self, state, batch: dict):
        dev = state["model"].embed.device
        sharding.check_capturable(self.mesh, ("data", "model"), dev,
                                  self.graphs)
        super()._build(state, batch)


def make_train_step(cfg, opt_cfg: AdamWConfig, *, compress_dci: bool = False,
                    resident_weights: bool = False,
                    graphs: bool = True) -> TrainStep:
    """The train step for ``cfg`` (see :class:`TrainStep`)."""
    return TrainStep(cfg, opt_cfg, resident_weights=resident_weights,
                     graphs=graphs, compress_dci=compress_dci)


def make_eval_step(cfg):
    """``eval_step(model, batch) -> {"loss", "ce", "aux"}``, no
    gradients."""
    def eval_step(model, batch):
        with torch.no_grad():
            loss, parts = M.loss_fn(model, cfg, batch)
        return {"loss": loss, **parts}

    return eval_step


def make_dp_train_step(cfg, opt_cfg: AdamWConfig, mesh, *,
                       compress_dci: bool = False, digit_shard: bool = True,
                       resident_weights: bool = False,
                       graphs: bool = True) -> DPTrainStep:
    """The data-parallel train step over ``mesh``, digit-sharded where
    ``digit_shard`` and ``cfg.rns`` (see :class:`DPTrainStep`); losses
    match the single step's to float tolerance."""
    return DPTrainStep(cfg, opt_cfg, mesh, compress_dci=compress_dci,
                       digit_shard=digit_shard,
                       resident_weights=resident_weights, graphs=graphs)
