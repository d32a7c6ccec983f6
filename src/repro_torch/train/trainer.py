"""The training loop: resume from the newest valid checkpoint, one
captured step a batch, checkpoints every ``ckpt_every`` steps, and the
fault-tolerance hooks (preemption, stragglers, heartbeats) -- the JAX
package's ``repro.train.trainer`` over the port's state.

Runs on the card unless given ``device="cpu"``; ``graphs=False`` takes
every step eagerly.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np

from repro_torch.checkpoint import checkpointer as ckpt
from repro_torch.data.pipeline import (DataConfig, SyntheticLM,
                                       make_frontend_stub)
from repro_torch.distributed.fault_tolerance import (Heartbeat,
                                                     PreemptionHandler,
                                                     StragglerMonitor)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.train_step import (init_train_state, make_train_step,
                                          state_tree)

__all__ = ["TrainerConfig", "Trainer"]

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 200
    ckpt_every: int = 50
    ckpt_dir: str = "repro_ckpt"
    log_every: int = 10
    seed: int = 0
    async_ckpt: bool = True


class Trainer:
    """``run()`` trains ``model_cfg`` on the synthetic corpus from step 0
    or from the newest valid checkpoint in ``tcfg.ckpt_dir``."""

    def __init__(self, model_cfg, opt_cfg: AdamWConfig, tcfg: TrainerConfig,
                 data_cfg: DataConfig, host: str = "host0", *,
                 device="cuda", graphs: bool = True):
        self.model_cfg = model_cfg
        self.opt_cfg = opt_cfg
        self.tcfg = tcfg
        self.device = device
        self.data = SyntheticLM(data_cfg)
        self.step_fn = make_train_step(model_cfg, opt_cfg, graphs=graphs)
        self.straggler = StragglerMonitor()
        self.preempt = PreemptionHandler(install=False)
        self.heartbeat = Heartbeat(os.path.join(tcfg.ckpt_dir, "hb"), host)
        self.host = host
        self._pending_save = None

    def init_or_resume(self):
        """(state, first step): a new state from ``tcfg.seed``, restored
        in place from the newest valid checkpoint if there is one."""
        state = init_train_state(self.model_cfg, self.tcfg.seed, self.device)
        latest = ckpt.latest_valid(self.tcfg.ckpt_dir)
        if latest is None:
            return state, 0
        _, _, step = ckpt.restore(latest, state_tree(state))
        log.info("resumed from %s (step %d)", latest, step)
        return state, step

    def _batch(self, step: int) -> dict:
        """Step ``step``'s batch: the corpus's tokens and, for an audio or
        vision model, its frontend stub drawn from ``(seed, step, 99)``,
        as the JAX trainer draws it."""
        b = self.data.batch(step)
        cfg = self.model_cfg
        if cfg.frontend is not None:
            rng = np.random.default_rng((self.tcfg.seed, step, 99))
            b["frontend"] = make_frontend_stub(
                rng, self.data.local_batch, cfg.n_frontend_tokens,
                cfg.d_model)
        return b

    def _save(self, state, step):
        if self._pending_save is not None:
            self._pending_save.result()     # one write in flight
        tree = state_tree(state)
        if self.tcfg.async_ckpt:
            self._pending_save = ckpt.save_async(
                self.tcfg.ckpt_dir, step, tree, {"host": self.host})
        else:
            ckpt.save(self.tcfg.ckpt_dir, step, tree, {"host": self.host})

    def run(self, max_steps: int | None = None):
        """Train to ``tcfg.total_steps`` (at most ``max_steps`` more).
        Returns (state, the losses of the steps taken)."""
        state, start = self.init_or_resume()
        history = []
        end = min(self.tcfg.total_steps,
                  start + (max_steps or self.tcfg.total_steps))
        for step in range(start, end):
            t0 = time.perf_counter()
            state, metrics = self.step_fn(state, self._batch(step))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            self.straggler.report(self.host, dt)
            self.heartbeat.beat(step)
            history.append(loss)
            if step % self.tcfg.log_every == 0:
                log.info("step %d loss %.4f (%.1f ms)", step, loss, dt * 1e3)
            if (step + 1) % self.tcfg.ckpt_every == 0 or step + 1 == end:
                self._save(state, step + 1)
            if self.preempt.requested:
                log.warning("preemption requested: checkpointing and exiting")
                self._save(state, step + 1)
                break
        if self._pending_save is not None:
            self._pending_save.result()
        return state, history
