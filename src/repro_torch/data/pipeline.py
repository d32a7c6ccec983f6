"""The inputs the port draws: the synthetic LM corpus a trainer reads
and the modality frontend's stub embeddings a serve draws.

:class:`SyntheticLM` is a copy of the JAX package's numpy code, so the
two packages' token streams are identical: every batch is a pure
function of (seed, step, host shard), which makes a resumed run read the
stream it would have read.  The corpus is an order-1 Markov chain with a
banded, Zipf-weighted successor table plus uniform noise, enough signal
for a small model's loss to fall well below the uniform floor.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "SyntheticLM", "make_frontend_stub"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.1        # fraction of uniformly random tokens
    branch: int = 8           # Markov out-degree


class SyntheticLM:
    """Stateless-per-step synthetic corpus; host ``host_id`` of
    ``n_hosts`` reads its ``global_batch // n_hosts`` rows of a batch."""

    def __init__(self, cfg: DataConfig, host_id: int = 0, n_hosts: int = 1):
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        rng = np.random.default_rng(cfg.seed)
        # fixed transition table: vocab x branch successor ids, zipf weights
        self._succ = rng.integers(0, cfg.vocab, size=(cfg.vocab, cfg.branch))
        w = 1.0 / np.arange(1, cfg.branch + 1)
        self._w = w / w.sum()

    def batch(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed, step, self.host_id, 0xD1CE))
        B, T = self.local_batch, cfg.seq_len
        toks = np.empty((B, T), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab, B)
        branch_draw = rng.choice(cfg.branch, size=(B, T), p=self._w)
        noise_mask = rng.random((B, T)) < cfg.noise
        noise_tok = rng.integers(0, cfg.vocab, (B, T))
        for t in range(1, T):
            nxt = self._succ[toks[:, t - 1], branch_draw[:, t]]
            toks[:, t] = np.where(noise_mask[:, t], noise_tok[:, t], nxt)
        return {"tokens": toks}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


def make_frontend_stub(rng: np.random.Generator, batch: int, n_tokens: int,
                       d_model: int) -> np.ndarray:
    """Precomputed frame / patch embeddings for the audio and vision
    archs (the stub of their frontend): N(0, 1) float32 [batch,
    n_tokens, d_model] from ``rng``."""
    return rng.standard_normal((batch, n_tokens, d_model)).astype(np.float32)
