"""Inputs a serve draws: the modality frontend's stub embeddings."""

from __future__ import annotations

import numpy as np

__all__ = ["make_frontend_stub"]


def make_frontend_stub(rng: np.random.Generator, batch: int, n_tokens: int,
                       d_model: int) -> np.ndarray:
    """Precomputed frame / patch embeddings for the audio and vision
    archs (the stub of their frontend): N(0, 1) float32 [batch,
    n_tokens, d_model] from ``rng``."""
    return rng.standard_normal((batch, n_tokens, d_model)).astype(np.float32)
