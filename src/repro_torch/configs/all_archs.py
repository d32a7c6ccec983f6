"""Architectures of this slice (exact public configs) + reduced smoke twins.

Only ``smollm-135m`` is ported so far; the other architectures of
``repro.configs.all_archs`` come with the slices that port their layers.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ModelConfig, register


def smollm_135m() -> ModelConfig:
    # [hf:HuggingFaceTB/SmolLM-135M]
    return ModelConfig(
        arch_id="smollm-135m", n_layers=30, d_model=576,
        n_heads=9, n_kv_heads=3, d_head=64, d_ff=1536, vocab=49152,
        tie_embeddings=True)


def _smoke_of(full: ModelConfig, **over) -> ModelConfig:
    """The JAX package's smoke twin: 4 layers, width 64, vocab 256."""
    base = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                d_ff=128, vocab=256)
    base.update(over)
    return dataclasses.replace(full, **base)


ALL = {
    "smollm-135m": (smollm_135m, lambda: _smoke_of(smollm_135m())),
}

for _aid, (_full, _smoke) in ALL.items():
    register(_aid, _full, _smoke)
