"""Architectures ported so far (exact public configs) + reduced smoke twins.

``smollm-135m`` (GQA, dense MLP, tied embedding), ``deepseek-v2-236b``
(MLA attention, MoE MLP with shared experts, untied) and
``llama4-scout-17b-a16e`` (GQA, MoE with a shared expert, untied); the
other architectures of ``repro.configs.all_archs`` come with the slices
that port their layers.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig, register
from repro_torch.models.moe import MoEConfig


def smollm_135m() -> ModelConfig:
    # [hf:HuggingFaceTB/SmolLM-135M]
    return ModelConfig(
        arch_id="smollm-135m", n_layers=30, d_model=576,
        n_heads=9, n_kv_heads=3, d_head=64, d_ff=1536, vocab=49152,
        tie_embeddings=True)


def llama4_scout() -> ModelConfig:
    # [hf:meta-llama/Llama-4-Scout-17B-16E] 16 experts top-1 + shared expert
    L = 48
    return ModelConfig(
        arch_id="llama4-scout-17b-a16e", family="moe", n_layers=L,
        d_model=5120, n_heads=40, n_kv_heads=8, d_head=128, d_ff=8192,
        vocab=202048, rope_theta=500_000.0, mlp_types=("moe",) * L,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1))


def deepseek_v2_236b() -> ModelConfig:
    # [arXiv:2405.04434] MLA kv_lora=512; 2 shared + 160 routed top-6
    L = 60
    return ModelConfig(
        arch_id="deepseek-v2-236b", family="moe", n_layers=L, d_model=5120,
        n_heads=128, n_kv_heads=128, d_head=128, d_ff=1536, vocab=102400,
        layer_types=("mla",) * L, mlp_types=("moe",) * L,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                      qk_rope_dim=64, v_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2))


def _smoke_of(full: ModelConfig, **over) -> ModelConfig:
    """The JAX package's smoke twin: 4 layers, width 64, vocab 256; a
    uniform layer program keeps its type, MoE shrinks to 4 experts
    (dropless: ``capacity_factor`` 8 >= E/k) and MLA to ranks 32/48."""
    base = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                d_ff=128, vocab=256)
    base.update(over)
    L = base["n_layers"]
    if len(set(full.layer_types)) == 1:
        base.setdefault("layer_types", (full.layer_types[0],) * L)
    if len(set(full.mlp_types)) == 1:
        base.setdefault("mlp_types", (full.mlp_types[0],) * L)
    if full.moe:
        base.setdefault("moe", MoEConfig(
            n_experts=4, top_k=min(2, full.moe.top_k),
            d_ff_expert=base["d_ff"], n_shared=min(1, full.moe.n_shared),
            capacity_factor=8.0))
    if full.mla:
        base.setdefault("mla", MLAConfig(
            kv_lora_rank=32, q_lora_rank=48, qk_nope_dim=16, qk_rope_dim=8,
            v_dim=16))
    return dataclasses.replace(full, **base)


ALL = {
    "smollm-135m": (smollm_135m, lambda: _smoke_of(smollm_135m())),
    "llama4-scout-17b-a16e": (llama4_scout,
                              lambda: _smoke_of(llama4_scout())),
    "deepseek-v2-236b": (deepseek_v2_236b, lambda: _smoke_of(
        deepseek_v2_236b(), layer_types=("mla",) * 4)),
}

for _aid, (_full, _smoke) in ALL.items():
    register(_aid, _full, _smoke)
