"""Architectures ported so far (exact public configs) + reduced smoke twins.

The dense GQA models ``smollm-135m`` (tied embedding), ``tinyllama-1.1b``,
``granite-3-8b`` and ``qwen2.5-32b`` (a bias on q/k/v);
``deepseek-v2-236b`` (MLA attention, MoE MLP with shared experts) and
``llama4-scout-17b-a16e`` (GQA, MoE with a shared expert); the
attention-free ``rwkv6-7b`` (RWKV-6 time-mix and channel-mix, layernorm)
and the hybrid ``jamba-v0.1-52b`` (Mamba layers with one GQA layer a
period of 8, MoE every other layer, no positions); the encoder-decoder
``whisper-medium`` (24 + 24 layers over 1500 precomputed audio frames,
sinusoidal positions, layernorm, a plain gelu MLP, a bias on q/k/v) and
``paligemma-3b`` (a gemma decoder behind 256 precomputed patch
embeddings, one KV head, scaled embeddings, tied head).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import MLAConfig, ModelConfig, register
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig


def _llama_like(arch_id, L, d, H, Hk, dff, vocab, *, d_head=None,
                qkv_bias=False, tie=False, **kw) -> ModelConfig:
    return ModelConfig(
        arch_id=arch_id, family="dense", n_layers=L, d_model=d, n_heads=H,
        n_kv_heads=Hk, d_head=d_head or d // H, d_ff=dff, vocab=vocab,
        qkv_bias=qkv_bias, tie_embeddings=tie, **kw)


def qwen25_32b() -> ModelConfig:
    # [hf:Qwen/Qwen2.5-32B-style scaling; QKV bias per Qwen2 family]
    return _llama_like("qwen2.5-32b", 64, 5120, 40, 8, 27648, 152064,
                       d_head=128, qkv_bias=True, rope_theta=1_000_000.0,
                       grad_accum=4)


def smollm_135m() -> ModelConfig:
    # [hf:HuggingFaceTB/SmolLM-135M]
    return _llama_like("smollm-135m", 30, 576, 9, 3, 1536, 49152,
                       d_head=64, tie=True)


def tinyllama_11b() -> ModelConfig:
    # [arXiv:2401.02385]
    return _llama_like("tinyllama-1.1b", 22, 2048, 32, 4, 5632, 32000,
                       d_head=64, grad_accum=2)


def granite_3_8b() -> ModelConfig:
    # [hf:ibm-granite/granite-3.0 family]
    return _llama_like("granite-3-8b", 40, 4096, 32, 8, 12800, 49155,
                       d_head=128, rope_theta=10_000_000.0, grad_accum=4)


def whisper_medium() -> ModelConfig:
    # [arXiv:2212.04356] enc-dec, 24+24 layers, conv frontend stubbed:
    # precomputed 1500-frame embeddings at d_model
    return ModelConfig(
        arch_id="whisper-medium", family="audio", n_layers=24, d_model=1024,
        n_heads=16, n_kv_heads=16, d_head=64, d_ff=4096, vocab=51865,
        qkv_bias=True, pos_emb="sinusoidal", norm="layernorm", act="gelu",
        gated_mlp=False, enc_dec=True, n_enc_layers=24, frontend="audio",
        n_frontend_tokens=1500, grad_accum=2)


def paligemma_3b() -> ModelConfig:
    # [arXiv:2407.07726] SigLIP stub (256 patch embeddings) + gemma backbone
    return ModelConfig(
        arch_id="paligemma-3b", family="vlm", n_layers=18, d_model=2048,
        n_heads=8, n_kv_heads=1, d_head=256, d_ff=16384, vocab=257216,
        act="gelu_tanh", tie_embeddings=True, emb_scale=True,
        frontend="vision", n_frontend_tokens=256, grad_accum=2)


def llama4_scout() -> ModelConfig:
    # [hf:meta-llama/Llama-4-Scout-17B-16E] 16 experts top-1 + shared expert
    L = 48
    return ModelConfig(
        arch_id="llama4-scout-17b-a16e", family="moe", n_layers=L,
        d_model=5120, n_heads=40, n_kv_heads=8, d_head=128, d_ff=8192,
        vocab=202048, rope_theta=500_000.0, mlp_types=("moe",) * L,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1),
        grad_accum=8)


def deepseek_v2_236b() -> ModelConfig:
    # [arXiv:2405.04434] MLA kv_lora=512; 2 shared + 160 routed top-6
    L = 60
    return ModelConfig(
        arch_id="deepseek-v2-236b", family="moe", n_layers=L, d_model=5120,
        n_heads=128, n_kv_heads=128, d_head=128, d_ff=1536, vocab=102400,
        layer_types=("mla",) * L, mlp_types=("moe",) * L,
        mla=MLAConfig(kv_lora_rank=512, q_lora_rank=1536, qk_nope_dim=128,
                      qk_rope_dim=64, v_dim=128),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536, n_shared=2),
        grad_accum=8)


def jamba_52b() -> ModelConfig:
    # [arXiv:2403.19887] attn:mamba 1:7 (attn @ offset 4, period 8);
    # MoE every 2 layers (offset 1), 16 experts top-2.
    L = 32
    return ModelConfig(
        arch_id="jamba-v0.1-52b", family="hybrid", n_layers=L, d_model=4096,
        n_heads=32, n_kv_heads=8, d_head=128, d_ff=14336, vocab=65536,
        layer_types=tuple("attn" if i % 8 == 4 else "mamba"
                          for i in range(L)),
        mlp_types=tuple("moe" if i % 2 == 1 else "dense" for i in range(L)),
        pos_emb="none",
        ssm=SSMConfig(kind="mamba", d_state=16, d_conv=4, expand=2),
        moe=MoEConfig(n_experts=16, top_k=2, d_ff_expert=14336),
        grad_accum=8)


def rwkv6_7b() -> ModelConfig:
    # [arXiv:2404.05892] Finch: data-dependent decay, attn-free
    L = 32
    return ModelConfig(
        arch_id="rwkv6-7b", family="ssm", n_layers=L, d_model=4096,
        n_heads=64, n_kv_heads=64, d_head=64, d_ff=14336, vocab=65536,
        layer_types=("rwkv",) * L, mlp_types=("channelmix",) * L,
        pos_emb="none", norm="layernorm",
        ssm=SSMConfig(kind="rwkv6", head_dim=64, impl="chunked", chunk=64),
        grad_accum=4)


def _smoke_of(full: ModelConfig, **over) -> ModelConfig:
    """The JAX package's smoke twin: 4 layers, width 64, vocab 256, 8
    frontend embeddings and 2 encoder layers where the full config has
    them; a uniform layer program keeps its type, MoE shrinks to 4 experts
    (dropless: ``capacity_factor`` 8 >= E/k), MLA to ranks 32/48 and an
    SSM to state 4, head 16, chunks of 32 -- with the default
    ``impl="scan"``, so the RWKV-6 twin runs the stepwise recurrence
    where the full config runs the chunked one (as in JAX); float32
    parameters, no rematerialization and one microbatch a step."""
    base = dict(n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
                d_ff=128, vocab=256,
                n_frontend_tokens=8 if full.n_frontend_tokens else 0,
                n_enc_layers=2 if full.enc_dec else 0,
                param_dtype="float32", remat="none", grad_accum=1)
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
    if full.ssm:
        base.setdefault("ssm", SSMConfig(
            kind=full.ssm.kind, d_state=4, d_conv=4, expand=2, head_dim=16,
            chunk=32))
    return dataclasses.replace(full, **base)


def _smoke_jamba() -> ModelConfig:
    L = 8
    return _smoke_of(
        jamba_52b(), n_layers=L,
        layer_types=tuple("attn" if i % 4 == 2 else "mamba"
                          for i in range(L)),
        mlp_types=tuple("moe" if i % 2 == 1 else "dense" for i in range(L)),
        n_heads=4, n_kv_heads=2)


def _smoke_rwkv() -> ModelConfig:
    return _smoke_of(rwkv6_7b(), n_heads=4, n_kv_heads=4, d_head=16)


ALL = {
    "whisper-medium": (whisper_medium, lambda: _smoke_of(whisper_medium())),
    "jamba-v0.1-52b": (jamba_52b, _smoke_jamba),
    "qwen2.5-32b": (qwen25_32b, lambda: _smoke_of(qwen25_32b())),
    "smollm-135m": (smollm_135m, lambda: _smoke_of(smollm_135m())),
    "tinyllama-1.1b": (tinyllama_11b, lambda: _smoke_of(tinyllama_11b())),
    "granite-3-8b": (granite_3_8b, lambda: _smoke_of(granite_3_8b())),
    "paligemma-3b": (paligemma_3b, lambda: _smoke_of(paligemma_3b(),
                                                     n_kv_heads=1)),
    "rwkv6-7b": (rwkv6_7b, _smoke_rwkv),
    "llama4-scout-17b-a16e": (llama4_scout,
                              lambda: _smoke_of(llama4_scout())),
    "deepseek-v2-236b": (deepseek_v2_236b, lambda: _smoke_of(
        deepseek_v2_236b(), layer_types=("mla",) * 4)),
}

for _aid, (_full, _smoke) in ALL.items():
    register(_aid, _full, _smoke)
