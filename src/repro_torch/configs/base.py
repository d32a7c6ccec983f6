"""Model configuration and the architecture registry: decoder-only
models (GQA or MLA attention, Mamba or RWKV-6 layers, dense, MoE or
channel-mix MLPs), encoder-decoder models and models with a modality
frontend (precomputed frame or patch embeddings)."""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.rns_matmul import RnsDotConfig
from repro_torch.models.moe import MoEConfig
from repro_torch.models.ssm import SSMConfig

__all__ = ["MLAConfig", "ModelConfig", "SSMConfig", "at_depth", "register",
           "get_config", "list_archs"]

#: position schemes: rotary on q/k, sinusoidal absolute positions added
#: to the stream, none (the recurrences carry order)
POS_EMB = ("rope", "none", "sinusoidal")


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 1536
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab: int
    family: str = "dense"                  # dense|moe|ssm|hybrid|audio|vlm
    # per-layer programs (len == n_layers; empty: all attn / all dense)
    layer_types: tuple[str, ...] = ()      # attn|mla|mamba|rwkv
    mlp_types: tuple[str, ...] = ()        # dense|moe|channelmix
    qkv_bias: bool = False                 # a bias on q, k and v (Qwen2)
    rope_theta: float = 10000.0
    pos_emb: str = "rope"                  # rope|sinusoidal|none
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    causal: bool = True
    tie_embeddings: bool = False
    emb_scale: bool = False                # gemma: embeddings * sqrt(d)
    # encoder-decoder: an encoder stack of n_enc_layers over the frontend
    # frames, cross-attention in every decoder attention layer.
    # ``enc_causal`` is carried and, as in the JAX package, never read:
    # the encoder's attention follows ``causal`` (ROADMAP C.15)
    enc_dec: bool = False
    n_enc_layers: int = 0
    enc_causal: bool = False
    # modality frontend stub: n_frontend_tokens precomputed embeddings
    # [B, F, d] a prompt brings (the encoder's frames, or a prefix of
    # the decoder stream)
    frontend: str | None = None            # audio|vision
    n_frontend_tokens: int = 0
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    # numerics / paper technique: the RNS datapath on these targets
    rns: RnsDotConfig | None = None
    rns_targets: str = "mlp"               # mlp|attn|all
    # training: parameter dtype (float32 only in the port), rematerial-
    # ization per layer ("full": each layer's activations recomputed in
    # the backward, torch.utils.checkpoint) and microbatches a step
    param_dtype: str = "float32"
    remat: str = "full"                    # none|full
    grad_accum: int = 1
    # sliding-window attention (None: full): query q attends keys
    # [q - attn_window + 1, q]; the serving engines set it from
    # ServeConfig.window_tokens
    attn_window: int | None = None
    # prompts longer than this use the q-tiled (flash) prefill attention
    attn_dense_max: int = 1024
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024

    def __post_init__(self):
        if not self.layer_types:
            object.__setattr__(self, "layer_types", ("attn",) * self.n_layers)
        if not self.mlp_types:
            object.__setattr__(self, "mlp_types", ("dense",) * self.n_layers)
        assert len(self.layer_types) == self.n_layers
        assert len(self.mlp_types) == self.n_layers
        if self.pos_emb not in POS_EMB:
            raise ValueError(f"pos_emb={self.pos_emb!r}: one of {POS_EMB}")
        if self.remat not in ("none", "full"):
            raise ValueError(f"remat={self.remat!r}: none or full")

    @property
    def period(self) -> int:
        """Smallest p with a periodic (layer, mlp) program.  The JAX
        package stacks layer ``i`` as entry ``i // period`` of slot
        ``i % period``."""
        L = self.n_layers
        prog = list(zip(self.layer_types, self.mlp_types))
        for p in range(1, L + 1):
            if L % p == 0 and all(prog[i] == prog[i % p] for i in range(L)):
                return p
        return L


def at_depth(cfg: ModelConfig, n_layers: int) -> ModelConfig:
    """``cfg`` cut (or extended, periodically) to ``n_layers`` decoder
    layers: ``layer_types`` and ``mlp_types`` follow the depth, as the
    config requires.  An encoder stack (``n_enc_layers``) keeps its
    depth."""
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        layer_types=tuple(cfg.layer_types[i % cfg.n_layers]
                          for i in range(n_layers)),
        mlp_types=tuple(cfg.mlp_types[i % cfg.n_layers]
                        for i in range(n_layers)))


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}
_SMOKE: dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig],
             smoke: Callable[[], ModelConfig]):
    _REGISTRY[arch_id] = full
    _SMOKE[arch_id] = smoke


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    import repro_torch.configs.all_archs  # noqa: F401  (populates registry)

    reg = _SMOKE if smoke else _REGISTRY
    if arch_id not in reg:
        raise KeyError(f"unknown arch {arch_id!r}; have {sorted(_REGISTRY)}")
    return reg[arch_id]()


def list_archs() -> list[str]:
    """The architectures the port registers, sorted."""
    import repro_torch.configs.all_archs  # noqa: F401  (populates registry)

    return sorted(_REGISTRY)
