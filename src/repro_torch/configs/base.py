"""Model configuration and the architecture registry (this slice: the
decoder-only llama-style family that ``smollm-135m`` belongs to)."""

from __future__ import annotations

import dataclasses
from typing import Callable

from repro_torch.core.rns_matmul import RnsDotConfig

__all__ = ["ModelConfig", "register", "get_config"]


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
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"
    act: str = "silu"
    gated_mlp: bool = True
    causal: bool = True
    tie_embeddings: bool = False
    # numerics / paper technique: the RNS datapath on these targets
    rns: RnsDotConfig | None = None
    rns_targets: str = "mlp"               # mlp|attn|all
    # sliding-window attention (None: full): query q attends keys
    # [q - attn_window + 1, q]; the serving engines set it from
    # ServeConfig.window_tokens
    attn_window: int | None = None
    # prompts longer than this use the q-tiled (flash) prefill attention
    attn_dense_max: int = 1024
    attn_q_chunk: int = 512
    attn_kv_chunk: int = 1024

    @property
    def period(self) -> int:
        """Layers in the smallest repeating pattern: 1, since every layer
        of this slice's family is (attention, dense MLP).  The JAX package
        stacks layer ``i`` as entry ``i // period`` of slot ``i % period``."""
        return 1


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
