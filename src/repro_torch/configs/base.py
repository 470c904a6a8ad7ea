"""Architecture + run configuration system.

``ArchConfig`` is the single source of truth for a model; every assigned
architecture file in this package instantiates one with the exact published
dimensions and registers it.  ``reduced()`` derives the CPU-smoke-test config
(same family/topology, tiny dims).  ``SHAPES`` defines the assigned
input-shape grid (seq_len x global_batch and which step each cell lowers).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

__all__ = ["ArchConfig", "ShapeSpec", "SHAPES", "register", "get_config", "list_configs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    act: str = "silu"           # glu gate activation: silu (SwiGLU) | gelu (GeGLU)
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    d_ff_expert: int = 0
    n_dense_layers: int = 0      # leading dense (non-MoE) layers
    d_ff_dense: int = 0          # ff width of those dense layers (0 -> d_ff)
    moe_period: int = 1          # MoE every `period`-th layer within the stack
    capacity_factor: float = 1.25
    router_aux_free: bool = False
    # --- MLA (deepseek-v3) ---
    mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    # --- SSM (mamba2 / jamba) ---
    ssm: bool = False
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_kernel: int = 4
    # --- hybrid (jamba): layer pattern within a period ---
    hybrid_period: int = 0
    attn_positions: tuple[int, ...] = ()
    # --- encoder-decoder (whisper) ---
    encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500          # stubbed conv-frontend output frames
    # --- VLM (internvl2) ---
    vlm: bool = False
    n_patches: int = 256         # stubbed vision-frontend patch embeddings
    # --- attention scaling for long ctx ---
    subquadratic: bool = False   # True for ssm/hybrid: long_500k runnable
    # --- misc ---
    scale_embed: bool = False    # gemma-style sqrt(d_model) embedding scale

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def reduced(self) -> "ArchConfig":
        """Tiny same-topology config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 4 if not self.hybrid_period else self.hybrid_period),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab=256,
            n_experts=min(self.n_experts, 8),
            top_k=min(self.top_k, 2),
            n_shared=min(self.n_shared, 1),
            d_ff_expert=32 if self.moe else 0,
            n_dense_layers=min(self.n_dense_layers, 1),
            d_ff_dense=128 if self.n_dense_layers else 0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=32 if self.mla else 0,
            qk_nope_head_dim=16 if self.mla else 0,
            qk_rope_head_dim=8 if self.mla else 0,
            v_head_dim=16 if self.mla else 0,
            ssm_state=16 if self.ssm else 0,
            ssm_head_dim=16 if self.ssm else 64,
            ssm_chunk=16,
            n_enc_layers=min(self.n_enc_layers, 2),
            enc_seq=32,
            n_patches=8,
        )


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    step: str                    # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(fn: Callable[[], ArchConfig]):
    cfg = fn()
    _REGISTRY[cfg.name] = fn
    return fn


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        from . import _load_all  # lazy-import arch modules

        _load_all()
    return _REGISTRY[name]()


def list_configs() -> list[str]:
    from . import _load_all

    _load_all()
    return sorted(_REGISTRY)


def shape_is_applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """The assigned-cell applicability rules (documented in DESIGN.md)."""
    if shape == "long_500k" and not cfg.subquadratic:
        return False, "pure full-attention arch: 500k decode needs sub-quadratic attention"
    return True, ""
