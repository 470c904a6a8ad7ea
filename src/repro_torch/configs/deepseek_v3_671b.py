"""deepseek-v3-671b [moe] — 61L d_model=7168 128H MLA d_ff_expert=2048
vocab=129280, MoE 1 shared + 256 routed top-8, aux-loss-free routing bias,
3 leading dense layers (d_ff 18432) [arXiv:2412.19437; hf].
MTP head omitted (orthogonal to this study; see DESIGN.md)."""
from .base import ArchConfig, register


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b",
        family="moe",
        n_layers=61,
        d_model=7168,
        n_heads=128,
        n_kv_heads=128,
        d_ff=2048,
        vocab=129280,
        act="silu",
        rope_theta=10_000.0,
        moe=True,
        n_experts=256,
        top_k=8,
        n_shared=1,
        d_ff_expert=2048,
        n_dense_layers=3,
        d_ff_dense=18432,
        router_aux_free=True,
        mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    )
