"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=65536, Mamba:attn 7:1 interleave (attn at position 4 of each 8-layer
period), MoE 16e top-2 every other layer [arXiv:2403.19887; hf].
Mamba sub-blocks use the Mamba2/SSD matmul form (same asymptotics as the
paper's Mamba-1, MXU-friendly; see DESIGN.md hardware-adaptation notes)."""
from .base import ArchConfig, register


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        n_layers=32,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=65536,
        act="silu",
        moe=True,
        n_experts=16,
        top_k=2,
        d_ff_expert=14336,
        moe_period=2,
        hybrid_period=8,
        attn_positions=(4,),
        ssm=True,
        ssm_state=16,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_chunk=256,
        conv_kernel=4,
        subquadratic=True,
    )
