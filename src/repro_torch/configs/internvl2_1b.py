"""internvl2-1b [vlm] — InternViT frontend (stub) + InternLM2 LM backbone.
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655 [arXiv:2404.16821; hf].
The vision frontend is a STUB: input_specs() provides precomputed patch
embeddings (B, n_patches, d_model) that are prepended to the token stream.
"""
from .base import ArchConfig, register


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b",
        family="vlm",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        head_dim=64,
        d_ff=4864,
        vocab=151655,
        act="silu",
        rope_theta=1_000_000.0,
        tie_embeddings=True,
        vlm=True,
        n_patches=256,
    )
