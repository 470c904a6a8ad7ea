"""mamba2-370m [ssm] — 48L d_model=1024 attn-free vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060; unverified]."""
from .base import ArchConfig, register


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-370m",
        family="ssm",
        n_layers=48,
        d_model=1024,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        tie_embeddings=True,
        ssm=True,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_groups=1,
        ssm_chunk=256,
        conv_kernel=4,
        subquadratic=True,
    )
