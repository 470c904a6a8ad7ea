"""whisper-small [audio] — enc-dec, 12L encoder + 12L decoder, d_model=768
12H d_ff=3072 vocab=51865 [arXiv:2212.04356; unverified].  The conv frontend
is a STUB: input_specs() provides precomputed frame embeddings
(B, 1500, d_model).  FFNs use the framework-uniform GLU form (see DESIGN.md:
substitutes Whisper's plain-GELU MLP; dims preserved)."""
from .base import ArchConfig, register


@register
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-small",
        family="audio",
        n_layers=12,
        d_model=768,
        n_heads=12,
        n_kv_heads=12,
        head_dim=64,
        d_ff=3072,
        vocab=51865,
        act="gelu",
        encdec=True,
        n_enc_layers=12,
        enc_seq=1500,
    )
