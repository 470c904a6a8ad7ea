"""The language models (counterpart of ``repro.models``) in plain tensor
code: the dense LM (GQA with a KV cache, GLU FFN), the routed MoE, MLA
with its absorbed-latent decode, Mamba2 SSD and the hybrid stack, the
encoder-decoder with cross-attention and the VLM's patch prefix."""
