"""The language models (counterpart of ``repro.models``): the dense LM
(GQA with a KV cache, GLU FFN) in plain tensor code."""
