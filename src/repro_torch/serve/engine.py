"""Batched LM serving engine (counterpart of ``repro.serve.engine``):
prefill, then a greedy or temperature decode loop.

One of the package's two serving paths: this module is the *generation*
side; the *vector-search* side is ``repro_torch.serve.vector.VectorServer``,
and ``repro_torch.serve.rag`` joins the two into a retrieval-augmented
pipeline.  Where the reference jits prefill and decode, the port runs them
eagerly on the params' device.  Every ``generate`` call allocates its own
caches, so two calls on the same batch give the same tokens.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models.lm import LMModel

__all__ = ["GenerationEngine"]


@dataclasses.dataclass
class GenerationEngine:
    model: LMModel
    params: dict
    cache_len: int

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @torch.no_grad()
    def generate(
        self,
        batch: dict,
        max_new_tokens: int = 16,
        temperature: float = 0.0,
        seed: int = 0,
    ) -> np.ndarray:
        """batch: {'tokens': (B, S), ...modality inputs}. Returns (B, new)
        int32.  Decoding starts at ``pos0 = S`` (``S + n_patches`` for a
        VLM, whose patch embeddings come before the prompt); the batch's
        arrays go to the params' device first.

        Greedy decoding takes the first of tied maxima, as the reference
        does.  Sampling at ``temperature > 0`` draws from a
        ``torch.Generator`` seeded with ``seed`` on the params' device: it is
        deterministic per seed, but not the reference's ``jax.random``
        stream."""
        cfg = self.model.cfg
        batch = {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}
        S = batch["tokens"].shape[1]
        pos0 = S + (cfg.n_patches if cfg.vlm else 0)
        if pos0 + max_new_tokens > self.cache_len:
            raise ValueError(f"cache too small: {pos0} prompt positions + {max_new_tokens} "
                             f"new tokens > cache_len {self.cache_len}")
        logits, caches = self.model.prefill(self.params, batch, self.cache_len)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        out = []
        for t in range(max_new_tokens):
            if temperature > 0:
                probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
                tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                tok = torch.argmax(logits, dim=-1)
            out.append(tok)
            if t == max_new_tokens - 1:
                break
            logits, caches = self.model.decode_step(self.params, tok[:, None], caches, pos0 + t)
        return torch.stack(out, dim=1).to(torch.int32).cpu().numpy()

    @torch.no_grad()
    def embed(self, batch: dict) -> np.ndarray:
        """Mean-pooled final hidden state (f32) — the RAG query/corpus
        embedding, (B, d)."""
        h = self.model.forward_train(self.params, batch)
        return torch.mean(h.to(torch.float32), dim=1).cpu().numpy()
