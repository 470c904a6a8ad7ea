"""Retrieval-augmented serving (counterpart of ``repro.serve.rag``): the
paper's technique as the retrieval substrate of an LLM pipeline (paper §1:
"LLM pipelines ... at the throughput needed by LLMs").

Pipeline per request batch:
  1. embed queries with the LM (mean-pooled hidden states),
  2. PDX search (ADSampling / BOND / linear) over the document store,
  3. prepend retrieved document tokens to the prompt,
  4. generate.

The document store is the port's ``VectorSearchEngine`` on the LM's
device: on the card a batch of queries plans ``fused-batch`` (K2) and a
single query ``fused-scan`` (K1).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.device import resolve_device
from ..core.engine import VectorSearchEngine
from ..obs import metrics as _metrics
from .engine import GenerationEngine

__all__ = ["RagPipeline"]


def _embed_docs(engine: GenerationEngine, doc_tokens: np.ndarray) -> np.ndarray:
    """LM-embed documents in chunks of 32 -> (n_docs, D) float32."""
    embeds = [engine.embed({"tokens": doc_tokens[lo:lo + 32]})
              for lo in range(0, len(doc_tokens), 32)]
    return np.concatenate(embeds, axis=0)


@dataclasses.dataclass
class RagPipeline:
    engine: GenerationEngine
    store: VectorSearchEngine
    doc_tokens: np.ndarray        # (n_docs, doc_len) int32
    retrieve_k: int = 1

    @classmethod
    def build(
        cls,
        engine: GenerationEngine,
        doc_tokens: np.ndarray,
        *,
        pruner: str = "adsampling",
        index: str = "flat",
        capacity: int = 256,
        retrieve_k: int = 1,
        mesh=None,
        routing: str = "bucket",
        device=None,
    ) -> "RagPipeline":
        """Embed every document with the LM and build the PDX store on
        ``device``, which must be the LM's (``None`` means the CUDA card,
        as for every builder of the port).

        ``mesh``/``routing`` flow into the search engine: with a
        "data"-axis mesh and an IVF index, retrieval batches are
        bucket-routed across shards instead of broadcast to a mirrored
        store."""
        dev = resolve_device(device)
        lm = engine.device
        if dev.type != lm.type or (dev.index is not None and dev.index != lm.index):
            raise ValueError(f"the store would live on {dev}, the LM on {lm}: "
                             "RagPipeline keeps both on one device")
        doc_tokens = np.asarray(doc_tokens, np.int32)
        store = VectorSearchEngine.build(
            _embed_docs(engine, doc_tokens), pruner=pruner, index=index,
            capacity=capacity, mesh=mesh, routing=routing, device=lm,
        )
        return cls(engine=engine, store=store, doc_tokens=doc_tokens, retrieve_k=retrieve_k)

    def add_documents(self, doc_tokens: np.ndarray) -> np.ndarray:
        """Absorb new documents into the live store; returns their doc ids.

        Embeds the documents with the LM and ``insert``s the embeddings —
        they land in the mutable store's write-head and are retrievable by
        the very next ``retrieve``/``answer`` call, no rebuild.  Store ids
        are allocated consecutively from the initial corpus size, so a doc's
        id stays its row in ``self.doc_tokens``.
        """
        doc_tokens = np.asarray(doc_tokens, np.int32)
        if len(doc_tokens) == 0:
            return np.zeros((0,), np.int32)
        ids = self.store.insert(_embed_docs(self.engine, doc_tokens))
        self.doc_tokens = np.concatenate([self.doc_tokens, doc_tokens], axis=0)
        return ids

    def retrieve(self, query_batch: dict) -> np.ndarray:
        """-> (B, retrieve_k) document ids.  One planned search for the whole
        embedding batch, counted in ``repro_rag_retrievals_total`` by the
        executor the planner chose."""
        q_emb = np.atleast_2d(self.engine.embed(query_batch))
        res = self.store.search(q_emb, self.store.spec.replace(k=self.retrieve_k))
        _metrics.counter(
            "repro_rag_retrievals_total", float(len(q_emb)),
            executor=res.plan.executor,
        )
        return np.asarray(res.ids)

    def answer(
        self, query_batch: dict, max_new_tokens: int = 16
    ) -> tuple[np.ndarray, np.ndarray]:
        """-> (generated tokens (B, new), retrieved doc ids (B, k))."""
        doc_ids = self.retrieve(query_batch)
        ctx = self.doc_tokens[doc_ids[:, 0]]          # (B, doc_len)
        tokens = np.concatenate(
            [ctx, np.asarray(query_batch["tokens"])], axis=1
        ).astype(np.int32)
        batch = dict(query_batch)
        batch["tokens"] = tokens
        return self.engine.generate(batch, max_new_tokens), doc_ids
