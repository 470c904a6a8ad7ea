"""Online serving tier (counterpart of ``repro.serve``).

Two serving paths live here:

* **Vector search** (the PDX side): ``VectorServer`` in
  :mod:`repro_torch.serve.vector` — continuous batching over a
  ``VectorSearchEngine`` with pow2 batch-shape buckets, deadline /
  backpressure admission (:mod:`repro_torch.serve.batcher`), host-plan /
  device-run overlap, and background store maintenance behind a version
  fence.
* **LM generation**: ``GenerationEngine`` in :mod:`repro_torch.serve.engine`
  (prefill + eager decode loop) and the retrieval-augmented pipeline
  ``RagPipeline`` in :mod:`repro_torch.serve.rag` that joins the two.
"""
from .batcher import (
    AdmissionQueue,
    DeadlineExceeded,
    QueryItem,
    ServeError,
    ServerClosed,
    ServerOverloaded,
    pad_batch,
    shape_bucket,
)
from .engine import GenerationEngine
from .rag import RagPipeline
from .vector import VectorServer, jit_compile_count

__all__ = [
    "GenerationEngine",
    "RagPipeline",
    "VectorServer",
    "jit_compile_count",
    "AdmissionQueue",
    "QueryItem",
    "ServeError",
    "ServerOverloaded",
    "ServerClosed",
    "DeadlineExceeded",
    "shape_bucket",
    "pad_batch",
]
