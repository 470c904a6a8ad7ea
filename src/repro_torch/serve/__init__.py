"""Online serving tier (counterpart of ``repro.serve``), vector side.

``VectorServer`` in :mod:`repro_torch.serve.vector` — continuous batching
over a ``VectorSearchEngine`` with pow2 batch-shape buckets, deadline /
backpressure admission (:mod:`repro_torch.serve.batcher`), host-plan /
device-run overlap, and background store maintenance behind a version
fence.  The LM side (``GenerationEngine``, ``RagPipeline``) is not ported.
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
from .vector import VectorServer, jit_compile_count

__all__ = [
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
