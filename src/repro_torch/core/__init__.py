"""The paper's primary contribution on PyTorch: the PDX layout, PDXearch,
pruners, fronted by the declarative spec/plan API (counterpart of
``repro.core``).

  * ``spec``   — ``SearchSpec`` (what to search) and ``SearchResult``.
  * ``plan``   — the query planner and executor registry.
  * ``engine`` — ``VectorSearchEngine``, the public entry point.
  * ``layout`` / ``distance`` / ``pruners`` / ``pdxearch`` / ``topk`` — the
    building blocks.
"""
