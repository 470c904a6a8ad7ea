"""The paper's primary contribution on PyTorch: the PDX layout, PDXearch,
pruners, fronted by the declarative spec/plan API (counterpart of
``repro.core``).

  * ``spec``   — ``SearchSpec`` (what to search) and ``SearchResult``.
  * ``plan``   — the query planner and executor registry: adaptive /
                 jit-masked / batch-matmul / fused / cascade execution.
  * ``engine`` — ``VectorSearchEngine``, the public entry point;
                 ``insert``/``delete``/``compact`` mutate the store live
                 (upgrading it to a versioned ``MutablePDXStore``).
  * ``layout`` / ``distance`` / ``pruners`` / ``pdxearch`` / ``topk`` — the
    building blocks.
"""
import importlib

# name -> submodule.  Resolved on first access (PEP 562), so importing a
# leaf such as ``index.kmeans`` — which needs ``core.device`` — does not
# pull in the engine, and through it ``index`` again, half-loaded.
_EXPORTS = {
    "VectorSearchEngine": "engine",
    "MutablePDXStore": "layout",
    "PDXStore": "layout",
    "build_bucketed_store": "layout",
    "build_flat_store": "layout",
    "SearchStats": "pdxearch",
    "pdxearch": "pdxearch",
    "pdxearch_jit": "pdxearch",
    "search_batch_matmul": "pdxearch",
    "ExecutionPlan": "plan",
    "execute": "plan",
    "executor_names": "plan",
    "plan_search": "plan",
    "make_adsampling": "pruners",
    "make_bond": "pruners",
    "make_bsa": "pruners",
    "make_plain_pruner": "pruners",
    "SearchResult": "spec",
    "SearchSpec": "spec",
}

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f".{_EXPORTS[name]}", __name__), name)
    globals()[name] = value
    return value
