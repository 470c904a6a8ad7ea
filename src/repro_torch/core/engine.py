"""VectorSearchEngine — the port's public vector-search API.

Counterpart of ``repro.core.engine``: combines layout + index + pruner and
delegates execution mode to the planner (``core.plan``).  NumPy in, NumPy
out; the store lives on one device.

    eng = VectorSearchEngine.build(X, index="ivf", pruner="adsampling")
    res = eng.search(Q, SearchSpec(k=10, scan_dtype="int8"))
    res.ids, res.dists, res.plan.executor

``build(..., device=None)`` places the store on ``"cuda"``; where no card
exists it raises and asks for ``device="cpu"``, never falling back
quietly.  On CUDA the planner picks the fused executors (or, for a spec
with a ``cascade``, the cascade executors), which run the hand-written
kernels; on the CPU the same executors run their plain PyTorch versions
when a spec asks for them.

Not ported yet (each raises ``NotImplementedError`` naming its ROADMAP
item): ``insert``/``delete``/``compact`` (the mutable store), meshes, the
IVF centroid tree and tiered serving.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Optional

import numpy as np
import torch

from ..index.ivf import IVFIndex, build_ivf
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .device import resolve_device
from .layout import PDXStore, build_flat_store
from .pdxearch import SearchStats
from .plan import ExecutionPlan, _not_ported, execute, plan_search
from .pruners import (
    Pruner,
    make_adsampling,
    make_bond,
    make_bond_decreasing,
    make_bsa,
    make_plain_pruner,
)
from .spec import SearchResult, SearchSpec

__all__ = [
    "VectorSearchEngine", "SearchSpec", "SearchResult", "SearchStats",
    "resolve_device",
]

PRUNERS = ("linear", "adsampling", "bsa", "bond", "bond-decreasing")


def _make_pruner(
    name: str,
    X: np.ndarray,
    *,
    eps0: float,
    bsa_m: float,
    zone_size: int,
    seed: int,
    device,
) -> Pruner:
    if name == "linear":
        return make_plain_pruner()
    if name == "adsampling":
        return make_adsampling(X.shape[1], eps0=eps0, seed=seed, device=device)
    if name == "bsa":
        sample = X[: min(len(X), 65536)]
        return make_bsa(sample, m=bsa_m, seed=seed, device=device)
    if name == "bond":
        return make_bond(X.mean(axis=0), zone_size=zone_size, device=device)
    if name == "bond-decreasing":
        return make_bond_decreasing(X.shape[1])
    raise ValueError(f"pruner must be one of {PRUNERS}, got {name!r}")


@dataclasses.dataclass
class VectorSearchEngine:
    """Store + pruner + optional IVF index, searched through the planner.
    ``spec`` holds the engine's default ``SearchSpec`` (seeded from build
    kwargs); per-call specs override it."""

    store: PDXStore
    pruner: Pruner
    spec: SearchSpec = SearchSpec()
    ivf: Optional[IVFIndex] = None
    zone_size: int = 0

    @property
    def device(self) -> torch.device:
        return self.store.device

    # ------------------------------------------------------------------ build
    @classmethod
    def build(
        cls,
        X: np.ndarray,
        *,
        metric: str = "l2",
        index: str = "flat",
        pruner: str = "adsampling",
        capacity: int = 1024,
        nlist: Optional[int] = None,
        eps0: float = 2.1,
        bsa_m: float = 3.0,
        zone_size: int = 0,
        schedule: str = "adaptive",
        delta_d: int = 32,
        sel_frac: float = 0.2,
        group: int = 8,
        kmeans_iters: int = 10,
        seed: int = 0,
        precomputed_ivf=None,
        spec: Optional[SearchSpec] = None,
        mesh: Any = None,
        routing: str = "bucket",
        scan_dtype: str = "f32",
        kernel: str = "auto",
        rerank_mult: int = 4,
        cascade: Optional[tuple] = None,
        route_dtype: str = "f32",
        tree="auto",
        device=None,
    ) -> "VectorSearchEngine":
        dev = resolve_device(device)
        if mesh is not None:
            raise _not_ported("building on a device mesh", "'Multi-device search'")
        X = np.ascontiguousarray(np.asarray(X, np.float32))
        pr = _make_pruner(
            pruner, X, eps0=eps0, bsa_m=bsa_m, zone_size=zone_size, seed=seed,
            device=dev,
        )
        Xt = pr.preprocess(X) if pr.needs_preprocess else X
        ivf = None
        if index == "ivf":
            nlist = nlist or max(int(np.sqrt(len(X))), 1)
            ivf = build_ivf(
                Xt, nlist, capacity=capacity, kmeans_iters=kmeans_iters,
                seed=seed, precomputed=precomputed_ivf, tree=tree, device=dev,
            )
            store = ivf.store
        elif index == "flat":
            store = build_flat_store(Xt, capacity=capacity, device=dev)
        else:
            raise ValueError(f"index must be 'flat' or 'ivf', got {index!r}")
        if spec is None:
            spec = SearchSpec(
                metric=metric, schedule=schedule, delta_d=delta_d,
                sel_frac=sel_frac, group=group, routing=routing,
                scan_dtype=scan_dtype, kernel=kernel,
                rerank_mult=rerank_mult, cascade=cascade,
                route_dtype=route_dtype,
            )
        return cls(store=store, pruner=pr, spec=spec, ivf=ivf,
                   zone_size=zone_size)

    # ----------------------------------------------------------------- search
    def search(
        self,
        q: np.ndarray,
        spec: Optional[SearchSpec] = None,
        *,
        stats: Optional[SearchStats] = None,
        mesh: Any = None,
        **overrides,
    ) -> SearchResult:
        """Search for the nearest neighbours of ``q`` under ``spec``.

        ``q`` — one (D,) query or a (B, D) batch (NumPy or a tensor); the
        result's NumPy ids/dists are (k,) or (B, k).  Keyword ``overrides``
        (any ``SearchSpec`` field) apply on top of ``spec`` or the engine's
        default."""
        if isinstance(spec, (int, np.integer)):  # legacy positional k
            overrides.setdefault("k", spec)
            spec = None
        base = spec if spec is not None else self.spec
        if overrides:
            base = base.replace(**overrides)
        Q = torch.as_tensor(q, dtype=torch.float32).to(self.device)
        if Q.ndim not in (1, 2):
            raise ValueError(f"q must be (D,) or (B, D), got shape {tuple(Q.shape)}")
        single = Q.ndim == 1
        Qb = Q[None, :] if single else Q
        t0 = time.perf_counter()
        with _trace.query(n_queries=Qb.shape[0], k=base.k) as qtrace:
            with _trace.span("plan"):
                plan = plan_search(
                    base, self.store, Qb.shape[0], pruner=self.pruner,
                    ivf=self.ivf, mesh=mesh,
                )
            if qtrace is not None:
                qtrace.attrs["executor"] = plan.executor
            before = dataclasses.replace(stats) if (
                stats is not None and _metrics.enabled()
            ) else None
            ids, dists = execute(
                plan, base, self.store, self.pruner, Qb,
                ivf=self.ivf, stats=stats,
            )
        if _metrics.enabled():
            B = Qb.shape[0]
            _metrics.counter(
                "repro_search_batches_total", executor=plan.executor
            )
            _metrics.counter(
                "repro_search_queries_total", float(B),
                executor=plan.executor,
            )
            _metrics.observe(
                "repro_search_latency_seconds", time.perf_counter() - t0,
                executor=plan.executor,
            )
            if before is not None:
                for kind, attr in (
                    ("total", "values_total"),
                    ("computed", "values_computed"),
                    ("avoided", "values_avoided"),
                ):
                    delta = getattr(stats, attr) - getattr(before, attr)
                    if delta:
                        _metrics.counter(
                            "repro_pruning_values_total", delta,
                            executor=plan.executor, kind=kind,
                        )
        if single:
            ids, dists = ids[0], dists[0]
        return SearchResult(ids=ids, dists=dists, spec=base, plan=plan,
                            stats=stats, trace=qtrace)

    def plan(
        self,
        q: np.ndarray,
        spec: Optional[SearchSpec] = None,
        *,
        mesh: Any = None,
    ) -> ExecutionPlan:
        """Dry-run the planner: which executor would ``search(q, spec)`` use."""
        n_queries = 1 if np.ndim(q) == 1 else len(q)
        return plan_search(
            spec if spec is not None else self.spec, self.store, n_queries,
            pruner=self.pruner, ivf=self.ivf, mesh=mesh,
        )

    # --------------------------------------------------------------- mutation
    def insert(self, X: np.ndarray) -> np.ndarray:
        raise _not_ported("insert (the mutable store)", "'Mutable store'")

    def delete(self, ids) -> int:
        raise _not_ported("delete (the mutable store)", "'Mutable store'")

    def compact(self) -> None:
        raise _not_ported("compact (the mutable store)", "'Mutable store'")
