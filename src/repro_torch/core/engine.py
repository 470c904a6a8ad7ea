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

    ids = eng.insert(V)     # write-head rows, searched exactly at once
    eng.delete(ids)         # tombstones: slots poisoned and reusable
    eng.compact()           # repack; BOND/BSA recalibrated on survivors

Mutation upgrades the frozen ``PDXStore`` into a versioned
``core.layout.MutablePDXStore`` in place on first use, on the same device;
searches observe ``store.version`` through the plan trace, and the device
tensors and mirrors are rebuilt once per sealed mutation.

Tiered serving: ``search(Q, SearchSpec(hbm_slots=S))`` on an IVF engine
keeps the f32 masters on the host and a pool of ``S`` tile slots on the
device as a bucket-granular cache (``core.layout.BucketCache``, the
``tiered-scan`` executor).  ``build(index="ivf", tree=True)`` (or
``tree="auto"`` at nlist >= 4096) routes through the two-level centroid
tree.

Meshes (``repro_torch.dist``): ``build(..., mesh=)`` keeps a
``torch.distributed`` ``DeviceMesh`` as the engine's default and
``search(..., mesh=)`` overrides it per call; on a "data" axis the planner
routes an IVF engine's queries to the shards that own their buckets
(``routed_bucket``, or ``routed_tiered`` with ``hbm_slots``;
``repro_torch.dist.routing``) and shards a flat engine's partitions
(``block-sharded``, ``batch-block-sharded``), on a "model" axis
dimensions (``dim-sharded``).  Every rank builds and searches with the
same arguments and gets the same result (the SPMD contract,
``repro_torch.dist``).

    dist.init_process_group("gloo", ...)         # one process per rank
    mesh = repro_torch.dist.make_mesh((8,), ("data",), device="cpu")
    eng = VectorSearchEngine.build(X, index="ivf", mesh=mesh, device="cpu")
    eng.search(Q).plan.executor                  # "routed_bucket"
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
from .layout import MutablePDXStore, PDXStore, build_flat_store, pdx_to_nary
from .pdxearch import SearchStats
from .plan import ExecutionPlan, _mesh_layout, execute, plan_search
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
    """Store + pruner + optional IVF index + optional mesh, searched through
    the planner.  ``spec`` holds the engine's default ``SearchSpec`` (seeded
    from build kwargs); per-call specs override it."""

    store: PDXStore
    pruner: Pruner
    spec: SearchSpec = SearchSpec()
    ivf: Optional[IVFIndex] = None
    mesh: Any = None
    zone_size: int = 0          # BOND zone grouping (kept for pruner refresh)
    head_capacity: int = 256    # write-head size on mutable upgrade

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
        super_k: Optional[int] = None,
        nprobe_super: Optional[int] = None,
        device=None,
    ) -> "VectorSearchEngine":
        dev = resolve_device(device)
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
                seed=seed, precomputed=precomputed_ivf, tree=tree,
                super_k=super_k, nprobe_super=nprobe_super, device=dev,
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
        if mesh is not None:
            _mesh_layout(mesh, store)  # a mesh the store cannot use raises now
        return cls(store=store, pruner=pr, spec=spec, ivf=ivf, mesh=mesh,
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
        use_mesh = mesh if mesh is not None else self.mesh
        t0 = time.perf_counter()
        with _trace.query(n_queries=Qb.shape[0], k=base.k) as qtrace:
            with _trace.span("plan"):
                plan = plan_search(
                    base, self.store, Qb.shape[0], pruner=self.pruner,
                    ivf=self.ivf, mesh=use_mesh,
                )
            if qtrace is not None:
                qtrace.attrs["executor"] = plan.executor
            before = dataclasses.replace(stats) if (
                stats is not None and _metrics.enabled()
            ) else None
            ids, dists = execute(
                plan, base, self.store, self.pruner, Qb,
                ivf=self.ivf, mesh=use_mesh, stats=stats,
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
            pruner=self.pruner, ivf=self.ivf,
            mesh=mesh if mesh is not None else self.mesh,
        )

    # --------------------------------------------------------------- mutation
    def _ensure_mutable(self) -> MutablePDXStore:
        """Upgrade the frozen store into a MutablePDXStore on first mutation
        (in place; the IVF index keeps pointing at the same store object)."""
        if not isinstance(self.store, MutablePDXStore):
            kwargs = dict(head_capacity=self.head_capacity)
            if self.ivf is not None:
                kwargs.update(
                    num_buckets=self.ivf.nlist,
                    part_counts=self.ivf.part_counts,
                )
            self.store = MutablePDXStore.from_store(self.store, **kwargs)
            if self.ivf is not None:
                self.ivf.store = self.store
        return self.store

    def _sync_ivf(self) -> None:
        """Repacks move bucket boundaries; refresh the index's view of them."""
        if self.ivf is not None and isinstance(self.store, MutablePDXStore):
            self.ivf.part_offsets = self.store.part_offsets
            self.ivf.part_counts = self.store.part_counts

    def insert(self, X: np.ndarray) -> np.ndarray:
        """Add vectors; returns their new ids (valid for ``delete`` and in
        search results).  Rows land in the store's write-head — searched
        exactly by every executor from this call on — and are drained into
        sealed PDX tiles by a later flush/``compact()``.  IVF engines assign
        each row to its nearest centroid at insert time so the repack keeps
        buckets contiguous."""
        X = np.atleast_2d(np.ascontiguousarray(np.asarray(X, np.float32)))
        store = self._ensure_mutable()
        Xt = self.pruner.preprocess(X) if self.pruner.needs_preprocess else X
        assignments = self.ivf.assign(Xt) if self.ivf is not None else None
        new_ids = store.insert(Xt, assignments=assignments)
        self._sync_ivf()
        return new_ids

    def delete(self, ids) -> int:
        """Tombstone vectors by id; returns how many were live.  Their slots
        are poisoned (never rank into a top-k) and become reusable."""
        store = self._ensure_mutable()
        removed = store.delete(ids)
        self._sync_ivf()
        return removed

    def compact(self) -> None:
        """Repack: drain tombstones + write-head into minimal lane-aligned
        tiles and refresh store metadata (dim_means/dim_vars).  A BOND
        pruner is rebuilt from the repacked collection means, and a BSA
        pruner's PCA is recalibrated from a fresh sample of the survivors,
        the stored vectors re-projected in place (``replace_live_vectors``).
        Either way the pruner fingerprint changes."""
        store = self._ensure_mutable()
        store.repack()
        self._sync_ivf()
        if self.pruner.name == "bond":
            self.pruner = make_bond(
                store._dim_means, zone_size=self.zone_size, device=self.device
            )
        elif self.pruner.name == "bsa" and self.pruner.aux is not None:
            self._recalibrate_bsa(store)

    def _recalibrate_bsa(self, store: MutablePDXStore) -> None:
        """Refit BSA's PCA on the post-churn collection.  The projection is
        orthogonal, so the original-space vectors are recovered (up to float
        rounding) as ``X_t @ C.T``; a fresh sample refits the components and
        residual-energy quantiles, and the store's live rows are
        re-projected in place.  IVF centroids ride along: bucket assignments
        are rotation-invariant, so only their coordinates change, and a
        two-level tree is re-clustered in the rotated space."""
        Xt = pdx_to_nary(store)  # live vectors, old projected space, id order
        if len(Xt) < 2:
            return  # no covariance to fit; keep the current calibration
        C_old = np.asarray(self.pruner.aux["components"], np.float32)
        X_orig = Xt @ C_old.T
        sample = X_orig[: min(len(X_orig), 65536)]  # mirror build-time sampling
        new_pruner = make_bsa(
            sample, m=self.pruner.aux["m"], seed=self.pruner.aux["seed"],
            device=self.device,
        )
        store.replace_live_vectors(new_pruner.preprocess(X_orig))
        if self.ivf is not None:
            cents = new_pruner.preprocess(
                self.ivf.centroids.cpu().numpy() @ C_old.T
            )
            self.ivf.centroids = torch.from_numpy(cents).to(self.device)
            self.ivf.centroid_store = build_flat_store(
                cents, capacity=self.ivf.centroid_store.capacity,
                device=self.device,
            )
            if self.ivf.tree_enabled:
                # the tree clusters *centroids*: re-cluster it in the
                # rotated space, keeping the configured fan-out
                self.ivf.attach_tree(
                    int(self.ivf.super_children.shape[0]),
                    self.ivf.nprobe_super,
                    seed=self.pruner.aux["seed"],
                )
        self.pruner = new_pruner

    # --------------------------------------------------------- observability
    def metrics(self) -> dict:
        """Deterministic snapshot of the process-wide metrics registry
        (``repro_torch.obs.metrics``) — counters, gauges, histograms.
        Enable recording with ``obs.metrics.set_enabled(True)`` or
        ``REPRO_OBS=1``."""
        return _metrics.get_registry().snapshot()

    def dump_trace(self, path: Optional[str] = None) -> dict:
        """Recorded ``QueryTrace`` ring as Chrome/Perfetto trace JSON
        (written to ``path`` when given; loadable at ui.perfetto.dev)."""
        return _trace.get_tracer().export_chrome(path)

    # ------------------------------------------------------------------ util
    @property
    def metric(self) -> str:
        return self.spec.metric

    @property
    def num_vectors(self) -> int:
        return self.store.num_vectors

    @property
    def dim(self) -> int:
        return self.store.dim
