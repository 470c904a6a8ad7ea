"""Query planner + executor registry — *how* a ``SearchSpec`` executes.

Counterpart of ``repro.core.plan`` for one device.  ``plan_search`` maps
(spec, store, query count) onto a registered executor; ``execute`` runs
it.  All executors answer the same question — top-k under the spec's
metric/pruner config — and differ only in execution strategy:

  adaptive      host-orchestrated PDXearch (paper Section 4); the only
                executor with per-query IVF routing.
  batch-matmul  exact matmul scan of a (B, D) query batch.
  fused-scan    one launch of the whole-store fused scan (K1) with the
                ADSampling test fused per d-tile, over the store's device
                mirror at ``spec.scan_dtype`` width, seeded by an exact
                START scan of one partition (the IVF-routed nearest
                bucket's first partition when an index exists).
  fused-batch   one launch of the batched distance kernel (K2) over every
                mirror tile — the batched counterpart of fused-scan.

Both fused executors re-rank the top ``rerank_mult * k`` candidates
against the f32 master tiles whenever ``scan_dtype != "f32"``, so returned
distances stay exact.  Their kernels run on CUDA tensors; on CPU tensors
the same ops run the kernels' plain PyTorch versions (``kernels.ops``
dispatches by device).

Planner rules, in order: a forced ``spec.executor`` wins; otherwise a
fused-eligible spec (``kernel="cuda"``, a store on CUDA with
``kernel="auto"``, or any reduced-precision ``scan_dtype``) picks a fused
executor — single L2 queries the scan, batches (and other metrics) the
batched kernel; otherwise batches take the matmul scan and single queries
the adaptive path.  ``kernel="cuda"`` on a CPU store raises, and so does
``kernel="torch"`` when a fused executor would run on a CUDA store: the
knob steers planning, the tensors' device picks the body.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item: ``jit-masked`` (``prefer_static``), the cascade executors,
tiered serving (``hbm_slots``) and the mesh-sharded executors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .distance import pdx_distance
from .layout import PDXStore, device_mirror
from .pdxearch import SearchStats, pdxearch, search_batch_matmul
from .pruners import Pruner
from .spec import SearchSpec
from .topk import (
    TopK,
    rerank_positions,
    topk_from_batch,
    topk_init,
    topk_merge,
    topk_threshold,
)

__all__ = [
    "ExecutionPlan",
    "executor_names",
    "plan_search",
    "execute",
    "pow2_bucket",
    "register_executor",
    "UNPORTED_EXECUTORS",
]

#: Reference executors that the port does not have yet -> the ROADMAP.md
#: item (modules queue) that will bring each one.
UNPORTED_EXECUTORS = {
    "jit-masked": "'pdxearch_jit and the jit-masked executor'",
    "cascade-scan": "'Cascade'",
    "cascade-batch": "'Cascade'",
    "tiered-scan": "'Tiered cache'",
    "routed_tiered": "'Multi-device search'",
    "block-sharded": "'Multi-device search'",
    "dim-sharded": "'Multi-device search'",
    "batch-block-sharded": "'Multi-device search'",
    "routed_bucket": "'Multi-device search'",
}


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet (ROADMAP.md, modules "
        f"queue: {item})"
    )


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Plan trace: which executor runs, and why the planner picked it."""

    executor: str
    reason: str
    n_queries: int
    pruner: str = ""            # pruner fingerprint (stable identity)
    mesh_axes: tuple = ()
    store_version: int = 0      # frozen stores: 0


# -------------------------------------------------------------------- registry
# name -> fn(store, pruner, Q (B, D) tensor, spec, *, ivf, stats)
#   -> (ids, dists) NumPy, each (B, k).
_EXECUTORS: dict[str, Callable] = {}

_FUSED = ("fused-scan", "fused-batch")


def register_executor(name: str):
    def deco(fn):
        _EXECUTORS[name] = fn
        return fn
    return deco


def executor_names() -> tuple[str, ...]:
    return tuple(_EXECUTORS)


def pow2_bucket(n: int, cap: Optional[int] = None) -> int:
    """Smallest power of two >= ``n`` (clamped to ``cap`` when given) — the
    batch-shape buckets of the serving tier."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    b = 1
    while b < n:
        b *= 2
    return b if cap is None else min(b, cap)


def _on_cuda(store) -> bool:
    return store.data.device.type == "cuda"


# --------------------------------------------------------------------- planner
def plan_search(
    spec: SearchSpec,
    store: PDXStore,
    n_queries: int,
    *,
    pruner: Optional[Pruner] = None,
    ivf=None,
    mesh=None,
) -> ExecutionPlan:
    """Choose an executor for ``n_queries`` queries against ``store``."""
    if mesh is not None:
        raise _not_ported("searching over a device mesh", "'Multi-device search'")
    if spec.kernel == "cuda" and not _on_cuda(store):
        raise ValueError(
            f"kernel='cuda' needs a store on a CUDA device; this store is on "
            f"{store.data.device} (build with device='cuda', or use "
            f"kernel='auto')"
        )
    fp = pruner.fingerprint if pruner is not None else ""
    version = getattr(store, "version", 0)
    body = "cuda" if _on_cuda(store) else "torch"

    def plan(executor: str, reason: str) -> ExecutionPlan:
        if executor in _FUSED and spec.kernel == "torch" and _on_cuda(store):
            raise ValueError(
                f"kernel='torch' with executor {executor!r} on a CUDA store: "
                "the fused executors run the CUDA kernels on the card "
                "(use kernel='auto' or 'cuda', or scan_dtype='f32' without "
                "forcing a fused executor)"
            )
        if spec.kernel == "cuda" and executor not in _FUSED:
            reason += " (kernel='cuda' noted: this executor runs plain torch)"
        if spec.scan_dtype != "f32" and executor not in _FUSED:
            reason += (
                f" (scan_dtype={spec.scan_dtype!r} ignored: this executor "
                "scans the f32 masters)"
            )
        return ExecutionPlan(
            executor=executor, reason=reason, n_queries=n_queries,
            pruner=fp, store_version=version,
        )

    if spec.executor is not None:
        if spec.executor in UNPORTED_EXECUTORS:
            raise _not_ported(
                f"executor {spec.executor!r}", UNPORTED_EXECUTORS[spec.executor]
            )
        if spec.executor not in _EXECUTORS:
            raise ValueError(
                f"unknown executor {spec.executor!r}; "
                f"registered: {executor_names()}"
            )
        return plan(spec.executor, "forced by spec.executor")
    return _host_plan(spec, n_queries, ivf, store, plan, body)


def _wants_fused(spec: SearchSpec, store) -> bool:
    """A spec opts into the fused mirror-scanning executors by forcing the
    kernels, by a store on CUDA with ``kernel="auto"``, or by requesting a
    reduced-precision scan (which only they honor)."""
    return (
        spec.kernel == "cuda"
        or spec.scan_dtype != "f32"
        or (spec.kernel == "auto" and _on_cuda(store))
    )


def _host_plan(spec, n_queries, ivf, store, plan, body: str) -> ExecutionPlan:
    if spec.hbm_slots is not None and ivf is not None:
        raise _not_ported("tiered serving (hbm_slots)", "'Tiered cache'")
    if spec.cascade is not None:
        raise _not_ported("the cascade executors", "'Cascade'")
    if _wants_fused(spec, store):
        if n_queries == 1 and spec.metric == "l2":
            where = "IVF-routed START, " if ivf is not None else ""
            return plan(
                "fused-scan",
                f"fused whole-store mirror scan ({where}scan_dtype="
                f"{spec.scan_dtype}, kernel={body})",
            )
        extra = "; IVF store scanned exactly, all buckets" if ivf else ""
        return plan(
            "fused-batch",
            f"fused batched mirror scan (scan_dtype={spec.scan_dtype}"
            f", kernel={body}, B={n_queries}){extra}",
        )
    if n_queries > 1 and ivf is None:
        return plan("batch-matmul",
                    f"batch of {n_queries} on one device: exact matmul scan")
    if spec.prefer_static and ivf is None:
        raise _not_ported(
            "prefer_static (the jit-masked executor)",
            UNPORTED_EXECUTORS["jit-masked"],
        )
    where = "IVF-routed" if ivf is not None else "flat"
    return plan("adaptive", f"{where} host-orchestrated PDXearch")


# ------------------------------------------------------------------- execution
def execute(
    plan: ExecutionPlan,
    spec: SearchSpec,
    store: PDXStore,
    pruner: Pruner,
    Q: torch.Tensor,
    *,
    ivf=None,
    mesh=None,
    stats: Optional[SearchStats] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Run ``plan`` for the (B, D) query batch ``Q`` -> (B, k) ids/dists."""
    if mesh is not None:
        raise _not_ported("searching over a device mesh", "'Multi-device search'")
    fn = _EXECUTORS[plan.executor]
    with _trace.span("scan", executor=plan.executor,
                     scan_dtype=spec.scan_dtype):
        return fn(store, pruner, Q, spec, ivf=ivf, stats=stats)


def _numpy(res: TopK) -> tuple[np.ndarray, np.ndarray]:
    return res.ids.cpu().numpy(), res.dists.cpu().numpy()


def _exact_scan_stats(stats: Optional[SearchStats], store, B: int) -> None:
    """Work accounting for the exact full-scan executors: every live value
    is computed, nothing avoided."""
    if stats is None:
        return
    work = float(store.counts.sum()) * store.dim * B
    stats.values_total += work
    stats.values_computed += work
    stats.partitions_visited += store.num_partitions * B


@register_executor("adaptive")
def _exec_adaptive(store, pruner, Q, spec, *, ivf, stats):
    out = []
    for q in Q:
        if ivf is not None:
            with _trace.span("route", nprobe=spec.nprobe):
                qt = pruner.transform_query(q)
                order, start_parts = ivf.route(
                    qt, spec.nprobe, spec.metric, spec.route_dtype
                )
        else:
            order, start_parts = None, 1
        out.append(pdxearch(
            store, q, spec.k, pruner, metric=spec.metric,
            schedule=spec.schedule, delta_d=spec.delta_d,
            sel_frac=spec.sel_frac, group=spec.group,
            pid_order=order, start_parts=start_parts, stats=stats,
        ))
    return _numpy(TopK(dists=torch.stack([r.dists for r in out]),
                       ids=torch.stack([r.ids for r in out])))


def _transform_batch(pruner: Pruner, Q: torch.Tensor) -> torch.Tensor:
    if not pruner.needs_preprocess:
        return Q
    return pruner.transform_batch(Q)


@register_executor("batch-matmul")
def _exec_batch_matmul(store, pruner, Q, spec, *, ivf, stats):
    # Exact scan over ALL partitions (IVF engines included: their store holds
    # every bucket, so this is exact; nprobe does not apply).
    Qt = _transform_batch(pruner, Q)
    res = search_batch_matmul(store.data, store.ids, Qt, spec.k, spec.metric)
    B = Q.shape[0]
    _exact_scan_stats(stats, store, B)
    if _metrics.enabled():
        P, D, C = store.data.shape
        _metrics.counter(
            "repro_device_bytes_total", float(B) * P * D * C * 4,
            executor="batch-matmul", component="scan", dtype="f32",
        )
    return _numpy(res)


# ------------------------------------------------- fused mirror executors
# Candidates are tracked as flat tile POSITIONS (p * C + c), not global ids,
# so the exact f32 re-rank gathers master columns with one fancy index;
# positions map to ids only at the end.
def _rerank_k(spec: SearchSpec, store) -> int:
    if spec.scan_dtype == "f32":
        return spec.k
    cap = store.num_partitions * store.capacity
    return min(spec.rerank_mult * spec.k, cap)


# One batched-kernel launch writes (B, partitions * C) f32 distances; the
# store is scanned in launches of at most this many output bytes.
_FUSED_BATCH_OUT_BYTES = 1 << 30


def _fused_batch_scan(mirror, ids, Qt, rk: int, metric: str) -> TopK:
    """Scan every mirror tile with the batched kernel -> per-query top-``rk``
    flat positions (PAD lanes carry position -1)."""
    from ..kernels.batched_matmul import MAX_PARTITIONS
    from ..kernels.ops import batched_distance_quant_op
    from ..kernels.ref import dequantize_ref

    P, _, C = mirror.data.shape
    B = Qt.shape[0]
    sc = mirror.scale if mirror.quantized else None
    off = mirror.offset if mirror.quantized else None
    pos = torch.arange(P * C, dtype=torch.int32, device=ids.device).reshape(P, C)
    pos = torch.where(ids >= 0, pos, -1)
    state = topk_init(rk, (B,), Qt.device)
    step = max(1, min(MAX_PARTITIONS, _FUSED_BATCH_OUT_BYTES // (B * C * 4)))
    for lo in range(0, P, step):
        tiles = mirror.data[lo:lo + step]
        if metric == "l1":  # no matmul form: dequantize + per-query scan
            t32 = dequantize_ref(tiles, sc, off, dim_axis=1,
                                 packed=mirror.packed, dim=mirror.dim)
            dmat = torch.stack([
                torch.sum(torch.abs(t32 - q[None, :, None]), dim=1).reshape(-1)
                for q in Qt
            ])
        else:
            dmat = batched_distance_quant_op(
                tiles, Qt, sc, off, metric, packed=mirror.packed, dim=mirror.dim,
            )
        state = topk_merge(state, dmat, pos[lo:lo + step].reshape(-1))
    return state


def _positions_to_ids(store_ids, cand: TopK) -> TopK:
    safe = torch.clamp(cand.ids, min=0).long()
    gids = torch.where(cand.ids >= 0, store_ids.reshape(-1)[safe], -1)
    return TopK(dists=cand.dists, ids=gids)


@register_executor("fused-batch")
def _exec_fused_batch(store, pruner, Q, spec, *, ivf, stats):
    """Exact-over-store scan of the device mirror at ``spec.scan_dtype``
    width (IVF engines included — all buckets, like batch-matmul), f32
    re-ranked when the mirror is reduced-precision."""
    mirror = device_mirror(store, spec.scan_dtype)
    Qt = _transform_batch(pruner, Q.to(torch.float32))
    rk = _rerank_k(spec, store)
    cand = _fused_batch_scan(mirror, store.ids, Qt, rk, spec.metric)
    if spec.scan_dtype == "f32":
        res = _positions_to_ids(store.ids, cand)
    else:
        with _trace.span("rerank", rk=rk):
            res = _trace.fence(rerank_positions(
                store.data, store.ids, Qt, cand, spec.k, spec.metric
            ))
    B = Q.shape[0]
    _exact_scan_stats(stats, store, B)
    if _metrics.enabled():
        P, C = mirror.data.shape[0], mirror.data.shape[2]
        D = mirror.dim
        _metrics.counter(
            "repro_device_bytes_total",
            float(B) * P * D * C * mirror.bytes_per_value,
            executor="fused-batch", component="scan", dtype=mirror.dtype,
        )
        if spec.scan_dtype != "f32":
            _metrics.counter(
                "repro_device_bytes_total", float(B) * rk * D * 4,
                executor="fused-batch", component="rerank", dtype="f32",
            )
    return _numpy(res)


@register_executor("fused-scan")
def _exec_fused_scan(store, pruner, Q, spec, *, ivf, stats):
    """Single-query whole-store scan: one K1 launch per query, ADSampling
    keep-mask fused per d-tile, mirror operands dequantized in registers.

    The threshold is seeded by an exact f32 START scan of one partition —
    the IVF-routed nearest bucket's first partition when an index exists,
    partition 0 otherwise.  The START partition is masked OUT of the
    fused scan (its lanes would otherwise enter the pool twice and crowd
    out the k-th distinct neighbour) and its candidates merge exactly,
    unpruned.  Pruners other than ADSampling scan unpruned (thr = inf)."""
    if spec.metric != "l2":
        raise ValueError(
            "fused-scan is L2-only (ADSampling's domain); the planner "
            "routes other metrics to fused-batch"
        )
    mirror = device_mirror(store, spec.scan_dtype)
    rk = _rerank_k(spec, store)
    prune = pruner.name == "adsampling" and pruner.aux is not None
    eps0 = float(pruner.aux["eps0"]) if prune else 2.1
    sc = mirror.scale if mirror.quantized else None
    off = mirror.offset if mirror.quantized else None
    inf = torch.full((), float("inf"), dtype=torch.float32, device=store.device)
    out = []
    for q in Q:
        qt = pruner.transform_query(q.to(torch.float32))
        p0 = 0
        if ivf is not None:
            order, _ = ivf.route(qt, 1, "l2", dtype=spec.route_dtype)
            if len(order):
                p0 = int(order[0])
        start = topk_from_batch(
            pdx_distance(store.data[p0], qt, "l2"), store.ids[p0], spec.k
        )
        thr = topk_threshold(start) if prune else inf
        out.append(_fused_scan_one(
            mirror, store.data, store.ids, p0, qt, thr, sc, off, eps0, rk,
            spec.k, spec.scan_dtype == "f32", start,
        ))
        if stats is not None:
            _fused_scan_stats(stats, store, mirror, p0, qt, thr, eps0)
    if spec.scan_dtype != "f32":
        # the exact re-rank runs inside _fused_scan_one — record it as a
        # zero-width annotation span plus its gather bytes
        with _trace.span("rerank", fused="in-scan", rk=rk):
            pass
        _metrics.counter(
            "repro_device_bytes_total",
            float(len(Q)) * rk * store.dim * 4,
            executor="fused-scan", component="rerank", dtype="f32",
        )
    return _numpy(TopK(dists=torch.stack([r.dists for r in out]),
                       ids=torch.stack([r.ids for r in out])))


def _fused_scan_stats(stats, store, mirror, p0, qt, thr, eps0) -> None:
    """Work accounting for the fused scan: replay the per-d-tile keep-mask
    walk (``obs.meters.fused_tile_counts``) to recover how many lanes each
    tile computed — an explicit second pass over the mirror, paid only when
    stats are requested.  The START partition is masked out of the walk
    and charged at full D, exactly mirroring the executor."""
    from ..obs import meters as _meters

    counts = store.counts.cpu().numpy()
    P, C = mirror.data.shape[0], mirror.data.shape[2]
    D = mirror.dim
    ids_scan = store.ids.clone()
    ids_scan[p0] = -1
    lanes, parts = _meters.fused_tile_counts(
        mirror.data, ids_scan, qt, thr, mirror.scale, mirror.offset,
        eps0=eps0, packed=mirror.packed, dim=mirror.dim,
    )
    w = _meters.tile_widths(D)
    total = float(counts.sum()) * D
    computed = float(counts[p0]) * D + float((lanes * w).sum())
    stats.values_total += total
    stats.values_computed += computed
    stats.values_avoided += total - computed
    stats.partitions_visited += P
    if _metrics.enabled():
        demand = (
            D * C * 4 + float((parts * w).sum()) * C * mirror.bytes_per_value
        )
        _metrics.counter(
            "repro_device_bytes_total", demand,
            executor="fused-scan", component="scan", dtype=mirror.dtype,
        )


def _fused_scan_one(
    mirror, master, ids, p0: int, qt, thr, scale, offset, eps0: float,
    rk: int, k: int, exact: bool, start: TopK,
) -> TopK:
    from ..kernels.ops import pdx_prune_scan_multi_op

    P, _, C = mirror.data.shape
    # the START partition was scanned exactly already: kill its lanes so the
    # fused scan skips it and its ids never enter the pool twice
    ids_scan = ids.clone()
    ids_scan[p0] = -1
    dists, alive = pdx_prune_scan_multi_op(
        mirror.data, ids_scan, qt, thr, scale, offset, eps0=eps0,
        packed=mirror.packed, dim=mirror.dim,
    )
    flat_d = torch.where(alive, dists, float("inf")).reshape(-1)
    cand = topk_from_batch(
        flat_d, torch.arange(P * C, dtype=torch.int32, device=flat_d.device), rk
    )
    # dead lanes carry +inf: only real survivors are selected unless fewer
    # than rk survive, and PAD positions resolve to id -1 below either way
    if exact:
        res = _positions_to_ids(ids_scan, cand)
    else:
        res = rerank_positions(
            master, ids_scan, qt[None],
            TopK(cand.dists[None], cand.ids[None]), k, "l2",
        )
        res = TopK(dists=res.dists[0], ids=res.ids[0])
    return topk_merge(res, start.dists, start.ids)
