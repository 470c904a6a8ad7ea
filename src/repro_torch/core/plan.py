"""Query planner + executor registry — *how* a ``SearchSpec`` executes.

Counterpart of ``repro.core.plan`` for one device.  ``plan_search`` maps
(spec, store, query count) onto a registered executor; ``execute`` runs
it.  All executors answer the same question — top-k under the spec's
metric/pruner config — and differ only in execution strategy:

  adaptive      host-orchestrated PDXearch (paper Section 4); the only
                executor with per-query IVF routing.
  jit-masked    shape-static masked PDXearch (flat stores only).
  batch-matmul  exact matmul scan of a (B, D) query batch.
  fused-scan    one launch of the whole-store fused scan (K1) with the
                ADSampling test fused per d-tile, over the store's device
                mirror at ``spec.scan_dtype`` width, seeded by an exact
                START scan of one partition (the IVF-routed nearest
                bucket's first partition when an index exists).
  fused-batch   one launch of the batched distance kernel (K2) over every
                mirror tile — the batched counterpart of fused-scan.
  cascade-scan  the multi-resolution cascade (``spec.cascade``), one query
                at a time: a projection or full-dimension first stage (K1),
                later stages over the survivors only (K3), then an exact
                f32 re-rank of every survivor.
  cascade-batch the same cascade once per batch: each stage gathers the
                union of the batch's survivors and runs its d-tile ladder
                through K2; ids and distances equal cascade-scan's bitwise.

The fused executors re-rank the top ``rerank_mult * k`` candidates
against the f32 master tiles whenever ``scan_dtype != "f32"``, so returned
distances stay exact.  Their kernels run on CUDA tensors; on CPU tensors
the same ops run the kernels' plain PyTorch versions (``kernels.ops``
dispatches by device).

Planner rules, in order: a forced ``spec.executor`` wins; otherwise a spec
with a ``cascade`` picks cascade-batch for batches and cascade-scan for
single queries; otherwise a fused-eligible spec (``kernel="cuda"``, a
store on CUDA with ``kernel="auto"``, or any reduced-precision
``scan_dtype``) picks a fused executor — single L2 queries the scan,
batches (and other metrics) the batched kernel; otherwise batches take the
matmul scan and single queries the adaptive path (or, with
``spec.prefer_static`` on a flat store, the masked one).  ``kernel="cuda"``
on a CPU store raises, and so does ``kernel="torch"`` when a fused or
cascade executor would run on a CUDA store: the knob steers planning, the
tensors' device picks the body.

Mutable stores (``core.layout.MutablePDXStore``) flow through the same
planner: the plan trace records ``store.version``, and ``execute`` merges
the store's unflushed write-head rows *exactly* (never pruned) into every
executor's top-k, inside a ``merge`` span.

Not ported yet, and refused with ``NotImplementedError`` naming the
ROADMAP item: tiered serving (``hbm_slots``) and the mesh-sharded
executors.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import trace as _trace
from .distance import pdx_distance
from .layout import PDXStore, device_mirror, projection_mirror
from .pdxearch import SearchStats, pdxearch, pdxearch_jit, search_batch_matmul
from .pruners import Pruner
from .spec import SearchSpec, parse_cascade_stage
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
    store_version: int = 0      # MutablePDXStore.version (frozen stores: 0)


# -------------------------------------------------------------------- registry
# name -> fn(store, pruner, Q (B, D) tensor, spec, *, ivf, stats)
#   -> (ids, dists) NumPy, each (B, k).
_EXECUTORS: dict[str, Callable] = {}

_FUSED = ("fused-scan", "fused-batch")
_CASCADE = ("cascade-scan", "cascade-batch")
# executors that run the hand-written kernels on a CUDA store and scan the
# reduced-precision device mirrors
_KERNEL_EXECUTORS = _FUSED + _CASCADE


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
    return store.device.type == "cuda"


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
            f"{store.device} (build with device='cuda', or use "
            f"kernel='auto')"
        )
    fp = pruner.fingerprint if pruner is not None else ""
    version = getattr(store, "version", 0)
    body = "cuda" if _on_cuda(store) else "torch"

    def plan(executor: str, reason: str) -> ExecutionPlan:
        if (executor in _KERNEL_EXECUTORS and spec.kernel == "torch"
                and _on_cuda(store)):
            raise ValueError(
                f"kernel='torch' with executor {executor!r} on a CUDA store: "
                "the fused and cascade executors run the CUDA kernels on the "
                "card (use kernel='auto' or 'cuda', or neither a cascade nor "
                "a reduced scan_dtype nor a forced fused executor)"
            )
        if spec.kernel == "cuda" and executor not in _KERNEL_EXECUTORS:
            reason += " (kernel='cuda' noted: this executor runs plain torch)"
        if spec.scan_dtype != "f32" and executor not in _KERNEL_EXECUTORS:
            reason += (
                f" (scan_dtype={spec.scan_dtype!r} ignored: this executor "
                "scans the f32 masters)"
            )
        if spec.cascade is not None and executor not in _CASCADE:
            reason += (
                " (cascade ignored: only the cascade executors run stage "
                "pipelines)"
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
        where = "IVF-routed START, " if ivf is not None else ""
        stages = "→".join(spec.cascade)
        if n_queries > 1:
            return plan(
                "cascade-batch",
                f"multi-resolution cascade {stages} batched through the "
                f"batched distance kernel ({where}kernel={body}, B={n_queries})",
            )
        return plan(
            "cascade-scan",
            f"multi-resolution cascade {stages} ({where}kernel={body}, "
            f"B={n_queries})",
        )
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
        return plan("jit-masked", "prefer_static: shape-static masked PDXearch")
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
    """Run ``plan`` for the (B, D) query batch ``Q`` -> (B, k) ids/dists.

    For mutable stores this is also the write-head merge point: whatever
    executor ran over the sealed tiles, the unflushed write-head rows are
    scanned exactly (never pruned — they carry no pruner metadata yet) and
    merged into every query's top-k."""
    if mesh is not None:
        raise _not_ported("searching over a device mesh", "'Multi-device search'")
    fn = _EXECUTORS[plan.executor]
    with _trace.span("scan", executor=plan.executor,
                     scan_dtype=spec.scan_dtype):
        ids, dists = fn(store, pruner, Q, spec, ivf=ivf, stats=stats)
    with _trace.span("merge", executor=plan.executor):
        return _merge_write_head(store, pruner, Q, spec, ids, dists,
                                 stats=stats)


# _head_distances broadcasts at most this many values at a time
_HEAD_CHUNK_VALUES = 1 << 26


def _head_distances(H: torch.Tensor, Qt: torch.Tensor, metric: str) -> torch.Tensor:
    """(H_cap, D) full head buffer x (B, D) queries -> (B, H_cap) distances:
    ``nary_distance``'s arithmetic for every query at once, a reduction
    along each row, over chunks of queries."""
    step = max(1, _HEAD_CHUNK_VALUES // H.numel())
    return torch.cat([_head_block(H, Qt[lo:lo + step], metric)
                      for lo in range(0, Qt.shape[0], step)])


def _head_block(H, Qb, metric: str) -> torch.Tensor:
    if metric == "l2":
        diff = H[None] - Qb[:, None, :]
        return torch.sum(diff * diff, dim=2)
    if metric == "l1":
        return torch.sum(torch.abs(H[None] - Qb[:, None, :]), dim=2)
    return -torch.sum(H[None] * Qb[:, None, :], dim=2)


def _merge_write_head(
    store, pruner: Pruner, Q: torch.Tensor, spec: SearchSpec,
    ids: np.ndarray, dists: np.ndarray,
    stats: Optional[SearchStats] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Merge the store's live write-head rows into the (B, k) top-k — exact,
    unpruned, in the pruner-transformed space the sealed tiles live in.

    The distances are taken over the FULL head buffer on the store's device
    (dead rows masked to +inf on the host), and the merge is a stable sort
    over ``[sealed top-k | head]`` in that order, so ties keep the
    reference's order."""
    head_snapshot = getattr(store, "head_snapshot", None)
    if head_snapshot is None:
        return ids, dists
    hids, hvecs = head_snapshot()                    # full (H,), (H, D)
    live = hids >= 0
    m = int(live.sum())
    if m == 0:
        return ids, dists
    Qt = _transform_batch(pruner, Q)                             # (B, D)
    H = torch.from_numpy(hvecs).to(Qt.device)
    hd = _head_distances(H, Qt, spec.metric).cpu().numpy()       # (B, H)
    hd = np.where(live[None, :], hd, np.inf)
    if stats is not None:  # the LIVE head rows are scanned in full, unpruned
        work = float(len(Q) * m * hvecs.shape[1])
        stats.values_total += work
        stats.values_computed += work
    all_d = np.concatenate([dists.astype(np.float32), hd.astype(np.float32)],
                           axis=1)
    all_i = np.concatenate(
        [ids, np.broadcast_to(hids.astype(ids.dtype), hd.shape)], axis=1
    )
    order = np.argsort(all_d, axis=1, kind="stable")[:, : spec.k]
    return (
        np.take_along_axis(all_i, order, axis=1),
        np.take_along_axis(all_d, order, axis=1),
    )


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


@register_executor("jit-masked")
def _exec_jit_masked(store, pruner, Q, spec, *, ivf, stats):
    if ivf is not None:
        raise ValueError(
            "jit-masked executor has no IVF routing (bucket ranking is "
            "data-dependent); use the adaptive executor"
        )
    out = [
        pdxearch_jit(
            store, q, spec.k, pruner, metric=spec.metric,
            schedule=spec.schedule, delta_d=spec.delta_d, stats=stats,
        )
        for q in Q
    ]
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
        qt, p0, start = _start(store, pruner, q, spec, ivf)
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

    # the START partition was scanned exactly already: kill its lanes so the
    # fused scan skips it and its ids never enter the pool twice
    ids_scan = ids.clone()
    ids_scan[p0] = -1
    dists, alive = pdx_prune_scan_multi_op(
        mirror.data, ids_scan, qt, thr, scale, offset, eps0=eps0,
        packed=mirror.packed, dim=mirror.dim,
    )
    return _finish(master, ids_scan, qt, dists, alive, rk, k, start, exact)


def _finish(master, ids_scan, qt, dists, alive, rk: int, k: int, start: TopK,
            exact: bool = False) -> TopK:
    """Top-``rk`` surviving flat positions by their scan distance, re-scored
    against the f32 masters unless the scan was ``exact``, merged with the
    exact START candidates."""
    flat_d = torch.where(alive, dists, float("inf")).reshape(-1)
    cand = topk_from_batch(
        flat_d, torch.arange(flat_d.shape[0], dtype=torch.int32,
                             device=flat_d.device), rk
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


# ------------------------------------------------------- cascade executors
def _quant_err_norm(mirror) -> float:
    """L2 norm bound of a quantized mirror's reconstruction error vector.

    Per-dimension rounding error is at most ``scale_d / 2`` (the observed-
    range affine never clips), so ``||x_hat - x|| <= 0.5 * ||scale||`` for
    every live vector, and by the triangle inequality a vector within
    ``thr`` of the query lies within ``(sqrt(thr) + err)^2`` in dequantized
    space: the exact-safe threshold inflation of the quantized stages.  A
    NumPy norm as a Python float, as the reference computes it."""
    if not mirror.quantized:
        return 0.0
    return 0.5 * float(np.linalg.norm(mirror.scale.cpu().numpy()))


def _cascade_mirrors(spec: SearchSpec, store) -> tuple[list, list]:
    """The scan stages of ``spec.cascade`` (all but the exact f32 re-rank)
    and their mirrors."""
    stages = [parse_cascade_stage(s) for s in spec.cascade][:-1]
    mirrors = [
        projection_mirror(store, rank, dt) if kind == "proj"
        else device_mirror(store, dt)
        for kind, dt, rank in stages
    ]
    return stages, mirrors


def _inflate(thr: torch.Tensor, qerr: float) -> torch.Tensor:
    """``(sqrt(thr) + qerr)**2`` in f32, squared as a product (the
    reference's integer power)."""
    t = torch.sqrt(thr) + float(np.float32(qerr))
    return t * t


def _stage_args(kind: str, rank: int, mirror, qs, thr_q, prune: bool,
                eps0: float):
    """(stage queries, threshold, eps0, d_tile) of one stage.  A projection
    stage tests once, at d = rank, with eps 0: the orthonormal projection's
    L2 lower-bounds the full L2 exactly, and scaled intermediate tests are
    unsafe on PCA coordinates.  Full-dimension stages run the ADSampling
    test when the engine prunes with ADSampling, and scan unpruned
    otherwise."""
    if kind == "proj":
        return qs @ mirror.components, thr_q, 0.0, rank
    return qs, (thr_q if prune else torch.full_like(thr_q, float("inf"))), eps0, 64


def _start(store, pruner, q, spec, ivf):
    """Transformed query, START partition and its exact top-k: the IVF-
    routed nearest bucket's first partition, partition 0 without an index."""
    qt = pruner.transform_query(q.to(torch.float32))
    p0 = 0
    if ivf is not None:
        order, _ = ivf.route(qt, 1, "l2", dtype=spec.route_dtype)
        if len(order):
            p0 = int(order[0])
    start = topk_from_batch(
        pdx_distance(store.data[p0], qt, "l2"), store.ids[p0], spec.k
    )
    return qt, p0, start


def _widen_rk(rk: int, n_alive: int, cap: int) -> int:
    """The survivors of the exact-safe last keep test are exactly the lanes
    that may still enter the top-k, so the re-rank covers them all: ``rk``
    widens to a power of two at or above the survivor count."""
    if n_alive > rk:
        return min(1 << (n_alive - 1).bit_length(), cap)
    return rk


def _cascade_setup(spec, store, pruner, name: str):
    if spec.metric != "l2":
        raise ValueError(f"{name} is L2-only (spec validation enforces this)")
    if spec.cascade is None:
        raise ValueError(f"{name} executor needs spec.cascade")
    stages, mirrors = _cascade_mirrors(spec, store)
    prune = pruner.name == "adsampling" and pruner.aux is not None
    eps0 = float(pruner.aux["eps0"]) if prune else 2.1
    return stages, mirrors, prune, eps0, [_quant_err_norm(m) for m in mirrors]


def _stage_meters(spec, si: int, executor: str, mirror, n_surv: float,
                  stage_bytes: float, partition_model: Optional[float]) -> None:
    _metrics.counter("repro_cascade_stage_survivors", n_surv,
                     stage=str(si), stage_name=spec.cascade[si])
    _metrics.counter("repro_cascade_stage_bytes", stage_bytes,
                     stage=str(si), stage_name=spec.cascade[si])
    if partition_model is not None:
        # what partition-granular skip would have streamed (an entering
        # partition fetches its full stage mirror); the realized counter
        # undercuts it by exactly the mid-scan d-tile savings
        _metrics.counter("repro_cascade_stage_bytes_partition_model",
                         partition_model, stage=str(si),
                         stage_name=spec.cascade[si])
    _metrics.counter("repro_device_bytes_total", stage_bytes,
                     executor=executor, component="scan", dtype=mirror.dtype)


def _finish_meters(executor: str, D: int, C: int, rk_eff: int) -> None:
    _metrics.counter("repro_device_bytes_total", float(D * C * 4),
                     executor=executor, component="start", dtype="f32")
    _metrics.counter("repro_device_bytes_total", float(rk_eff * D * 4),
                     executor=executor, component="rerank", dtype="f32")


def _cascade_stage(mdata, ids_scan, alive_prev, qs, thr, scale, offset,
                   eps0: float, d_tile: int, packed: bool, dim: int, first: bool):
    """One cascade scan stage over the (P, D_i, C) stage mirror ->
    ``(dists, alive, streamed)``.  The first stage streams every partition
    through K1 (streamed = all tiles); later stages carry the previous
    stage's survivors in by forcing dead lanes' ids to -1 and run K3, where
    an entry-dead partition fetches nothing and a partition stops fetching
    at the d-tile where its last lane dies."""
    from ..kernels.ops import (
        pdx_prune_scan_multi_op,
        pdx_prune_scan_multi_prefetch_op,
    )

    if first:
        logical = dim if packed else mdata.shape[1]
        nd = -(-logical // min(d_tile, logical))
        dists, alive = pdx_prune_scan_multi_op(
            mdata, ids_scan, qs, thr, scale, offset, eps0=eps0,
            d_tile=d_tile, packed=packed, dim=dim,
        )
        return dists, alive, torch.full((mdata.shape[0],), float(nd),
                                        device=mdata.device)
    ids_i = torch.where(alive_prev, ids_scan, -1)
    return pdx_prune_scan_multi_prefetch_op(
        mdata, ids_i, qs, thr, scale, offset, eps0=eps0, d_tile=d_tile,
        packed=packed, dim=dim,
    )


@register_executor("cascade-scan")
def _exec_cascade_scan(store, pruner, Q, spec, *, ivf, stats):
    """Multi-resolution cascade, one query at a time: each scan stage of
    ``spec.cascade`` scans its mirror over the previous stage's survivors
    with the exact-safe inflated threshold, and the exact f32 re-rank
    covers every final survivor.  The threshold comes from an exact f32
    START scan (see ``_start``), whose partition is masked out of every
    stage and merged exactly."""
    stages, mirrors, prune, eps0, qerrs = _cascade_setup(
        spec, store, pruner, "cascade-scan")
    P, C, D = store.num_partitions, store.capacity, store.dim
    rk = min(spec.rerank_mult * spec.k, P * C)
    counts = store.counts.cpu().numpy()
    meter = stats is not None or _metrics.enabled()
    out = []
    for q in Q:
        qt, p0, start = _start(store, pruner, q, spec, ivf)
        thr = topk_threshold(start)
        ids_scan = store.ids.clone()
        ids_scan[p0] = -1
        dists = alive = None
        lanes_in = float(counts.sum() - counts[p0])
        computed = float(counts[p0]) * D  # START (re-rank added below)
        for si, ((kind, _, rank), mirror) in enumerate(zip(stages, mirrors)):
            qs, thr_i, eps_i, d_tile = _stage_args(
                kind, rank, mirror, qt, _inflate(thr, qerrs[si]), prune, eps0)
            dists, alive, streamed = _cascade_stage(
                mirror.data, ids_scan, alive, qs, thr_i,
                mirror.scale if mirror.quantized else None,
                mirror.offset if mirror.quantized else None,
                eps_i, d_tile, mirror.packed, mirror.dim, si == 0,
            )
            if meter:
                n_surv = float(alive.sum())
                # realized traffic at d-tile granularity
                streamed = streamed.cpu().numpy().astype(np.float64)
                dims_f = np.minimum(streamed * d_tile, float(mirror.dim))
                stage_bytes = float(dims_f.sum()) * C * mirror.bytes_per_value
                if stats is not None:
                    computed += lanes_in * mirror.dim
                if _metrics.enabled():
                    _stage_meters(
                        spec, si, "cascade-scan", mirror, n_surv, stage_bytes,
                        float((streamed > 0).sum()) * mirror.dim * C
                        * mirror.bytes_per_value,
                    )
                lanes_in = n_surv
        rk_eff = _widen_rk(rk, int(alive.sum()), P * C)
        computed += float(rk_eff) * D
        with _trace.span("rerank", rk=rk_eff):
            out.append(_trace.fence(_finish(
                store.data, ids_scan, qt, dists, alive, rk_eff, spec.k, start)))
        if stats is not None:
            total = float(counts.sum()) * D
            stats.values_total += total
            stats.values_computed += computed
            stats.values_avoided += max(total - computed, 0.0)
            stats.partitions_visited += P
        if _metrics.enabled():
            _finish_meters("cascade-scan", D, C, rk_eff)
    return _numpy(TopK(dists=torch.stack([r.dists for r in out]),
                       ids=torch.stack([r.ids for r in out])))


def _cascade_batch_stage(mdata, idx: np.ndarray, alive, Qs, thr, scale, offset,
                         eps0: float, d_tile: int, packed: bool, dim: int):
    """One batched cascade stage: gather the union-survivor columns of the
    (P, D_i, C) stage mirror into a compacted (D_i, S) tile, run the d-tile
    ladder over the whole batch, scatter dists/alive back to flat (B, P*C)
    slot order (slot = p*C + c).  ``idx`` is the pow2-padded union list;
    pad entries carry P*C and land in a throwaway column.  The columns are
    gathered by ``(p, c) = divmod(slot, C)`` through a permuted view, so the
    mirror itself is never copied."""
    from ..kernels.ops import batched_cascade_stage_op

    P, _, C = mdata.shape
    PC = P * C
    B = alive.shape[0]
    idx_t = torch.from_numpy(idx).to(mdata.device).long()
    safe = torch.clamp(idx_t, max=PC - 1)
    Tc = mdata.permute(1, 0, 2)[:, safe // C, safe % C]      # (D_i, S)
    alive_ext = torch.cat(
        [alive, torch.zeros((B, 1), dtype=alive.dtype, device=alive.device)], dim=1)
    d_c, a_c = batched_cascade_stage_op(
        Tc, alive_ext[:, idx_t], Qs, thr, scale, offset, eps0=eps0,
        d_tile=d_tile, packed=packed, dim=dim,
    )
    d_full = torch.zeros((B, PC + 1), dtype=torch.float32, device=mdata.device)
    a_full = torch.zeros((B, PC + 1), dtype=torch.bool, device=mdata.device)
    d_full[:, idx_t] = d_c
    a_full[:, idx_t] = a_c
    return d_full[:, :PC], a_full[:, :PC]


@register_executor("cascade-batch")
def _exec_cascade_batch(store, pruner, Q, spec, *, ivf, stats):
    """The cascade once per batch: each scan stage runs over the whole
    query batch, carrying a shared (B, P*C) survivor bitmap between
    stages.  Per stage the union of the batch's survivors is compacted to a
    pow2-bucketed column set, gathered once, and scanned d-tile by d-tile
    through the batched distance kernel with per-query thresholds, so a
    stage's bytes are paid per batch, not per query.  START and the exact
    re-rank stay per query with cascade-scan's arithmetic; the final top-k
    depends only on the survivor bitmap and the exact re-rank, which covers
    every survivor, so ids and distances equal cascade-scan's bitwise."""
    stages, mirrors, prune, eps0, qerrs = _cascade_setup(
        spec, store, pruner, "cascade-batch")
    P, C, D = store.num_partitions, store.capacity, store.dim
    PC = P * C
    B = Q.shape[0]
    rk = min(spec.rerank_mult * spec.k, PC)
    counts = store.counts.cpu().numpy()
    meter = stats is not None or _metrics.enabled()
    qts, p0s, starts = zip(*(_start(store, pruner, q, spec, ivf) for q in Q))
    Qt = torch.stack(qts)                                    # (B, D)
    thr = torch.stack([topk_threshold(s) for s in starts])   # (B,)
    p0_arr = np.asarray(p0s, np.int64)
    slot_part = torch.arange(PC, device=store.device) // C
    alive = (store.ids.reshape(-1)[None, :] >= 0) & (
        slot_part[None, :] != torch.from_numpy(p0_arr).to(store.device)[:, None]
    )                                                        # (B, P*C)
    lanes_in = (counts.sum() - counts[p0_arr]).astype(np.float64)
    computed = counts[p0_arr].astype(np.float64) * D
    dists = None
    for si, ((kind, _, rank), mirror) in enumerate(zip(stages, mirrors)):
        Qs, thr_i, eps_i, d_tile = _stage_args(
            kind, rank, mirror, Qt, _inflate(thr, qerrs[si]), prune, eps0)
        # host-synced union count -> pow2-bucketed compacted width
        union = torch.any(alive, dim=0).cpu().numpy()
        nz = np.flatnonzero(union)
        S = pow2_bucket(max(nz.size, 1), PC)
        idx = np.full((S,), PC, np.int32)
        idx[: nz.size] = nz
        dists, alive = _cascade_batch_stage(
            mirror.data, idx, alive, Qs, thr_i,
            mirror.scale if mirror.quantized else None,
            mirror.offset if mirror.quantized else None,
            eps_i, d_tile, mirror.packed, mirror.dim,
        )
        if meter:
            surv_b = torch.sum(alive, dim=1).cpu().numpy().astype(np.float64)
            # the compacted union columns are gathered once for the batch
            stage_bytes = float(S) * mirror.dim * mirror.bytes_per_value
            if stats is not None:
                computed += lanes_in * mirror.dim
            if _metrics.enabled():
                _stage_meters(spec, si, "cascade-batch", mirror,
                              float(surv_b.sum()), stage_bytes, None)
            lanes_in = surv_b
    n_alive_b = torch.sum(alive, dim=1).cpu().numpy()
    rk_effs = [_widen_rk(rk, int(n), PC) for n in n_alive_b]
    out = []
    with _trace.span("rerank", rk=max(rk_effs)):
        for b in range(B):
            ids_scan = store.ids.clone()
            ids_scan[p0s[b]] = -1
            out.append(_finish(store.data, ids_scan, qts[b], dists[b], alive[b],
                               rk_effs[b], spec.k, starts[b]))
        _trace.fence(out)
    for b, rk_eff in enumerate(rk_effs):
        computed[b] += float(rk_eff) * D
        if _metrics.enabled():
            _finish_meters("cascade-batch", D, C, rk_eff)
    if stats is not None:
        total = float(counts.sum()) * D
        stats.values_total += total * B
        stats.values_computed += float(computed.sum())
        stats.values_avoided += max(total * B - float(computed.sum()), 0.0)
        stats.partitions_visited += P * B
    return _numpy(TopK(dists=torch.stack([r.dists for r in out]),
                       ids=torch.stack([r.ids for r in out])))
