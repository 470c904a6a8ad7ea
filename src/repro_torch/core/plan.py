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
  tiered-scan   serving beyond device memory (``spec.hbm_slots`` on an IVF
                engine): route the batch, admit its buckets into a pool of
                device tile slots (``core.layout.BucketCache``), scan the
                pool with K2, each query masked to its routed buckets, and
                re-rank exactly against the host masters.
  block-sharded        PDX partitions sharded over the mesh "data" axis;
                       per-query shard-local masked PDXearch + top-k
                       all-gathers (``repro_torch.dist.pdx_sharded``).
  dim-sharded          dimension slabs sharded over the mesh "model" axis;
                       a psum completes the distances.
  batch-block-sharded  the batch scan on each "data" shard (K2 over the
                       shard's mirror slice at a reduced ``scan_dtype``),
                       then ONE packed top-k all-gather per batch.
  routed_bucket        IVF buckets owned by "data" shards: one all-to-all
                       sends each query to the shards that own its routed
                       buckets, each shard scans only those (K2 over its
                       mirror slice at a reduced ``scan_dtype``, then an
                       exact f32 re-rank), ONE packed all-gather merges
                       (``repro_torch.dist.routing``).
  routed_tiered        tiered-scan with the slot pool split into one
                       region per "data" shard: each shard scans its
                       region with K2, ONE packed all-gather per step
                       merges, and the exact re-rank stays on the host.

The fused executors re-rank the top ``rerank_mult * k`` candidates
against the f32 master tiles whenever ``scan_dtype != "f32"``, so returned
distances stay exact.  Their kernels run on CUDA tensors; on CPU tensors
the same ops run the kernels' plain PyTorch versions (``kernels.ops``
dispatches by device).

Planner rules, in order: a forced ``spec.executor`` wins; then, with a
mesh (a ``torch.distributed`` ``DeviceMesh``, ``repro_torch.dist``), the
reference's mesh rules: an IVF index on a "data" mesh routes by bucket
ownership (routed_tiered with ``hbm_slots``, routed_bucket otherwise)
unless ``spec.routing="broadcast"``; a
"data" axis picks batch-block-sharded for batches (with
``spec.batch_collectives``) and block-sharded otherwise, padding the
partitions when a mutable store leaves them indivisible; a "model" axis
picks dim-sharded; a mesh the rules cannot use is ignored with a note.
Without a mesh (or with one ignored): ``hbm_slots`` on an IVF engine
picks tiered-scan; otherwise a spec with a ``cascade`` picks
cascade-batch for batches and cascade-scan for single queries; otherwise a fused-eligible spec (``kernel="cuda"``, a
store on CUDA with ``kernel="auto"``, or any reduced-precision
``scan_dtype``) picks a fused executor — single L2 queries the scan,
batches (and other metrics) the batched kernel; otherwise batches take the
matmul scan and single queries the adaptive path (or, with
``spec.prefer_static`` on a flat store, the masked one).  ``kernel="cuda"``
on a CPU store raises, and so does ``kernel="torch"`` when a fused,
cascade, tiered (routed_tiered too) or quantized batch-block-sharded or
routed_bucket executor would run on a CUDA store: the knob steers
planning, the tensors' device picks the body.

Mutable stores (``core.layout.MutablePDXStore``) flow through the same
planner: the plan trace records ``store.version``, and ``execute`` merges
the store's unflushed write-head rows *exactly* (never pruned) into every
executor's top-k, inside a ``merge`` span.

``prepare_execute`` splits ``execute`` into a host half (now) and a
device half (``PreparedSearch.run()``) for the serving tier's double
buffer (``repro_torch.serve.vector``): for ``tiered-scan`` and
``routed_tiered`` the host half routes, plans the chunks and issues the
first pass's uploads; for ``routed_bucket`` it routes, plans the exchange
and packs the send buffer, and ``run()`` fires the collectives; every
other executor defers the whole of ``execute`` into ``run()``.  ``warm_shapes``
pushes one synthetic batch per batch-shape bucket through it, so a warm
serving loop builds no state (``obs.setups`` counts what a first search
builds).

The mesh executors follow the SPMD contract of ``repro_torch.dist``:
every rank plans and executes the same search and gets the same result.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import setups as _setups
from ..obs import trace as _trace
from .distance import pdx_distance
from .layout import (
    BucketCache,
    MutablePDXStore,
    PDXStore,
    _host_masters,
    device_mirror,
    projection_mirror,
)
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
    "PreparedSearch",
    "prepare_execute",
    "warm_shapes",
    "pow2_bucket",
    "register_executor",
]


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
# name -> fn(store, pruner, Q (B, D) tensor, spec, *, ivf, mesh, stats)
#   -> (ids, dists) NumPy, each (B, k).
_EXECUTORS: dict[str, Callable] = {}

_FUSED = ("fused-scan", "fused-batch")
_CASCADE = ("cascade-scan", "cascade-batch")
_TIERED = ("tiered-scan", "routed_tiered")
# executors that run the hand-written kernels on a CUDA store and scan
# reduced-precision device tiles (the mirrors, or the tiered slot pool)
_KERNEL_EXECUTORS = _FUSED + _CASCADE + _TIERED
# ... and those that run them only at a reduced ``scan_dtype``
_QUANT_KERNEL_EXECUTORS = ("batch-block-sharded", "routed_bucket")
# executors that honour a reduced ``scan_dtype``
_MIRROR_EXECUTORS = _KERNEL_EXECUTORS + _QUANT_KERNEL_EXECUTORS


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


def _runs_kernels(executor: str, spec: SearchSpec) -> bool:
    """Does ``executor`` launch the hand-written kernels on a CUDA store?"""
    return executor in _KERNEL_EXECUTORS or (
        executor in _QUANT_KERNEL_EXECUTORS and spec.scan_dtype != "f32")


def _mesh_layout(mesh, store) -> tuple[tuple, dict]:
    """(axis names, {axis: size}) of a mesh the store can be searched on:
    a ``DeviceMesh`` over an initialised process group whose device type is
    the store's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from ..dist import mesh_shape

    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed DeviceMesh "
            f"(repro_torch.dist.make_mesh), got {type(mesh).__name__}"
        )
    if not dist.is_initialized():
        raise RuntimeError(
            "searching on a mesh needs an initialised default process group "
            "on every rank (torch.distributed.init_process_group)"
        )
    if mesh.device_type != store.device.type:
        raise ValueError(
            f"the mesh is a {mesh.device_type!r} mesh but the store is on "
            f"{store.device}; build both on one device type"
        )
    return tuple(mesh.mesh_dim_names), mesh_shape(mesh)


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
    axes, shape = _mesh_layout(mesh, store) if mesh is not None else ((), {})
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
        if (_runs_kernels(executor, spec) and spec.kernel == "torch"
                and _on_cuda(store)):
            raise ValueError(
                f"kernel='torch' with executor {executor!r} on a CUDA store: "
                "the fused, cascade, tiered and quantized mesh executors "
                "run the CUDA kernels on the card (use kernel='auto' or "
                "'cuda', or neither hbm_slots nor a cascade nor a reduced "
                "scan_dtype nor a forced fused executor)"
            )
        if spec.kernel == "cuda" and not _runs_kernels(executor, spec):
            reason += " (kernel='cuda' noted: this executor runs plain torch)"
        if spec.scan_dtype != "f32" and executor not in _MIRROR_EXECUTORS:
            reason += (
                f" (scan_dtype={spec.scan_dtype!r} ignored: this executor "
                "scans the f32 masters)"
            )
        if spec.hbm_slots is not None and executor not in _TIERED:
            reason += (
                " (hbm_slots ignored: tiered serving needs an IVF index "
                "and this executor scans a fully-resident store/mirror)"
            )
        if spec.cascade is not None and executor not in _CASCADE:
            reason += (
                " (cascade ignored: only the cascade executors run stage "
                "pipelines)"
            )
        return ExecutionPlan(
            executor=executor, reason=reason, n_queries=n_queries,
            pruner=fp, mesh_axes=axes, store_version=version,
        )

    if spec.executor is not None:
        if spec.executor not in _EXECUTORS:
            raise ValueError(
                f"unknown executor {spec.executor!r}; "
                f"registered: {executor_names()}"
            )
        return plan(spec.executor, "forced by spec.executor")

    if mesh is not None:
        return _mesh_plan(spec, store, n_queries, ivf, axes, shape, plan, body)
    return _host_plan(spec, n_queries, ivf, store, plan, body)


def _mesh_plan(spec, store, n_queries, ivf, axes, shape, plan,
               body: str) -> ExecutionPlan:
    """The reference's mesh rules (``repro.core.plan.plan_search``)."""
    if ivf is not None:
        if "data" in axes and spec.routing == "bucket":
            n_sh = shape["data"]
            if spec.hbm_slots is not None:
                return plan(
                    "routed_tiered",
                    f"mesh 'data' axis ({n_sh} shards) + IVF + "
                    f"hbm_slots={spec.hbm_slots}: region-split bucket "
                    f"cache, shard-local pool scan + one packed top-k "
                    f"all-gather, exact host-RAM re-rank "
                    f"(nprobe={spec.nprobe})",
                )
            return plan(
                "routed_bucket",
                f"mesh 'data' axis ({n_sh} shards) + IVF: bucket-owned "
                f"placement, all-to-all query routing + hierarchical "
                f"top-k merge (nprobe={spec.nprobe})",
            )
        note = (
            "mesh ignored: spec.routing='broadcast' keeps IVF bucket "
            "routing host-side; "
            if "data" in axes
            else f"mesh ignored: IVF bucket routing needs a 'data' axis, "
                 f"mesh has {axes}; "
        )
        return _host_plan(spec, n_queries, ivf, store, plan, body, note=note)
    if "data" in axes:
        n_sh = shape["data"]
        divisible = store.num_partitions % n_sh == 0
        # a mutable store's partition count drifts with churn; the block
        # executors pad it with empty tiles, so it stays on the mesh
        if divisible or isinstance(store, MutablePDXStore):
            pad_note = (
                "" if divisible
                else f" (P={store.num_partitions} padded to divisibility)"
            )
            if n_queries > 1 and spec.batch_collectives:
                return plan(
                    "batch-block-sharded",
                    f"mesh 'data' axis ({n_sh} shards), batch of "
                    f"{n_queries}: one top-k all-gather per batch" + pad_note,
                )
            return plan(
                "block-sharded",
                f"mesh 'data' axis ({n_sh} shards): per-query "
                "shard-local PDXearch + top-k all-gather" + pad_note,
            )
        return _host_plan(
            spec, n_queries, ivf, store, plan, body,
            note=f"mesh ignored: {store.num_partitions} partitions not "
                 f"divisible over {n_sh} 'data' shards; ",
        )
    if "model" in axes:
        n_sh = shape["model"]
        if store.dim % n_sh == 0:
            return plan(
                "dim-sharded",
                f"mesh 'model' axis ({n_sh} shards): dimension-slab "
                "partial distances + psum",
            )
        return _host_plan(
            spec, n_queries, ivf, store, plan, body,
            note=f"mesh ignored: D={store.dim} not divisible over "
                 f"{n_sh} 'model' shards; ",
        )
    return _host_plan(
        spec, n_queries, ivf, store, plan, body,
        note=f"mesh ignored: no 'data'/'model' axis in {axes}; ",
    )


def _wants_fused(spec: SearchSpec, store) -> bool:
    """A spec opts into the fused mirror-scanning executors by forcing the
    kernels, by a store on CUDA with ``kernel="auto"``, or by requesting a
    reduced-precision scan (which only they honor)."""
    return (
        spec.kernel == "cuda"
        or spec.scan_dtype != "f32"
        or (spec.kernel == "auto" and _on_cuda(store))
    )


def _host_plan(spec, n_queries, ivf, store, plan, body: str,
               note: str = "") -> ExecutionPlan:
    if spec.hbm_slots is not None and ivf is not None:
        return plan(
            "tiered-scan",
            note + f"hbm_slots={spec.hbm_slots}: bucket-granular device cache over "
            f"the routed set (scan_dtype={spec.scan_dtype}, nprobe="
            f"{spec.nprobe}, kernel={body}), exact host-RAM re-rank",
        )
    if spec.cascade is not None:
        where = "IVF-routed START, " if ivf is not None else ""
        stages = "→".join(spec.cascade)
        if n_queries > 1:
            return plan(
                "cascade-batch",
                note + f"multi-resolution cascade {stages} batched through the "
                f"batched distance kernel ({where}kernel={body}, B={n_queries})",
            )
        return plan(
            "cascade-scan",
            note + f"multi-resolution cascade {stages} ({where}kernel={body}, "
            f"B={n_queries})",
        )
    if _wants_fused(spec, store):
        if n_queries == 1 and spec.metric == "l2":
            where = "IVF-routed START, " if ivf is not None else ""
            return plan(
                "fused-scan",
                note + f"fused whole-store mirror scan ({where}scan_dtype="
                f"{spec.scan_dtype}, kernel={body})",
            )
        extra = "; IVF store scanned exactly, all buckets" if ivf else ""
        return plan(
            "fused-batch",
            note + f"fused batched mirror scan (scan_dtype={spec.scan_dtype}"
            f", kernel={body}, B={n_queries}){extra}",
        )
    if n_queries > 1 and ivf is None:
        return plan("batch-matmul",
                    note + f"batch of {n_queries} on one device: exact matmul scan")
    if spec.prefer_static and ivf is None:
        return plan("jit-masked", note + "prefer_static: shape-static masked PDXearch")
    where = "IVF-routed" if ivf is not None else "flat"
    return plan("adaptive", note + f"{where} host-orchestrated PDXearch")


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
    merged into every query's top-k, sharded paths included."""
    fn = _EXECUTORS[plan.executor]
    with _trace.span("scan", executor=plan.executor,
                     scan_dtype=spec.scan_dtype):
        ids, dists = fn(store, pruner, Q, spec, ivf=ivf, mesh=mesh,
                        stats=stats)
    with _trace.span("merge", executor=plan.executor):
        return _merge_write_head(store, pruner, Q, spec, ids, dists,
                                 stats=stats)


@dataclasses.dataclass
class PreparedSearch:
    """The host half of one planned batch; ``run()`` performs the device
    half.  Produced by ``prepare_execute`` so a serving loop can overlap
    batch N+1's host-side planning (routing, chunk planning, the first
    pass's cache uploads) with batch N's device scan — the double
    buffering in ``repro_torch.serve.vector``.  ``run()`` must be called
    exactly once, and the store must not be mutated between ``prepare``
    and ``run`` (the serving loop serializes both under its store lock /
    executor thread)."""

    plan: ExecutionPlan
    spec: SearchSpec
    _run: Callable[[], tuple[np.ndarray, np.ndarray]]

    def run(self) -> tuple[np.ndarray, np.ndarray]:
        return self._run()


def prepare_execute(
    plan: ExecutionPlan,
    spec: SearchSpec,
    store: PDXStore,
    pruner: Pruner,
    Q: torch.Tensor,
    *,
    ivf=None,
    mesh=None,
    stats: Optional[SearchStats] = None,
) -> PreparedSearch:
    """Split ``execute`` into host preparation (now) and device execution
    (``PreparedSearch.run()``, later).

    For ``routed_bucket`` the split is genuine: placement lookup, batch
    transform, bucket ranking, exchange planning and send-buffer packing
    happen here, and ``run()`` only fires the collectives.  For
    ``tiered-scan`` and ``routed_tiered`` batch transform, bucket routing,
    chunk planning and the first pass's ``issue`` (host quantize and the
    copy to the device, on the cache's staging worker) happen here, and
    ``run()`` settles the uploads, scans the pool and re-ranks.  For every
    other executor the host share is negligible, so the whole ``execute``
    is deferred into ``run()`` — callers get one uniform contract."""
    if plan.executor == "routed_bucket":
        launch, sel = _prepare_routed_host(store, pruner, Q, spec, ivf=ivf,
                                           mesh=mesh)
        runner = lambda: _run_routed_device(         # noqa: E731
            launch, sel, store, spec, ivf=ivf, stats=stats)
    elif plan.executor == "tiered-scan":
        # the host half ends with the first pass's issue: the cache uploads
        # of batch N+1 overlap batch N's device scan through the serving
        # loop's depth-1 handoff (routing-driven prefetch)
        tl = _prepare_tiered_host(store, pruner, Q, spec, ivf=ivf)
        runner = lambda: _run_tiered_device(          # noqa: E731
            tl, store, spec, ivf=ivf, stats=stats)
    elif plan.executor == "routed_tiered":
        tl = _prepare_routed_tiered_host(store, pruner, Q, spec, ivf=ivf,
                                         mesh=mesh)
        runner = lambda: _run_tiered_device(          # noqa: E731
            tl, store, spec, ivf=ivf, stats=stats, mesh=mesh)
    else:
        return PreparedSearch(
            plan=plan, spec=spec,
            _run=lambda: execute(plan, spec, store, pruner, Q, ivf=ivf,
                                 mesh=mesh, stats=stats),
        )

    def _run():
        with _trace.span("scan", executor=plan.executor,
                         scan_dtype=spec.scan_dtype):
            ids, dists = runner()
        with _trace.span("merge", executor=plan.executor):
            return _merge_write_head(store, pruner, Q, spec, ids, dists,
                                     stats=stats)

    return PreparedSearch(plan=plan, spec=spec, _run=_run)


def warm_shapes(
    spec: SearchSpec,
    store: PDXStore,
    pruner: Pruner,
    buckets,
    *,
    ivf=None,
    mesh=None,
) -> dict:
    """Warm the executor for each batch-shape bucket by pushing one
    synthetic batch per bucket through ``prepare_execute().run()`` —
    building the mirrors, the tiered cache with its host masters, quant
    params and sorted rows, and loading the kernel libraries, so a serving
    loop's steady state builds nothing (``obs.setups`` stays put).  For a
    cascade spec every stage's mirror is built too.  Returns
    {bucket: executor}.

    The reference also compiles the write-head merge at each bucket's
    shape and, per cascade stage, every pow2 survivor-compaction width
    ``S`` and widened re-rank ``rk_eff`` the batch could request.  The port
    keeps nothing per batch shape, ``S`` or ``rk_eff``: the head merge, the
    stage gather, K2's launches and the re-rank are eager PyTorch and
    kernel calls at whatever width the batch brings (K1/K3 keep host state
    per kernel and mirror shape only, which the warm batch's own stages
    set), so neither is replayed."""
    out = {}
    D = store.dim
    rng = np.random.default_rng(0)
    for b in sorted(set(int(x) for x in buckets)):
        Qb = rng.standard_normal((b, D)).astype(np.float32)
        Q = torch.from_numpy(Qb).to(store.device)
        plan = plan_search(spec, store, b, pruner=pruner, ivf=ivf, mesh=mesh)
        prepare_execute(plan, spec, store, pruner, Q, ivf=ivf, mesh=mesh).run()
        if spec.cascade is not None:
            # a stage a warm batch's survivors never reach still has its
            # mirror built (projection_mirror / device_mirror, PCA fit)
            _cascade_mirrors(spec, store)
        out[b] = plan.executor
    return out


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
def _exec_adaptive(store, pruner, Q, spec, *, ivf, mesh, stats):
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
def _exec_jit_masked(store, pruner, Q, spec, *, ivf, mesh, stats):
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
def _exec_batch_matmul(store, pruner, Q, spec, *, ivf, mesh, stats):
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


def _tile_scan(tiles, pos, Qt, sc, off, rk: int, metric: str, packed: bool,
               dim: int, allowed=None) -> TopK:
    """Scan every (S, D', C) tile with the batched kernel -> per-query
    top-``rk`` flat positions from ``pos`` (S, C) (dead lanes carry -1).
    ``allowed`` (B, S) restricts each query to some tiles: the lanes of the
    others enter the merge at +inf, after the state's -1 pads, so they can
    never be selected.  The loop of ``_fused_batch_scan`` and, masked, of
    ``_tiered_pool_scan`` (the reference's ``_tiered_scan_body``)."""
    from ..kernels.batched_matmul import MAX_PARTITIONS
    from ..kernels.ops import batched_distance_quant_op
    from ..kernels.ref import dequantize_ref

    S, _, C = tiles.shape
    B = Qt.shape[0]
    state = topk_init(rk, (B,), Qt.device)
    step = max(1, min(MAX_PARTITIONS, _FUSED_BATCH_OUT_BYTES // (B * C * 4)))
    for lo in range(0, S, step):
        t = tiles[lo:lo + step]
        if metric == "l1":  # no matmul form: dequantize + per-query scan
            t32 = dequantize_ref(t, sc, off, dim_axis=1, packed=packed, dim=dim)
            dmat = torch.stack([
                torch.sum(torch.abs(t32 - q[None, :, None]), dim=1).reshape(-1)
                for q in Qt
            ])
        else:
            dmat = batched_distance_quant_op(
                t, Qt, sc, off, metric, packed=packed, dim=dim,
            )
        if allowed is not None:
            keep = allowed[:, lo:lo + step].repeat_interleave(C, dim=1)
            dmat = torch.where(keep, dmat, float("inf"))
        state = topk_merge(state, dmat, pos[lo:lo + step].reshape(-1))
    return state


def _fused_batch_scan(mirror, ids, Qt, rk: int, metric: str) -> TopK:
    """Scan every mirror tile with the batched kernel -> per-query top-``rk``
    flat positions (PAD lanes carry position -1)."""
    P, _, C = mirror.data.shape
    pos = torch.arange(P * C, dtype=torch.int32, device=ids.device).reshape(P, C)
    pos = torch.where(ids >= 0, pos, -1)
    return _tile_scan(
        mirror.data, pos, Qt, mirror.scale if mirror.quantized else None,
        mirror.offset if mirror.quantized else None, rk, metric,
        mirror.packed, mirror.dim,
    )


def _positions_to_ids(store_ids, cand: TopK) -> TopK:
    safe = torch.clamp(cand.ids, min=0).long()
    gids = torch.where(cand.ids >= 0, store_ids.reshape(-1)[safe], -1)
    return TopK(dists=cand.dists, ids=gids)


@register_executor("fused-batch")
def _exec_fused_batch(store, pruner, Q, spec, *, ivf, mesh, stats):
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
def _exec_fused_scan(store, pruner, Q, spec, *, ivf, mesh, stats):
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
def _exec_cascade_scan(store, pruner, Q, spec, *, ivf, mesh, stats):
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
def _exec_cascade_batch(store, pruner, Q, spec, *, ivf, mesh, stats):
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


# ------------------------------------------------- tiered executor
# Serving beyond device memory: the host-RAM f32 masters stay
# authoritative, the device holds only a fixed slot pool
# (``core.layout.BucketCache``) of the quantized tile extents of recently
# routed IVF buckets.  A batch flows: route (two-level centroid tree when
# attached) -> admit the routed buckets (LRU-evicting cold ones) -> masked
# pool scan at ``spec.scan_dtype`` width (K2 on the card) -> exact re-rank
# against the host masters.  Each (chunk, pass) step issues the NEXT
# step's uploads while its own scan runs.

def _get_bucket_cache(store, spec, *, ivf, n_regions=1, bucket_region=None):
    """The store's ``BucketCache`` for this spec's (capacity, dtype,
    regions), kept on the store: pool allocation and quant-param passes
    cost once per configuration, not once per batch.  Generation
    invalidation is the cache's own job (``tiles_version``)."""
    key = (spec.hbm_slots, spec.scan_dtype, int(n_regions))
    caches = getattr(store, "_tiered_cache", None)
    if caches is None:
        caches = {}
        store._tiered_cache = caches
    bc = caches.get(key)
    if bc is None:
        _setups.note("bucket_cache")
        po = pc = None
        if getattr(store, "num_buckets", None) is None:
            po = np.asarray(ivf.part_offsets)
            pc = np.asarray(ivf.part_counts)
        bc = BucketCache(
            store, capacity_slots=spec.hbm_slots, dtype=spec.scan_dtype,
            n_regions=n_regions, bucket_region=bucket_region,
            part_offsets=po, part_counts=pc,
        )
        caches[key] = bc
    elif bucket_region is not None:
        bc._bucket_region = np.asarray(bucket_region, np.int64)
    return bc


def _tiered_pool_scan(
    pool, slot_ids, slot_bucket, sel, Qt, scale, offset, rk: int, metric: str,
    quantized: bool, packed: bool = False, dim: Optional[int] = None,
) -> TopK:
    """Single-device tiered scan -> per-query top-``rk`` flat POOL positions
    (s * C + c; dead and free lanes carry -1).  Positions resolve to global
    ids on the host through ``BucketCache.slot_ids_host``: the exact
    re-rank never touches a device copy of the store."""
    S, _, C = pool.shape
    sc = scale if quantized else None
    off = offset if quantized else None
    # -1 marks BOTH unrouted sel pads (tree routing) and free pool slots;
    # remap sel pads to -2 so they can never select a free slot's tiles
    sel_safe = torch.where(sel >= 0, sel, -2)
    allowed = (sel_safe[:, :, None] == slot_bucket[None, None, :]).any(dim=1)
    pos = torch.arange(S * C, dtype=torch.int32, device=pool.device).reshape(S, C)
    pos = torch.where(slot_ids >= 0, pos, -1)
    return _tile_scan(pool, pos, Qt, sc, off, rk, metric, packed, dim,
                      allowed=allowed)


def _host_master_rows(store) -> tuple[np.ndarray, np.ndarray]:
    """Sorted-by-id flat view of the live host-RAM f32 master rows, cached
    per ``tiles_version`` — the authoritative tier the tiered executor
    re-ranks against (write-head rows merge separately and sealed tiles only
    change with tiles_version, so the sort amortizes over serving).  Built
    from the host masters ``BucketCache`` uses, so a store on the card is
    copied to the host once per version."""
    ver = getattr(store, "tiles_version", 0)
    cached = getattr(store, "_host_rows_cache", None)
    if cached is not None and cached[0] == ver:
        return cached[1], cached[2]
    _setups.note("host_rows")
    data, ids, _ = _host_masters(store)
    live = np.asarray(ids) >= 0
    # the live columns in (partition, lane) order, as rows: the reference's
    # transposed flat view with its live rows kept, without the full copy
    rows = np.swapaxes(np.asarray(data, np.float32), 1, 2)[live]
    flat_ids = np.asarray(ids)[live]
    order = np.argsort(flat_ids, kind="stable")
    out = (ver, flat_ids[order], rows[order])
    store._host_rows_cache = out
    return out[1], out[2]


def _tiered_rerank(
    store, cache, cand: TopK, Qt_np: np.ndarray, k: int, metric: str,
) -> tuple[np.ndarray, np.ndarray]:
    """Exact re-rank of pool-scan candidates against the HOST masters:
    positions -> cached global ids -> master rows (binary search on the
    sorted-id view) -> exact f32 metric -> top-k, NumPy's stable sort."""
    slot_ids = cache.slot_ids_host().reshape(-1)
    sorted_ids, rows = _host_master_rows(store)
    pos = cand.ids.cpu().numpy()
    B = pos.shape[0]
    out_i = np.full((B, k), -1, np.int64)
    out_d = np.full((B, k), np.inf, np.float32)
    for b in range(B):
        p = pos[b]
        gids = np.where(p >= 0, slot_ids[np.maximum(p, 0)], -1)
        gids = gids[gids >= 0]
        if gids.size == 0:
            continue
        loc = np.searchsorted(sorted_ids, gids)  # cached ids are all live
        x = rows[loc]
        q = Qt_np[b]
        if metric == "l2":
            d = ((x - q) ** 2).sum(axis=1)
        elif metric == "l1":
            d = np.abs(x - q).sum(axis=1)
        else:
            d = -(x @ q)
        order = np.argsort(d, kind="stable")[: k]
        out_i[b, : len(order)] = gids[order]
        out_d[b, : len(order)] = d[order].astype(np.float32)
    return out_i, out_d


def _tiered_chunks(
    sel: np.ndarray, cnts: np.ndarray, region_of, region_slots: int,
) -> list[list[int]]:
    """Greedy query chunking so each chunk's union bucket demand fits the
    pool (per region): batches whose routed set overflows the cache run as
    several admit+scan rounds instead of failing.  A chunk is cut when
    admitting the next query's buckets would overflow any region."""
    B = sel.shape[0]
    chunks: list[list[int]] = []
    cur: list[int] = []
    seen: set[int] = set()
    demand: dict[int, int] = {}
    for b in range(B):
        row = [int(x) for x in sel[b]
               if x >= 0 and int(cnts[int(x)]) > 0]
        new = [x for x in dict.fromkeys(row) if x not in seen]
        add: dict[int, int] = {}
        for x in new:
            r = region_of(x)
            add[r] = add.get(r, 0) + int(cnts[x])
        fits = all(
            demand.get(r, 0) + a <= region_slots for r, a in add.items()
        )
        if cur and not fits:
            chunks.append(cur)
            cur, seen, demand = [], set(), {}
            new = list(dict.fromkeys(row))
            add = {}
            for x in new:
                r = region_of(x)
                add[r] = add.get(r, 0) + int(cnts[x])
        cur.append(b)
        seen.update(new)
        for r, a in add.items():
            demand[r] = demand.get(r, 0) + a
    if cur:
        chunks.append(cur)
    return chunks


def _chunk_passes(
    chunk_sel: np.ndarray, cnts: np.ndarray, region_of, region_slots: int,
) -> list[tuple[list[int], Optional[dict]]]:
    """Pass schedule for one chunk's routed bucket union: a list of
    ``(bucket_list, parts)`` upload requests, each fitting every cache
    region.  The common case — demand fits — is one full pass.  A bucket
    whose extent alone exceeds a region is cut into region-sized
    sub-extents (``parts[b] = (part_i, n_parts)``, ceil-divided), and the
    items pack greedily into sequential passes; the run loop scans each
    pass and merges top-k."""
    uniq: list[int] = []
    for row in chunk_sel:
        for x in row:
            x = int(x)
            if x >= 0 and x < len(cnts) and int(cnts[x]) > 0:
                uniq.append(x)
    uniq = list(dict.fromkeys(uniq))
    demand: dict[int, int] = {}
    for b in uniq:
        r = region_of(b)
        demand[r] = demand.get(r, 0) + int(cnts[b])
    if all(d <= region_slots for d in demand.values()):
        return [(uniq, None)]
    items: list[tuple[int, Optional[tuple], int]] = []
    for b in uniq:
        c = int(cnts[b])
        if c > region_slots:
            n_parts = -(-c // region_slots)
            per = -(-c // n_parts)
            for pi in range(n_parts):
                items.append((b, (pi, n_parts), min(per, c - pi * per)))
        else:
            items.append((b, None, c))
    passes: list[tuple[list[int], Optional[dict]]] = []
    cur: list[int] = []
    parts: dict[int, tuple] = {}
    used: dict[int, int] = {}
    for b, part, size in items:
        r = region_of(b)
        if cur and used.get(r, 0) + size > region_slots:
            passes.append((cur, parts or None))
            cur, parts, used = [], {}, {}
        cur.append(b)
        if part is not None:
            parts[b] = part
        used[r] = used.get(r, 0) + size
    if cur:
        passes.append((cur, parts or None))
    return passes


def _merge_topk_rows(
    i1: np.ndarray, d1: np.ndarray, i2: np.ndarray, d2: np.ndarray, k: int,
) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise top-k merge of two (B, k) id/dist result blocks with id
    dedup — later passes of a split chunk rescan still-resident buckets
    (and leftover sub-extents), so the same vector can surface twice; the
    exact re-rank makes duplicate distances identical, keep one."""
    B = i1.shape[0]
    out_i = np.full((B, k), -1, np.int64)
    out_d = np.full((B, k), np.inf, np.float32)
    for b in range(B):
        ids = np.concatenate([i1[b], i2[b]])
        ds = np.concatenate([d1[b], d2[b]]).astype(np.float32)
        live = ids >= 0
        ids, ds = ids[live], ds[live]
        if ids.size == 0:
            continue
        order = np.lexsort((ds, ids))
        ids, ds = ids[order], ds[order]
        keep = np.ones(ids.size, bool)
        keep[1:] = ids[1:] != ids[:-1]
        ids, ds = ids[keep], ds[keep]
        order = np.argsort(ds, kind="stable")[:k]
        out_i[b, : order.size] = ids[order]
        out_d[b, : order.size] = ds[order]
    return out_i, out_d


@dataclasses.dataclass
class _TieredLaunch:
    """Host-side product of ``_prepare_tiered_host``: the routed set, the
    chunk schedule with each chunk's pass schedule, and the FIRST pass's
    in-flight upload ticket (issuing it at prepare time is the prefetch).
    Later passes issue inside ``_run_tiered_device``, one ahead of the
    scan."""

    cache: BucketCache
    Qt: torch.Tensor
    Qt_np: np.ndarray
    sel: np.ndarray
    chunks: list
    passes: list
    ticket: object
    rk: int


def _tiered_rk(spec: SearchSpec, cache: BucketCache, C: int) -> int:
    if spec.scan_dtype == "f32":
        return spec.k
    return min(spec.rerank_mult * spec.k, cache.capacity_slots * C)


def _prepare_tiered_host(store, pruner, Q, spec, *, ivf) -> _TieredLaunch:
    """Host half of the tiered executor: batch transform, bucket routing,
    chunk planning, and the first pass's ``issue`` (the prefetch)."""
    if ivf is None:
        raise ValueError(
            "tiered-scan executor needs an IVF index (spec.hbm_slots caches "
            "at bucket granularity, which only routing defines)"
        )
    cache = _get_bucket_cache(store, spec, ivf=ivf)
    return _tiered_launch(store, pruner, Q, spec, ivf, cache)


def _tiered_launch(store, pruner, Q, spec, ivf, cache: BucketCache,
                   **route_attrs) -> _TieredLaunch:
    """The host half of both tiered executors once the cache is chosen:
    batch transform, bucket routing, chunk planning, the first pass's
    ``issue``."""
    Qt = _transform_batch(pruner, Q.to(torch.float32))
    with _trace.span("route", nprobe=spec.nprobe, tiered=True, **route_attrs):
        sel = np.asarray(
            ivf.route_batch(Qt, spec.nprobe, spec.metric, spec.route_dtype)
        )
    _, cnts = cache._bucket_extent()
    chunks = _tiered_chunks(sel, cnts, cache._region_of, cache.region_slots)
    passes = [
        _chunk_passes(sel[chunk], cnts, cache._region_of, cache.region_slots)
        for chunk in chunks
    ]
    blist, parts = passes[0][0]
    with _trace.span("prefetch", buckets=len(blist)):
        ticket = cache.issue(np.asarray(blist, np.int64), parts=parts)
    return _TieredLaunch(
        cache=cache, Qt=Qt, Qt_np=Qt.cpu().numpy(), sel=sel, chunks=chunks,
        passes=passes, ticket=ticket,
        rk=_tiered_rk(spec, cache, store.capacity),
    )


def _tiered_stats(stats, store, cache, sel, ivf) -> None:
    if stats is not None:
        _selected_bucket_stats(stats, store, *cache._bucket_extent(), sel)


def _selected_bucket_stats(stats, store, offs, cnts, sel) -> None:
    """Selected-bucket work accounting of the routed and tiered executors:
    every live value in a probed bucket (partitions ``offs[b]`` on, ``cnts[b]``
    of them) is computed, everything outside is avoided by routing, not by
    a pruning predicate (values_total counts only visited partitions, the
    adaptive + IVF convention)."""
    counts = store.counts.cpu().numpy()
    nb = len(cnts)
    bucket_rows = np.array(
        [counts[offs[b]: offs[b] + cnts[b]].sum() for b in range(nb)],
        dtype=np.float64,
    )
    valid = sel >= 0
    safe = np.where(valid, sel, 0)
    work = float(np.where(valid, bucket_rows[safe], 0.0).sum()) * store.dim
    stats.values_total += work
    stats.values_computed += work
    stats.partitions_visited += int(np.where(valid, cnts[safe], 0).sum())


def _tiered_steps(launch: _TieredLaunch) -> list[tuple[int, int]]:
    """Flattened (chunk, pass) schedule of a tiered launch."""
    return [
        (ci, pi)
        for ci in range(len(launch.chunks))
        for pi in range(len(launch.passes[ci]))
    ]


def _tiered_step_ready(cache, launch, ticket, ci, pi):
    """Settle the step's prefetch ticket and hand back a consistent scan
    snapshot.  The ticket normally covers exactly this pass; when another
    batch's ``issue`` took slots in between, re-admit synchronously —
    correctness never rides on the overlap."""
    cache.wait(ticket)
    blist, parts = launch.passes[ci][pi]
    if not cache.resident_ok(np.asarray(blist, np.int64), parts=parts):
        cache.ensure(np.asarray(blist, np.int64), parts=parts)
    return cache.snapshot()


def _tiered_step_issue_next(cache, launch, steps, si):
    """Start the NEXT step's uploads (host quantize + async copy) while the
    step just enqueued is still scanning on the device."""
    if si + 1 >= len(steps):
        return None
    nci, npi = steps[si + 1]
    blist, parts = launch.passes[nci][npi]
    return cache.issue(np.asarray(blist, np.int64), parts=parts)


def _run_tiered_device(launch: _TieredLaunch, store, spec, *, ivf, stats,
                       mesh=None):
    """Device half: per (chunk, pass) step, settle the step's prefetch
    ticket -> masked pool scan -> issue the NEXT step's uploads under the
    scan -> exact host re-rank; multi-pass chunks (routed demand beyond
    the slot pool) merge their per-pass top-k, chunk results land back in
    batch order.  With a ``mesh`` (routed_tiered) each rank scans its
    region of the pool and one all-gather per step merges the ranks'
    candidates (``_tiered_shard_scan``)."""
    cache, sel = launch.cache, launch.sel
    B = sel.shape[0]
    out_i = np.full((B, spec.k), -1, np.int64)
    out_d = np.full((B, spec.k), np.inf, np.float32)
    C = store.capacity
    dev = launch.Qt.device
    scan = (_tiered_pool_scan if mesh is None
            else functools.partial(_tiered_shard_scan, mesh))
    steps = _tiered_steps(launch)
    ticket = launch.ticket
    for si, (ci, pi) in enumerate(steps):
        chunk = launch.chunks[ci]
        # settle, check residency, snapshot and enqueue the scan under the
        # cache's lock: another thread's issue (the serving loop preparing
        # the next batch) cannot evict between the check and the snapshot,
        # and any later pool write comes after this scan — in stream order
        # on the card (both threads enqueue on the default stream), in time
        # on the CPU, where the scan runs inside the lock
        with cache._lock:
            arrays, slot_ids = _tiered_step_ready(cache, launch, ticket, ci, pi)
            pool, ids_dev, slot_bucket, scale, offset = arrays
            rows = torch.as_tensor(chunk, device=dev)
            cand = scan(
                pool, ids_dev, slot_bucket, torch.from_numpy(sel[chunk]).to(dev),
                launch.Qt[rows], scale, offset, launch.rk, spec.metric,
                cache.quantized, packed=cache.packed, dim=cache.dim,
            )
        # the scan is in flight: overlap the next step's staging + copy
        ticket = _tiered_step_issue_next(cache, launch, steps, si)
        ids_c, dists_c = _tiered_rerank(
            store, _TieredSnapshot(slot_ids), cand, launch.Qt_np[chunk],
            spec.k, spec.metric,
        )
        if pi == 0:
            out_i[chunk] = ids_c
            out_d[chunk] = dists_c
        else:
            out_i[chunk], out_d[chunk] = _merge_topk_rows(
                out_i[chunk], out_d[chunk], ids_c, dists_c, spec.k
            )
        if _metrics.enabled():
            scan_bytes = (float(cache.capacity_slots) * cache.dim * C
                          * cache.bytes_per_value)
            if mesh is None:
                _metrics.counter(
                    "repro_device_bytes_total", scan_bytes,
                    executor="tiered-scan", component="scan", dtype=cache.dtype,
                )
            else:
                from ..dist import axis_size
                from ..obs import meters as _meters

                _meters.count_issued("routed_tiered", all_gather=1)
                _meters.record_device_bytes("routed_tiered", cache.dtype, {
                    "scan": scan_bytes,
                    "all_gather": float(axis_size(mesh, "data") * len(chunk)
                                        * 2 * launch.rk * 4),
                })
    cache.wait(ticket)
    _tiered_stats(stats, store, cache, sel, ivf)
    return out_i, out_d


class _TieredSnapshot:
    """Adapter handing ``_tiered_rerank`` a frozen ``slot_ids_host`` copy
    (a later step's admission must not remap an earlier step's candidate
    positions mid-resolution)."""

    def __init__(self, slot_ids: np.ndarray):
        self._slot_ids = np.array(slot_ids, copy=True)

    def slot_ids_host(self) -> np.ndarray:
        return self._slot_ids


@register_executor("tiered-scan")
def _exec_tiered_scan(store, pruner, Q, spec, *, ivf, mesh, stats):
    """Tiered search beyond device memory: route -> admit (bucket-granular
    LRU device cache) -> masked quantized pool scan -> exact host-RAM
    re-rank.  The blocking composition of ``_prepare_tiered_host`` +
    ``_run_tiered_device``."""
    launch = _prepare_tiered_host(store, pruner, Q, spec, ivf=ivf)
    return _run_tiered_device(launch, store, spec, ivf=ivf, stats=stats)


# ------------------------------------------------------- mesh executors
def _get_placement(store, n_shards: int, kind: str, *, ivf=None, axis="data"):
    """The store's tile->shard ``Placement``, cached per ``(tiles_version,
    n_shards, kind)``: arranging and padding copies the tiles, which must
    cost once per sealed-tile mutation, not once per search.  A dict, so
    one store serving two mesh sizes (or block and bucket layouts) never
    thrashes; stale-version entries are evicted."""
    from ..dist.placement import Placement  # no core<->dist cycle

    version = getattr(store, "tiles_version", 0)
    key = (version, n_shards, kind)
    cache = getattr(store, "_placement_cache", None)
    if cache is None:
        cache = {}
        store._placement_cache = cache
    pl = cache.get(key)
    _metrics.counter(
        "repro_cache_events_total", cache="placement",
        event="hit" if pl is not None else "miss",
    )
    if pl is None:
        if kind == "block":
            pl = Placement.block(store.data, store.ids, n_shards, axis=axis)
        elif kind == "bucket":
            pb = getattr(store, "_part_bucket", None)
            if pb is None:  # frozen store: derive from the (synced) index
                pb = np.repeat(np.arange(ivf.nlist), ivf.part_counts)
            if len(pb) < store.num_partitions:  # all-pad placeholder tiles
                pb = np.concatenate(
                    [pb, np.full(store.num_partitions - len(pb), -1, np.int64)]
                )
            pl = Placement.bucket(
                store.data, store.ids, pb, ivf.nlist, n_shards, axis=axis
            )
        else:
            raise ValueError(f"no cached placement kind {kind!r}")
        for stale in [kk for kk in cache if kk[0] != version]:
            del cache[stale]
        cache[key] = pl
    return pl


def _mesh_axis(mesh, axis: str, executor: str) -> int:
    """Size of ``axis`` on ``mesh``; a mesh without it cannot run
    ``executor``."""
    from ..dist import mesh_shape

    if mesh is None or axis not in mesh_shape(mesh):
        raise ValueError(
            f"{executor} executor needs a mesh with a '{axis}' axis, got {mesh!r}"
        )
    return mesh_shape(mesh)[axis]


def _stack_numpy(results: list) -> tuple[np.ndarray, np.ndarray]:
    return (np.stack([r.ids.cpu().numpy() for r in results]),
            np.stack([r.dists.cpu().numpy() for r in results]))


@register_executor("block-sharded")
def _exec_block_sharded(store, pruner, Q, spec, *, ivf, mesh, stats):
    from ..dist.pdx_sharded import search_block_sharded

    pl = _get_placement(store, _mesh_axis(mesh, "data", "block-sharded"),
                        "block")
    return _stack_numpy([
        search_block_sharded(
            mesh, q=q, k=spec.k, metric=spec.metric, pruner=pruner,
            schedule=spec.schedule, delta_d=spec.delta_d, placement=pl,
            stats=stats,
        )
        for q in Q
    ])


@register_executor("dim-sharded")
def _exec_dim_sharded(store, pruner, Q, spec, *, ivf, mesh, stats):
    from ..dist.pdx_sharded import search_dim_sharded
    from ..dist.placement import Placement

    pl = Placement.replicated(store.data, store.ids,
                              _mesh_axis(mesh, "model", "dim-sharded"))
    out = _stack_numpy([
        search_dim_sharded(mesh, q=pruner.transform_query(q), k=spec.k,
                           metric=spec.metric, placement=pl)
        for q in Q
    ])
    _exact_scan_stats(stats, store, len(Q))
    return out


@register_executor("batch-block-sharded")
def _exec_batch_block_sharded(store, pruner, Q, spec, *, ivf, mesh, stats):
    from ..dist.pdx_sharded import search_batch_block_sharded

    n_sh = _mesh_axis(mesh, "data", "batch-block-sharded")
    pl = _get_placement(store, n_sh, "block")
    Qt = _transform_batch(pruner, Q)
    dt = spec.scan_dtype
    mirror = device_mirror(store, dt) if dt != "f32" else None
    res = search_batch_block_sharded(
        mesh, Q=Qt, k=spec.k, metric=spec.metric, placement=pl,
        mirror=mirror, rerank_mult=spec.rerank_mult,
    )
    B = Q.shape[0]
    _exact_scan_stats(stats, store, B)
    if _metrics.enabled():
        from ..obs import meters as _meters

        _meters.count_issued("batch-block-sharded", all_gather=1)
        P, D, C = store.data.shape
        bpv = mirror.bytes_per_value if mirror is not None else 4
        wire = _meters.broadcast_batch_bytes(
            n_shards=n_sh, B=B, D=store.dim, k=spec.k
        )
        wire["scan"] = float(P * D * C * bpv)
        _meters.record_device_bytes(
            "batch-block-sharded", mirror.dtype if mirror is not None else "f32",
            wire,
        )
    return _numpy(res)


# ------------------------------------------------- bucket-routed executors
def _prepare_routed_host(store, pruner, Q, spec, *, ivf, mesh):
    """Host half of the routed executor: placement lookup, batch transform,
    bucket ranking, exchange planning, send-buffer packing.  No collective
    fires here — that is ``_run_routed_device``'s job."""
    if ivf is None:
        raise ValueError("routed_bucket executor needs an IVF index")
    from ..dist.routing import prepare_routed

    pl = _get_placement(store, _mesh_axis(mesh, "data", "routed_bucket"),
                        "bucket", ivf=ivf)
    Qt = _transform_batch(pruner, Q.to(torch.float32))
    sel = ivf.route_batch(Qt, spec.nprobe, spec.metric, spec.route_dtype)
    dt = spec.scan_dtype
    mirror = device_mirror(store, dt) if dt != "f32" else None
    launch = prepare_routed(
        mesh, pl, Qt, sel, spec.k, metric=spec.metric,
        mirror=mirror, rerank_mult=spec.rerank_mult,
    )
    return launch, sel


def _run_routed_device(launch, sel, store, spec, *, ivf, stats):
    """Device half: fire the prepared exchange, scan and merge, then
    account the selected-bucket work."""
    from ..dist.routing import launch_routed

    res = launch_routed(launch)
    if stats is not None:
        _selected_bucket_stats(stats, store, np.asarray(ivf.part_offsets),
                               np.asarray(ivf.part_counts), np.asarray(sel))
    return _numpy(res)


@register_executor("routed_bucket")
def _exec_routed_bucket(store, pruner, Q, spec, *, ivf, mesh, stats):
    """Bucket-routed search on a "data" mesh: queries travel to the shards
    that own their top-nprobe buckets (one all-to-all, two when the plan
    spills, and one packed all-gather per batch: ``repro_torch.dist.
    routing``).  Exact over each query's selected buckets; with nprobe >=
    nlist it equals the exact full scan.  The blocking composition of
    ``_prepare_routed_host`` and ``_run_routed_device``."""
    launch, sel = _prepare_routed_host(store, pruner, Q, spec, ivf=ivf,
                                       mesh=mesh)
    return _run_routed_device(launch, sel, store, spec, ivf=ivf, stats=stats)


def _prepare_routed_tiered_host(store, pruner, Q, spec, *, ivf, mesh):
    """Host half of routed-tiered: region assignment (bucket -> owner shard,
    the greedy balance of bucket placements, over the current bucket
    extents), routing, chunk planning, the first pass's ``issue``.

    Every rank keeps the same cache bookkeeping and a whole pool: the
    ranks see the same batches, so they admit, evict and upload alike, and
    rank r scans only its region's slots."""
    if ivf is None:
        raise ValueError("routed_tiered executor needs an IVF index")
    from ..dist.placement import assign_buckets

    n_sh = _mesh_axis(mesh, "data", "routed_tiered")
    # the region split follows the CURRENT bucket extents (the same on every
    # rank); the cache regenerates its whole pool when tiles_version moves,
    # so a refreshed assignment never mixes with stale residency.  The
    # greedy split is a Python loop over the buckets (ms at nlist 1000), so
    # it is kept beside the extents it was made from
    tmp = _get_bucket_cache(store, spec, ivf=ivf, n_regions=n_sh)
    _, cnts = tmp._bucket_extent()
    made = getattr(tmp, "_region_split", None)
    if made is None or not np.array_equal(made[0], cnts):
        made = (np.array(cnts, copy=True), assign_buckets(cnts, n_sh))
        tmp._region_split = made
    cache = _get_bucket_cache(store, spec, ivf=ivf, n_regions=n_sh,
                              bucket_region=made[1])
    return _tiered_launch(store, pruner, Q, spec, ivf, cache, n_shards=n_sh)


def _tiered_shard_scan(mesh, pool, slot_ids, slot_bucket, sel, Qt, scale,
                       offset, rk: int, metric: str, quantized: bool,
                       packed: bool = False, dim: Optional[int] = None) -> TopK:
    """The routed-tiered scan of one step on this rank: the pool's region r
    (slots ``[r * S/n, (r+1) * S/n)``) through ``_tiered_pool_scan`` -> the
    region's top-``rk`` as GLOBAL pool positions; the ranks' (B, 2rk)
    packed candidates cross in ONE all-gather and merge to the replicated
    top-``rk``.  Candidate resolution and the exact re-rank stay on the
    host, against the RAM masters."""
    from ..dist import axis_rank, axis_size
    from ..dist.pdx_sharded import _gather_packed

    S, _, C = pool.shape
    w = S // axis_size(mesh, "data")
    lo = axis_rank(mesh, "data") * w
    sl = slice(lo, lo + w)
    cand = _tiered_pool_scan(pool[sl], slot_ids[sl], slot_bucket[sl], sel, Qt,
                             scale, offset, rk, metric, quantized, packed=packed,
                             dim=dim)
    # region positions -> pool positions (a constant shift keeps the order)
    cand.ids = torch.where(cand.ids >= 0, cand.ids + lo * C, -1)
    return _gather_packed(cand, mesh, "data", rk)


@register_executor("routed_tiered")
def _exec_routed_tiered(store, pruner, Q, spec, *, ivf, mesh, stats):
    """Tiered search on a "data" mesh: each shard scans one region of the
    bucket pool (regions follow the greedy bucket -> shard balance of
    bucket placements) masked to the routed buckets, the candidates merge
    in ONE packed all-gather per step, and id resolution and the exact f32
    re-rank stay on the host masters."""
    launch = _prepare_routed_tiered_host(store, pruner, Q, spec, ivf=ivf,
                                         mesh=mesh)
    return _run_tiered_device(launch, store, spec, ivf=ivf, stats=stats,
                              mesh=mesh)
