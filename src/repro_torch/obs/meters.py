"""Work and byte models of the fused scan (counterpart of the part of
``repro.obs.meters`` the ported executors need).

``fused_tile_counts`` replays the fused megakernel's exact per-d-tile
ADSampling arithmetic (``kernels.ref.pdx_prune_scan_multi_ref``) and
returns, per tile, how many lanes and partitions were still alive when the
tile was reached: lanes x tile width is the ``SearchStats``
``values_computed`` account, partitions x tile width x capacity x mirror
byte width the demand-bytes model.

``cache_upload_wait`` meters one settle of the tiered bucket cache's
asynchronous uploads (``core.layout.BucketCache.wait``).

Collective meters: ``collective_counts`` runs a function and returns the
collectives it issued, by the reference's primitive names (the reference
walks a traced jaxpr; the port counts at the one module that issues them,
``repro_torch.dist``); ``count_issued`` accumulates
``repro_collectives_issued_total`` from the executed plan.  The
reference's ``record_compile_collectives`` publishes a jaxpr walk once per
compiled shape; the port compiles nothing per shape and has no jaxpr, so it
has no counterpart.  ``routed_batch_bytes`` and ``broadcast_batch_bytes``
are the wire models of the bucket-routed and the broadcast executors, and
``record_device_bytes`` records such a model into
``repro_device_bytes_total``.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..kernels.ref import pdx_prune_scan_multi_ref
from . import metrics

__all__ = ["collective_counts", "count_issued", "tile_widths",
           "fused_tile_counts", "fused_demand_bytes", "routed_batch_bytes",
           "broadcast_batch_bytes",
           "record_device_bytes", "cache_upload_wait"]


# ------------------------------------------------------------ collectives
def collective_counts(fn, *args, **kwargs) -> dict[str, int]:
    """Run ``fn(*args, **kwargs)`` and return the collectives it issued in
    this process, by primitive (``all_gather``, ``psum``, ...), e.g. to
    assert that the batched path issues exactly one all-gather per batch."""
    from ..dist import issued_counts

    before = issued_counts()
    fn(*args, **kwargs)
    after = issued_counts()
    return {p: n - before.get(p, 0) for p, n in after.items()
            if n != before.get(p, 0)}


def count_issued(executor: str, **primitives: int) -> None:
    """Accumulate ``repro_collectives_issued_total`` counters from the
    executed plan (e.g. ``count_issued("batch-block-sharded",
    all_gather=1)`` per batch)."""
    if not metrics.enabled():
        return
    for prim, n in primitives.items():
        metrics.counter(
            "repro_collectives_issued_total", float(n), executor=executor,
            primitive=prim,
        )


def tile_widths(D: int, d_tile: int = 64) -> np.ndarray:
    """Widths of the megakernel's d-tiles over a D-dimensional store."""
    edges = np.arange(0, D, d_tile)
    return np.minimum(edges + d_tile, D) - edges


def fused_tile_counts(
    mdata, ids, qt, thr, scale=None, offset=None, *,
    eps0: float, d_tile: int = 64, packed: bool = False,
    dim: Optional[int] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Per-d-tile (lanes alive, partitions alive) entering each tile of a
    fused keep-mask scan of the (P, D, V) mirror tiles ``mdata`` (lanes with
    ``ids < 0`` start dead).  ``scale``/``offset`` are the mirror's dequant
    vectors (None for f32/bf16); ``packed``/``dim`` mark a packed int4
    mirror whose logical D is ``dim``.  Returns two (n_tiles,) arrays."""
    _, _, walk = pdx_prune_scan_multi_ref(
        mdata, ids, qt, thr, d_tile=d_tile, eps0=eps0, scale=scale,
        offset=offset, packed=packed, dim=dim, trace=True,
    )
    return (walk.lanes.cpu().numpy().astype(np.float32),
            walk.parts.cpu().numpy().astype(np.float32))


def fused_demand_bytes(
    mirror, ids, qt, thr, *, p0: int, eps0: float, d_tile: int = 64
) -> float:
    """Demand bytes of one fused-scan query: the START partition streams
    once at f32 (the exact threshold seed), then a partition's d-tile is
    needed only while any of its lanes is alive, at mirror width.
    ``mirror`` is a ``core.layout.DeviceMirror``; ``p0`` the START
    partition (masked out of the pruned scan, exactly as the executor does).
    """
    C = mirror.data.shape[2]
    D = mirror.dim  # logical D (packed int4 halves the stored axis)
    ids_scan = ids.clone()
    ids_scan[p0] = -1
    _, parts = fused_tile_counts(
        mirror.data, ids_scan, qt, thr, mirror.scale, mirror.offset,
        eps0=eps0, d_tile=d_tile, packed=mirror.packed, dim=mirror.dim,
    )
    w = tile_widths(D, d_tile)
    return float(D * C * 4 + (parts * w).sum() * C * mirror.bytes_per_value)


def routed_batch_bytes(
    rp, *, n_shards: int, D: int, C: int, num_slots: int, nprobe: int,
    k: int, bytes_per_value: float = 4.0, rerank_mult: int = 4,
    quantized: bool = False,
) -> dict[str, float]:
    """Per-batch byte totals of one routed-bucket search under
    ``RoutingPlan`` ``rp``: the padded all-to-all payload (queries with
    their bucket ids reinterpreted as f32, an f32 wire), the packed
    candidate all-gather, each rank's one mirror-slice scan, and, when
    quantized, the f32 master columns the on-shard re-rank gathers per
    delivered query."""
    n_dests = float((np.asarray(rp.dest_shard) >= 0).sum())
    return {
        "scan": float(num_slots * D * C * bytes_per_value),
        "rerank": (n_dests * rerank_mult * k * D * 4.0) if quantized else 0.0,
        "all_to_all": float(n_shards * n_shards * rp.budget * (D + nprobe) * 4),
        "all_gather": float(n_shards * (n_shards * rp.budget) * 2 * k * 4),
    }


def broadcast_batch_bytes(
    *, n_shards: int, B: int, D: int, k: int
) -> dict[str, float]:
    """Per-batch wire bytes of the mirrored-broadcast executors: every query
    replicates to every shard, one packed (B, 2k) all-gather merges."""
    return {
        "all_to_all": 0.0,
        "broadcast": float(n_shards * B * D * 4),
        "all_gather": float(n_shards * B * 2 * k * 4),
    }


def record_device_bytes(executor: str, dtype: str, components: dict) -> None:
    """Accumulate a components dict (as the wire models return it) into
    ``repro_device_bytes_total{executor, component, dtype}`` counters."""
    if not metrics.enabled():
        return
    for comp, nbytes in components.items():
        if nbytes:
            metrics.counter(
                "repro_device_bytes_total", float(nbytes),
                executor=executor, component=comp, dtype=dtype,
            )


def cache_upload_wait(wait_us: float, total_us: float) -> None:
    """Record one async bucket-cache upload completion: the
    ``repro_cache_upload_wait_us`` histogram holds how long the host
    actually blocked on the in-flight host-to-device copies at
    ``BucketCache.wait``, and the ``repro_cache_upload_overlap_ratio``
    gauge the fraction of the issue->complete window hidden behind compute
    (1.0 = the copy finished entirely under the overlapped scan, 0.0 =
    fully synchronous)."""
    if not metrics.enabled():
        return
    metrics.observe("repro_cache_upload_wait_us", float(wait_us))
    if total_us > 0:
        metrics.gauge(
            "repro_cache_upload_overlap_ratio",
            max(0.0, 1.0 - float(wait_us) / float(total_us)),
        )
