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
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..kernels.ref import pdx_prune_scan_multi_ref
from . import metrics

__all__ = ["tile_widths", "fused_tile_counts", "fused_demand_bytes",
           "cache_upload_wait"]


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
