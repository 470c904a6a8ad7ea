"""Work and byte models of the fused scan (counterpart of the part of
``repro.obs.meters`` the ported executors need).

``fused_tile_counts`` replays the fused megakernel's exact per-d-tile
ADSampling arithmetic (``kernels.ref.pdx_prune_scan_multi_ref``) and
returns, per tile, how many lanes and partitions were still alive when the
tile was reached: lanes x tile width is the ``SearchStats``
``values_computed`` account, partitions x tile width x capacity x mirror
byte width the demand-bytes model.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from ..kernels.ref import pdx_prune_scan_multi_ref

__all__ = ["tile_widths", "fused_tile_counts"]


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
