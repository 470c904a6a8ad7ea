"""IVF index over PDX-resident buckets (paper Figure 2: buckets ≡ blocks).

Counterpart of ``repro.index.ivf`` with flat routing: centroids are stored
in PDX layout and ranked by one dimension-major scan (optionally over a
quantized centroid mirror, ``route_dtype``).  The two-level centroid tree
is not ported yet; ``build_ivf`` refuses it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.layout import (
    PDXStore,
    build_bucketed_store,
    build_flat_store,
    device_mirror,
)
from ..kernels.ref import dequantize_ref
from ..obs import metrics as _metrics
from .kmeans import kmeans

__all__ = ["IVFIndex", "build_ivf", "TREE_AUTO_NLIST"]

#: ``build_ivf(tree="auto")`` would switch to the two-level centroid tree at
#: this nlist (the reference's threshold); the port has no tree yet.
TREE_AUTO_NLIST = 4096

TREE_NOT_PORTED = (
    "the two-level IVF centroid tree (build_centroid_tree/attach_tree) is "
    "not ported to repro_torch yet: ROADMAP.md, modules queue, 'IVF tree'"
)


def _rank_centroids(cdata: torch.Tensor, q: torch.Tensor, nlist: int, metric: str):
    """One dimension-major scan of ALL (Pc, D, C) centroid tiles ->
    ascending bucket order (stable, like ``jnp.argsort``)."""
    if metric == "l2":
        diff = cdata - q[None, :, None]
        d = torch.sum(diff * diff, dim=1)
    elif metric == "l1":
        d = torch.sum(torch.abs(cdata - q[None, :, None]), dim=1)
    else:
        d = -torch.sum(cdata * q[None, :, None], dim=1)
    return torch.argsort(d.reshape(-1)[:nlist], stable=True)


@dataclasses.dataclass
class IVFIndex:
    store: PDXStore                 # bucket-contiguous PDX partitions
    centroid_store: PDXStore        # centroids, PDX layout (for bucket ranking)
    centroids: torch.Tensor         # (K, D) horizontal copy
    part_offsets: np.ndarray        # (K,) first partition id of each bucket
    part_counts: np.ndarray         # (K,) partitions per bucket
    nlist: int

    def _ranked_batch(self, Q: torch.Tensor, metric: str, dtype: str) -> torch.Tensor:
        """(B, D) queries -> (B, nlist) ascending bucket orders, scanning the
        centroid tiles at ``dtype`` width."""
        if dtype == "f32":
            cdata = self.centroid_store.data
            bpv = 4.0
        else:
            m = device_mirror(self.centroid_store, dtype)
            cdata = dequantize_ref(
                m.data, m.scale if m.quantized else None,
                m.offset if m.quantized else None, dim_axis=1,
                packed=m.packed, dim=m.dim,
            )
            bpv = m.bytes_per_value
        order = torch.stack([_rank_centroids(cdata, q, self.nlist, metric) for q in Q])
        if _metrics.enabled():
            Pc, Dc, Cc = self.centroid_store.data.shape
            _metrics.counter(
                "repro_device_bytes_total",
                float(Q.shape[0]) * Pc * Dc * Cc * bpv,
                executor="route", component="scan", dtype=dtype,
            )
        return order

    def rank_buckets(
        self, q: torch.Tensor, metric: str = "l2", dtype: str = "f32"
    ) -> np.ndarray:
        """Distance of q to every centroid -> bucket ids sorted ascending."""
        q = torch.as_tensor(q, dtype=torch.float32, device=self.centroids.device)
        return self._ranked_batch(q[None], metric, dtype)[0].cpu().numpy()

    def assign(self, X) -> np.ndarray:
        """(N, D) rows -> (N,) bucket assignments (nearest centroid, L2)."""
        X = torch.atleast_2d(torch.as_tensor(X, dtype=torch.float32,
                                             device=self.centroids.device))
        cross = X @ self.centroids.T
        cn = torch.sum(self.centroids * self.centroids, dim=1)
        return torch.argmin(cn[None, :] - 2.0 * cross, dim=1).to(torch.int32).cpu().numpy()

    def partition_order(self, bucket_order: np.ndarray, nprobe: int) -> np.ndarray:
        sel = bucket_order[:nprobe]
        parts = [
            np.arange(
                self.part_offsets[b], self.part_offsets[b] + self.part_counts[b]
            )
            for b in sel
            if b >= 0
        ]
        return np.concatenate(parts) if parts else np.zeros(0, np.int64)

    def route_batch(
        self, Qt: torch.Tensor, nprobe: int, metric: str = "l2",
        dtype: str = "f32",
    ) -> np.ndarray:
        """Rank buckets for a (B, D) batch of (already pruner-transformed)
        queries -> (B, min(nprobe, nlist)) bucket ids, best first."""
        Qt = torch.atleast_2d(torch.as_tensor(Qt, dtype=torch.float32,
                                              device=self.centroids.device))
        order = self._ranked_batch(Qt, metric, dtype)
        return order[:, : min(nprobe, self.nlist)].cpu().numpy()

    def route(
        self, qt: torch.Tensor, nprobe: int, metric: str = "l2",
        dtype: str = "f32",
    ) -> tuple[np.ndarray, int]:
        """Rank buckets by centroid distance of the (already pruner-
        transformed) query -> ``(partition visit order, start_parts)``:
        START scans every partition of the nearest non-empty bucket."""
        border = self.rank_buckets(qt, metric, dtype)
        order = self.partition_order(border, nprobe)
        start_parts = 0
        for b in border[:nprobe]:
            if b >= 0 and self.part_counts[b] > 0:
                start_parts = int(self.part_counts[b])
                break
        return order, start_parts


def build_ivf(
    X: np.ndarray,
    nlist: int,
    *,
    capacity: int = 1024,
    kmeans_iters: int = 10,
    seed: int = 0,
    precomputed: Optional[tuple[np.ndarray, np.ndarray]] = None,
    tree: bool | str = "auto",
    device=None,
) -> IVFIndex:
    """Train k-means on ``device`` (or take precomputed (centroids,
    assignments) so competitors share identical buckets, as the paper does)
    and pack buckets into PDX partitions on ``device`` (None: the CUDA
    card, raising without one)."""
    if tree is True or (tree == "auto" and nlist >= TREE_AUTO_NLIST):
        raise NotImplementedError(TREE_NOT_PORTED)
    device = resolve_device(device)
    X = np.asarray(X, np.float32)
    if precomputed is not None:
        centroids, assignments = precomputed
    else:
        centroids, assignments = kmeans(
            torch.from_numpy(X).to(device), nlist, iters=kmeans_iters, seed=seed
        )
    store, offsets, nparts = build_bucketed_store(
        X, assignments, nlist, capacity, device=device
    )
    centroids = np.ascontiguousarray(centroids, np.float32)
    return IVFIndex(
        store=store,
        centroid_store=build_flat_store(
            centroids, capacity=min(1024, max(64, nlist)), device=device
        ),
        centroids=torch.from_numpy(centroids).to(device),
        part_offsets=offsets,
        part_counts=nparts,
        nlist=nlist,
    )
