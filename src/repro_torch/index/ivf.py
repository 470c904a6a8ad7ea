"""IVF index over PDX-resident buckets (paper Figure 2: buckets ≡ blocks).

Counterpart of ``repro.index.ivf``: centroids are stored in PDX layout and
ranked by one dimension-major scan (optionally over a quantized centroid
mirror, ``route_dtype``), or, with the two-level centroid tree attached
(``attach_tree``; ``build_ivf(tree=True)``, or ``tree="auto"`` at nlist >=
``TREE_AUTO_NLIST``), by ranking the super-centroids and then only the
children of the best ``nprobe_super`` of them.  Tree orders carry -1
right-pads, which every consumer skips.

Over a mutable store, inserted rows go to buckets by ``assign`` (nearest
centroid) and a flush fills free slots inside the bucket's partitions; a
repack moves bucket boundaries, and the engine refreshes
``part_offsets``/``part_counts`` from the store after every mutation
(``VectorSearchEngine._sync_ivf``), so routing and START see them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.distance import nary_distance
from ..core.layout import (
    DeviceMirror,
    PDXStore,
    build_bucketed_store,
    build_flat_store,
    device_mirror,
)
from ..kernels.ref import dequantize_ref
from ..obs import metrics as _metrics
from .kmeans import build_centroid_tree, kmeans

__all__ = ["IVFIndex", "build_ivf", "TREE_AUTO_NLIST"]

#: ``build_ivf(tree="auto")`` switches the flat centroid scan to the
#: two-level tree at this nlist.
TREE_AUTO_NLIST = 4096


# The batched ranking materialises a (Bc, Pc, D, C) difference block; Bc is
# the largest chunk whose block stays under this many values, capped at
# _ROUTE_CHUNK_MAX rows.
_ROUTE_BLOCK_VALUES = 1 << 26
_ROUTE_CHUNK_MAX = 16


def _route_chunk(cdata: torch.Tensor) -> int:
    """Rows per ranking chunk: set by the centroid tiles alone, never by the
    batch, so every call reduces blocks of one shape."""
    per_query = cdata.shape[0] * cdata.shape[1] * cdata.shape[2]
    return max(1, min(_ROUTE_CHUNK_MAX, _ROUTE_BLOCK_VALUES // per_query))


def _rank_centroids_batch(
    cdata: torch.Tensor, Q: torch.Tensor, nlist: int, metric: str
) -> torch.Tensor:
    """One dimension-major scan of ALL (Pc, D, C) centroid tiles for a
    (B, D) batch -> (B, nlist) ascending bucket orders (stable, like
    ``jnp.argsort``), ``pdx_distance``'s arithmetic per tile.

    The batch runs in chunks of ``_route_chunk(cdata)`` rows, the last
    padded with zero rows: the sum over D then has one shape whatever B
    is, so a reduction whose strategy follows the shape (CUDA's) rounds a
    query's distances the same alone as inside a batch, and ``route`` (B =
    1) agrees with ``route_batch`` bit for bit."""
    bc = _route_chunk(cdata)
    B = Q.shape[0]
    out = []
    for lo in range(0, B, bc):
        Qc = Q[lo:lo + bc]
        if Qc.shape[0] < bc:
            Qc = torch.cat([Qc, Qc.new_zeros((bc - Qc.shape[0], Q.shape[1]))])
        qb = Qc[:, None, :, None]                                 # (Bc,1,D,1)
        if metric == "l2":
            diff = cdata[None] - qb
            d = torch.sum(diff * diff, dim=2)
        elif metric == "l1":
            d = torch.sum(torch.abs(cdata[None] - qb), dim=2)
        else:
            d = -torch.sum(cdata[None] * qb, dim=2)
        d = d.reshape(bc, -1)[: min(bc, B - lo), :nlist]
        out.append(torch.argsort(d, dim=1, stable=True))
    return torch.cat(out)


def _rank_centroids(cdata: torch.Tensor, q: torch.Tensor, nlist: int, metric: str):
    """``_rank_centroids_batch`` for one (D,) query -> (nlist,) order (the
    reference's name; ``rank_buckets`` and ``route`` take the same B = 1
    path through ``IVFIndex._ranked_batch``)."""
    return _rank_centroids_batch(cdata, q[None], nlist, metric)[0]


def _rank_centroids_batch_mirror(
    m: DeviceMirror, Q: torch.Tensor, nlist: int, metric: str,
    cache: dict,
) -> torch.Tensor:
    """Quantized-mirror bucket ranking: the mirror's tiles dequantized to
    f32 once per mirror, then ``_rank_centroids_batch``'s exact arithmetic
    on them.  ``cache`` holds one f32 copy per dtype beside the mirror it
    came from; ``device_mirror`` hands out a new mirror for a new
    ``tiles_version`` (or a rebuilt centroid store), which replaces it."""
    got = cache.get(m.dtype)
    if got is None or got[0] is not m:
        t32 = dequantize_ref(
            m.data, m.scale if m.quantized else None,
            m.offset if m.quantized else None, dim_axis=1,
            packed=m.packed, dim=m.dim,
        )
        got = cache[m.dtype] = (m, t32)
    return _rank_centroids_batch(got[1], Q, nlist, metric)


def _rank_centroids_tree(
    centroids: torch.Tensor,   # (K, D) horizontal f32
    supers: torch.Tensor,      # (SK, D) super-centroids
    children: torch.Tensor,    # (SK, M) int32 child lists, -1 right-pad
    Q: torch.Tensor,           # (B, D)
    nlist: int,
    metric: str,
    nprobe_super: int,
) -> torch.Tensor:
    """Two-level bucket ranking: rank SK super-centroids, keep the best
    ``nprobe_super``, then rank only *their* children.  Visits
    ``SK + nprobe_super * M`` centroids per query instead of nlist.

    Returns (B, nlist) int32 bucket orders, best first, right-padded with
    -1.  Both selections are stable ascending sorts: the reference's
    ``lax.top_k`` puts the lower index first among equal values, and its
    ``argsort`` is stable."""
    out = torch.full((Q.shape[0], nlist), -1, dtype=torch.int32, device=Q.device)
    for b, q in enumerate(Q):
        ds = nary_distance(supers, q, metric)                     # (SK,)
        top = torch.sort(ds, stable=True).indices[:nprobe_super]  # best supers
        cand = children[top].reshape(-1)                          # (nps*M,)
        valid = cand >= 0
        dc = nary_distance(centroids[torch.where(valid, cand, 0).long()], q, metric)
        dc = torch.where(valid, dc, float("inf"))                 # pads last
        dsort, order = torch.sort(dc, stable=True)
        ranked = torch.where(torch.isfinite(dsort), cand[order], -1)
        # children partition [0, nlist): ranked holds <= nlist valid ids,
        # and the sort packs them first, so truncation only drops pads
        n = min(int(ranked.shape[0]), nlist)
        out[b, :n] = ranked[:n].to(torch.int32)
    return out


def _nearest_centroid(centroids: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(K, D), (N, D) -> (N,) nearest-centroid bucket per row (L2, matching
    the k-means training objective); the centroid assignment on insert."""
    cross = X @ centroids.T                          # (N, K)
    cn = torch.sum(centroids * centroids, dim=1)     # (K,)
    return torch.argmin(cn[None, :] - 2.0 * cross, dim=1).to(torch.int32)


@dataclasses.dataclass
class IVFIndex:
    store: PDXStore                 # bucket-contiguous PDX partitions
    centroid_store: PDXStore        # centroids, PDX layout (for bucket ranking)
    centroids: torch.Tensor         # (K, D) horizontal copy
    part_offsets: np.ndarray        # (K,) first partition id of each bucket
    part_counts: np.ndarray         # (K,) partitions per bucket
    nlist: int
    # Two-level routing tree (None -> flat scan): (SK, D) super-centroids,
    # the (SK, M) -1-padded child table of ``kmeans.build_centroid_tree``,
    # and how many supers a query descends into.
    super_centroids: Optional[torch.Tensor] = None
    super_children: Optional[torch.Tensor] = None
    nprobe_super: int = 0
    # per route dtype: (centroid mirror, its f32 dequantization), kept by
    # ``_rank_centroids_batch_mirror``
    _route_f32: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def tree_enabled(self) -> bool:
        return self.super_centroids is not None

    def routing_cost(self) -> int:
        """Centroids ranked per query: nlist for the flat scan, the
        sub-linear ``SK + nprobe_super * M`` bound for the tree."""
        if not self.tree_enabled:
            return self.nlist
        SK, M = self.super_children.shape
        return int(SK + self.nprobe_super * M)

    def attach_tree(
        self,
        super_k: Optional[int] = None,
        nprobe_super: Optional[int] = None,
        *,
        seed: int = 0,
    ) -> None:
        """(Re)build the two-level tree over the CURRENT centroids, on their
        device — also the recalibration hook: after BSA re-projects the
        centroids the tree is re-clustered in the rotated space."""
        if super_k is None:
            super_k = max(2, int(np.ceil(np.sqrt(self.nlist))))
        dev = self.centroids.device
        sc, children = build_centroid_tree(
            self.centroids.cpu().numpy(), super_k, seed=seed, device=dev
        )
        self.super_centroids = torch.from_numpy(sc).to(dev)
        self.super_children = torch.from_numpy(children).to(dev)
        if nprobe_super is None:
            nprobe_super = max(2, sc.shape[0] // 4)
        self.nprobe_super = int(min(max(nprobe_super, 1), sc.shape[0]))

    def _ranked_batch(self, Q: torch.Tensor, metric: str, dtype: str) -> torch.Tensor:
        """(B, D) queries -> (B, nlist) ascending bucket orders, scanning the
        centroid tiles at ``dtype`` width.  With a tree attached the orders
        come from the two-level descent over f32 centroids (whatever
        ``dtype``) and carry -1 right-pads."""
        if self.tree_enabled:
            order = _rank_centroids_tree(
                self.centroids, self.super_centroids, self.super_children,
                Q, self.nlist, metric, self.nprobe_super,
            )
            if _metrics.enabled():
                _metrics.counter(
                    "repro_device_bytes_total",
                    float(Q.shape[0]) * self.routing_cost()
                    * self.centroids.shape[1] * 4.0,
                    executor="route", component="scan", dtype="f32",
                )
            return order
        if dtype == "f32":
            order = _rank_centroids_batch(
                self.centroid_store.data, Q, self.nlist, metric
            )
            bpv = 4.0
        else:
            m = device_mirror(self.centroid_store, dtype)
            order = _rank_centroids_batch_mirror(
                m, Q, self.nlist, metric, self._route_f32
            )
            bpv = m.bytes_per_value
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
        return _nearest_centroid(self.centroids, X).cpu().numpy()

    def partition_order(self, bucket_order: np.ndarray, nprobe: int) -> np.ndarray:
        sel = bucket_order[:nprobe]
        parts = [
            np.arange(
                self.part_offsets[b], self.part_offsets[b] + self.part_counts[b]
            )
            for b in sel
            if b >= 0  # tree orders right-pad with -1
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

    def search(
        self,
        q,
        k: int,
        pruner,
        *,
        nprobe: int = 8,
        metric: str = "l2",
        schedule: str = "adaptive",
        delta_d: int = 32,
        sel_frac: float = 0.2,
        group: int = 8,
        stats=None,
    ):
        """Compatibility wrapper around ``route`` + ``pdxearch`` -> a
        ``TopK``.  Engine code goes through ``core.plan``, which calls
        ``route`` and owns the executor choice; this stays for direct index
        users."""
        from ..core.pdxearch import pdxearch

        q = torch.as_tensor(q, dtype=torch.float32).to(self.store.device)
        qt = pruner.transform_query(q)
        order, start_parts = self.route(qt, nprobe, metric)
        return pdxearch(
            self.store, q, k, pruner, metric=metric, schedule=schedule,
            delta_d=delta_d, sel_frac=sel_frac, group=group,
            pid_order=order, start_parts=start_parts, stats=stats,
        )


def build_ivf(
    X: np.ndarray,
    nlist: int,
    *,
    capacity: int = 1024,
    kmeans_iters: int = 10,
    seed: int = 0,
    precomputed: Optional[tuple[np.ndarray, np.ndarray]] = None,
    tree: bool | str = "auto",
    super_k: Optional[int] = None,
    nprobe_super: Optional[int] = None,
    device=None,
) -> IVFIndex:
    """Train k-means on ``device`` (or take precomputed (centroids,
    assignments) so competitors share identical buckets, as the paper does)
    and pack buckets into PDX partitions on ``device`` (None: the CUDA
    card, raising without one).

    ``tree``: ``True`` builds the two-level centroid tree, ``False`` keeps
    the flat scan, ``"auto"`` builds it once nlist reaches
    ``TREE_AUTO_NLIST``.  ``super_k`` defaults to ~sqrt(nlist),
    ``nprobe_super`` to super_k // 4."""
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
    ivf = IVFIndex(
        store=store,
        centroid_store=build_flat_store(
            centroids, capacity=min(1024, max(64, nlist)), device=device
        ),
        centroids=torch.from_numpy(centroids).to(device),
        part_offsets=offsets,
        part_counts=nparts,
        nlist=nlist,
    )
    if tree is True or (tree == "auto" and nlist >= TREE_AUTO_NLIST):
        ivf.attach_tree(super_k, nprobe_super, seed=seed)
    return ivf
