"""Distributed PDXearch over a mesh — counterpart of
``repro.dist.pdx_sharded``, in SPMD form on ``torch.distributed``: every
rank calls these functions with the same arguments, scans its own slice of
a ``Placement`` (``repro_torch.dist.placement``) and returns the same,
replicated answer.

* ``search_block_sharded`` — partitions stripe over the ``data`` axis (a
  ``block`` placement): each rank runs the masked PDXearch
  (``core.pdxearch``, the ``jit-masked`` executor's scan) on its slice,
  then the per-rank top-k dists and ids cross in two all-gathers and
  merge.  Exact for exact pruners.
* ``search_dim_sharded`` — dimension slabs shard over the ``model`` axis
  while the tiles replicate: each rank sums its contiguous D-slab of every
  tile (contiguous in the PDX layout), one psum completes the (P, C)
  distances, one top-k finishes.
* ``search_batch_block_sharded`` — the batched search: each rank scans its
  slice of a (B, D) batch — the f32 matmul scan, or at a reduced
  ``scan_dtype`` its slice of the arranged mirror through the batched
  distance kernel (K2 on the card) and an exact f32 re-rank against its
  master slice — then ONE all-gather per batch carries the (B, k) dists
  packed with the ids reinterpreted as f32 (bit-exact).

Every collective goes through ``repro_torch.dist.all_gather``/``psum``,
which count it; ``repro_torch.obs.meters.collective_counts`` reads them.
"""
from __future__ import annotations

import torch

from ..core.pdxearch import _masked_scan, make_boundaries, search_batch_matmul
from ..core.pruners import Pruner, make_plain_pruner
from ..core.topk import TopK, rerank_positions, topk_init, topk_merge
from . import all_gather, axis_rank, axis_size, mesh_device, psum
from .placement import Placement

__all__ = [
    "pad_partitions_to_shards",
    "search_block_sharded",
    "search_dim_sharded",
    "search_batch_block_sharded",
    "collective_counts",
]

# search_dim_sharded broadcasts at most this many values at a time
_SLAB_CHUNK_VALUES = 1 << 26


def pad_partitions_to_shards(
    data: torch.Tensor, ids: torch.Tensor, n_shards: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """Round the partition axis up to a multiple of ``n_shards`` with empty
    (all-``PAD_VALUE``, ids ``-1``) tiles.  A thin wrapper: padding is
    ``Placement.block``'s; this keeps the array-in/array-out form."""
    pl = Placement.block(data, ids, n_shards)
    return pl.data, pl.ids


def _require(**named) -> None:
    """The query and k are always required (data/ids are optional when a
    prebuilt ``placement=`` is given)."""
    for name, val in named.items():
        if val is None:
            raise TypeError(f"missing required argument: {name!r}")


def _block_placement(mesh, data, ids, axis: str, placement) -> Placement:
    """The placement of a block-sharded executor: raw (data, ids) striped
    and padded here, or a prebuilt (cached, ``core.plan``) placement."""
    n = axis_size(mesh, axis)
    if placement is None:
        return Placement.block(data, ids, n, axis=axis)
    if placement.n_shards != n:
        raise ValueError(
            f"placement built for {placement.n_shards} shards, mesh axis "
            f"'{axis}' has {n}"
        )
    return placement


def _local(mesh, pl: Placement, axis: str):
    dev = mesh_device(mesh)
    d_sh, i_sh = pl.local(axis_rank(mesh, axis))
    return d_sh.to(dev), i_sh.to(dev), dev


def _gather_packed(res: TopK, mesh, axis: str, k: int) -> TopK:
    """ONE all-gather of the (B, 2k) [dists | ids as f32] rows, then the
    merge of every rank's candidates in rank order."""
    B = res.dists.shape[0]
    packed = torch.cat([res.dists, res.ids.to(torch.int32).view(torch.float32)],
                       dim=1)                                         # (B, 2k)
    allp = all_gather(packed, mesh, axis)                             # (n*B, 2k)
    allp = allp.reshape(-1, B, 2 * k).permute(1, 0, 2)                # (B, n, 2k)
    all_d = allp[:, :, :k].reshape(B, -1)
    all_i = allp[:, :, k:].contiguous().view(torch.int32).reshape(B, -1)
    return topk_merge(topk_init(k, (B,), all_d.device), all_d, all_i)


def search_block_sharded(
    mesh,
    data: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
    q: torch.Tensor | None = None,
    k: int | None = None,
    *,
    metric: str = "l2",
    pruner: Pruner | None = None,
    schedule: str = "adaptive",
    delta_d: int = 32,
    axis: str = "data",
    placement: Placement | None = None,
    stats=None,
) -> TopK:
    """Partition-sharded masked PDXearch of one (D,) query; returns the
    replicated top-k.  With a ``SearchStats`` in ``stats`` each rank counts
    the values it computed, one psum totals them, and the totals land in
    ``stats``."""
    _require(q=q, k=k)
    pruner = pruner or make_plain_pruner()
    pl = _block_placement(mesh, data, ids, axis, placement)
    d_sh, i_sh, dev = _local(mesh, pl, axis)
    D = pl.data.shape[1]
    bounds = make_boundaries(D, schedule, delta_d)
    qt = pruner.transform_query(torch.as_tensor(q, dtype=torch.float32).to(dev))
    perm = (
        pruner.dim_order(qt) if pruner.dim_order is not None
        else torch.arange(D, device=dev)
    )
    with_stats = stats is not None
    res, computed = _masked_scan(d_sh, i_sh, qt, perm, k, metric, bounds,
                                 pruner.keep_mask, with_stats)
    if with_stats:
        computed = psum(computed.reshape(1), mesh, axis)
    all_d = all_gather(res.dists, mesh, axis)
    all_i = all_gather(res.ids, mesh, axis)
    merged = topk_merge(topk_init(k, device=dev), all_d, all_i)
    if with_stats:
        total = float(torch.sum(pl.ids >= 0)) * D
        computed = float(computed[0])
        stats.values_total += total
        stats.values_computed += computed
        stats.values_avoided += total - computed
        stats.partitions_visited += pl.num_slots
    return merged


def search_dim_sharded(
    mesh,
    data: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
    q: torch.Tensor | None = None,
    k: int | None = None,
    *,
    metric: str = "l2",
    axis: str = "model",
    placement: Placement | None = None,
) -> TopK:
    """Dimension-sharded exact search of one (already transformed) query:
    the tiles replicate, rank r sums D-slab r of every tile, one psum
    completes the distances and one top-k over all candidates finishes."""
    _require(q=q, k=k)
    n = axis_size(mesh, axis)
    if placement is None:
        placement = Placement.replicated(data, ids, n, axis=axis)
    data, ids = placement.data, placement.ids
    P, D, C = data.shape
    if D % n:
        raise ValueError(f"D={D} not divisible over {n} '{axis}' shards")
    dev = mesh_device(mesh)
    w = D // n
    lo = axis_rank(mesh, axis) * w
    qs = torch.as_tensor(q, dtype=torch.float32).to(dev)[lo:lo + w]
    step = max(1, _SLAB_CHUNK_VALUES // (w * C))
    part = torch.cat([
        _slab_block(data[p:p + step, lo:lo + w, :].to(dev), qs, metric)
        for p in range(0, P, step)
    ])                                                            # (P, C)
    full = psum(part, mesh, axis)
    return topk_merge(topk_init(k, device=dev), full.reshape(-1),
                      ids.to(dev).reshape(-1))


def _slab_block(t: torch.Tensor, qs: torch.Tensor, metric: str) -> torch.Tensor:
    """(p, w, C) tile slabs, (w,) query slab -> (p, C):
    ``core.distance.pdx_distance``'s arithmetic for every tile at once."""
    if metric == "l2":
        diff = t - qs[None, :, None]
        return torch.sum(diff * diff, dim=1)
    if metric == "l1":
        return torch.sum(torch.abs(t - qs[None, :, None]), dim=1)
    return -torch.sum(t * qs[None, :, None], dim=1)


def search_batch_block_sharded(
    mesh,
    data: torch.Tensor | None = None,
    ids: torch.Tensor | None = None,
    Q: torch.Tensor | None = None,
    k: int | None = None,
    *,
    metric: str = "l2",
    axis: str = "data",
    placement: Placement | None = None,
    mirror=None,
    rerank_mult: int = 4,
) -> TopK:
    """Batched block-sharded search of a (B, D) batch (already transformed);
    returns the replicated (B, k) top-k after ONE all-gather per batch.

    With a reduced-precision ``mirror`` (``core.layout.DeviceMirror``) each
    rank scans its slice of the arranged mirror through the batched
    distance kernel and re-ranks its top ``rerank_mult * k`` exactly
    against its f32 master slice before the collective.  The wire stays
    f32: the merge decides the global k-boundary, and a rounded wire would
    swap cross-rank near-ties there and round the distances returned."""
    _require(Q=Q, k=k)
    pl = _block_placement(mesh, data, ids, axis, placement)
    if Q.ndim != 2:
        raise ValueError(f"Q must be (B, D), got shape {tuple(Q.shape)}")
    d_sh, i_sh, dev = _local(mesh, pl, axis)
    Qd = Q.to(device=dev, dtype=torch.float32)
    if mirror is None or mirror.dtype == "f32":
        res = search_batch_matmul(d_sh, i_sh, Qd, k, metric)
        return _gather_packed(res, mesh, axis, k)

    from ..core.plan import _tile_scan

    qtiles = pl.arranged_mirror(mirror)
    rk = min(max(rerank_mult * k, k), qtiles.shape[0] * qtiles.shape[2])
    qd_sh = qtiles[pl.slots(axis_rank(mesh, axis))].to(dev)
    W, _, C = qd_sh.shape
    pos = torch.arange(W * C, dtype=torch.int32, device=dev).reshape(W, C)
    pos = torch.where(i_sh >= 0, pos, -1)
    cand = _tile_scan(
        qd_sh, pos, Qd, mirror.scale.to(dev) if mirror.quantized else None,
        mirror.offset.to(dev) if mirror.quantized else None, rk, metric,
        mirror.packed, mirror.dim,
    )
    res = rerank_positions(d_sh, i_sh, Qd, cand, k, metric)
    return _gather_packed(res, mesh, axis, k)


# the collective meter lives in ``repro_torch.obs.meters``; re-exported
# here, where the reference's tests and benches import it from
from ..obs.meters import collective_counts  # noqa: E402,F401
