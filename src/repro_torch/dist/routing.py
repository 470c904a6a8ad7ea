"""Bucket-routed distributed search: queries travel, tiles stay put.

Counterpart of ``repro.dist.routing``, in SPMD form on
``torch.distributed`` (``repro_torch.dist``): every rank calls these
functions with the same arguments, scans only its own slice of a
``bucket`` placement (``repro_torch.dist.placement``) and gets the same,
replicated answer.

With a ``bucket`` placement each rank *owns* a subset of the IVF buckets,
so a query only needs to visit the ranks owning its top-``nprobe``
buckets.  One batch flows through exactly two collectives:

1. **Route and exchange.**  The router (``IVFIndex.route_batch``) ranks
   buckets per query; ``plan_routing`` turns that into a host-side exchange
   plan (which query goes to which owner rank, deduplicated).  Ragged
   per-rank query lists are padded to a power-of-two *budget*, queries and
   their selected bucket ids are packed into one buffer (int32 bucket ids
   reinterpreted as float32), and one ``all_to_all`` delivers to each rank
   only the queries it owns buckets for.

2. **Masked local scan and hierarchical merge.**  Each rank scans only its
   owned buckets (its placement slice), masking each received query down
   to the buckets it selected, and keeps a rank-local top-k.  The per-rank
   (dists | ids as f32) candidate sets cross the mesh in one packed
   ``all_gather``, and each query's final top-k merges only the candidate
   blocks of the ranks it was routed to.

Wire cost per batch: ``n² · budget · (D + nprobe)`` floats in the
all-to-all plus ``n · n·budget · 2k`` floats in the all-gather
(``obs.meters.routed_batch_bytes``), against the broadcast path's
``n · B · D`` replicated queries and a whole-store scan on every rank.

* **Send-budget spill.**  Instead of padding every (src, dst) pair to the
  power-of-two ceiling of the *maximum* demand, ``plan_routing`` may split
  the exchange into two rounds ``(b1, b2)`` whenever ``b1 + b2`` moves
  fewer slots than one padded round.  Both rounds are slices of the same
  buffer, so the all-to-all count stays 1 or 2.

* **Quantized shard scan.**  With a reduced-precision device mirror
  (``spec.scan_dtype`` != "f32") each rank scans its arranged mirror slice
  through the batched distance kernel (K2 on the card,
  ``core.plan._tile_scan``) and re-ranks its local top ``rerank_mult·k``
  against its f32 master slice, so candidate distances are exact before
  they cross the mesh.  The wire stays f32 end to end: rounding queries in
  the all-to-all would make the re-rank exact relative to a perturbed
  query, and rounding candidate distances in the all-gather would swap
  cross-rank near-ties at the global k-boundary and hand rounded
  distances back to the caller.

``prepare_routed`` is the host half of a batch (plan, pack, bind, upload)
and ``launch_routed`` the device half (the collectives and the scan); a
bound launch caches nothing, since binding is cheap host work.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..core.distance import batched_distance_matmul
from ..core.topk import TopK, rerank_positions, topk_init, topk_merge
from ..obs import metrics as _metrics
from ..obs import trace as _trace
from . import all_gather, all_to_all, axis_rank, axis_size, mesh_device
from .placement import Placement

__all__ = [
    "RoutingPlan",
    "RoutedLaunch",
    "plan_routing",
    "build_send_buffer",
    "make_routed_fn",
    "prepare_routed",
    "launch_routed",
    "search_routed_bucket",
]

# Sentinel bucket id for unused send slots: must match NO slot_bucket entry
# (pad slots carry -1, so -1 would wrongly select them).
_EMPTY_SEL = -2

# the f32 shard scan reads at most this many tile values per matrix product
_SCAN_CHUNK_VALUES = 1 << 26


def _pow2_at_least(x: int, lo: int = 1) -> int:
    c = lo
    while c < x:
        c *= 2
    return c


@dataclasses.dataclass(frozen=True)
class RoutingPlan:
    """Host-side exchange plan for one query batch.

    ``send_slot[s, t, j]`` — global query index source rank ``s`` puts in
    slot ``j`` of its message to rank ``t`` (-1 = unused pad slot).
    ``dest_shard``/``dest_slot`` (B, max_dest) — where each query's
    candidate blocks land after the all-gather (-1 pads).  ``src_of`` (B,)
    — the source rank each query originates on (contiguous split of the
    batch, as a (B, D) batch splits over the axis).
    """

    send_slot: np.ndarray
    dest_shard: np.ndarray
    dest_slot: np.ndarray
    src_of: np.ndarray
    budget: int       # total slot count per (src, dst) = b1 + b2
    occupancy: int    # real (src, dst, slot) entries, for byte accounting
    round_budgets: tuple  # (b1, b2) all-to-all round widths; b2 == 0 means
                          # one round (balanced demand, no spill needed)


def plan_routing(
    sel: np.ndarray,
    bucket_shard: np.ndarray,
    bucket_parts: np.ndarray,
    n_shards: int,
) -> RoutingPlan:
    """Map each query's selected buckets onto owner ranks.

    ``sel`` (B, nprobe) — ranked bucket ids per query.  Empty buckets own no
    partitions and are skipped (routing a query to their owner would move
    bytes for zero scan work).  Budgets are powers of two so the exchange's
    shapes repeat across batches with similar routing pressure; when the
    max demand ``m`` fits in 3/4 of its pow2 ceiling, the exchange spills
    across TWO rounds ``(single/2, single/4)`` — 25% fewer padded slots
    than one round at the ceiling (e.g. demand 33 moves 48 slots per pair
    instead of 64)."""
    sel = np.asarray(sel)
    B = sel.shape[0]
    src_of = (np.arange(B, dtype=np.int64) * n_shards) // max(B, 1)
    # sel rows may carry -1 right-pads (two-level tree routing emits fewer
    # than nprobe buckets when the probed supers' children run short) —
    # drop them before the empty-bucket filter, which indexes bucket_parts
    dests = []
    for b in range(B):
        sb = sel[b][sel[b] >= 0]
        dests.append(np.unique(bucket_shard[sb[bucket_parts[sb] > 0]]))
    max_dest = min(sel.shape[1], n_shards)
    counts = np.zeros((n_shards, n_shards), np.int64)
    for b, ds in enumerate(dests):
        counts[src_of[b], ds] += 1
    m = max(int(counts.max(initial=0)), 1)
    single = _pow2_at_least(m)
    if single >= 4 and m <= 3 * single // 4:
        b1, b2 = single // 2, single // 4
    else:
        b1, b2 = single, 0
    budget = b1 + b2

    send_slot = np.full((n_shards, n_shards, budget), -1, np.int32)
    dest_shard = np.full((B, max_dest), -1, np.int32)
    dest_slot = np.full((B, max_dest), -1, np.int32)
    fill = np.zeros((n_shards, n_shards), np.int64)
    for b, ds in enumerate(dests):
        s = src_of[b]
        for j, t in enumerate(ds):
            slot = fill[s, t]
            fill[s, t] += 1
            send_slot[s, t, slot] = b
            dest_shard[b, j] = t
            dest_slot[b, j] = slot
    rp = RoutingPlan(
        send_slot=send_slot, dest_shard=dest_shard, dest_slot=dest_slot,
        src_of=src_of.astype(np.int32), budget=budget,
        occupancy=int(fill.sum()), round_budgets=(b1, b2),
    )
    if _metrics.enabled():
        # the histogram's log2 buckets are the demand octaves: each budget
        # shape serves one bucket
        _metrics.observe("repro_routing_demand", float(m))
        _metrics.counter(
            "repro_routing_spill_rounds_total", rounds=2 if b2 else 1
        )
        _metrics.gauge(
            "repro_routing_slot_occupancy",
            rp.occupancy / max(n_shards * n_shards * budget, 1),
        )
    return rp


def build_send_buffer(
    Q: np.ndarray, sel: np.ndarray, rp: RoutingPlan
) -> np.ndarray:
    """Pack (queries | selected-bucket ids reinterpreted as f32) into the
    one (n, n, budget, D + nprobe) float32 all-to-all payload, covering both
    exchange rounds (slots ``[:b1]`` travel in round 1, the spill in
    round 2)."""
    Q = np.asarray(Q, np.float32)
    sel = np.asarray(sel, np.int32)
    n = rp.send_slot.shape[0]
    D, nprobe = Q.shape[1], sel.shape[1]
    send_q = np.zeros((n, n, rp.budget, D), np.float32)
    send_sel = np.full((n, n, rp.budget, nprobe), _EMPTY_SEL, np.int32)
    occ = rp.send_slot >= 0
    send_q[occ] = Q[rp.send_slot[occ]]
    send_sel[occ] = sel[rp.send_slot[occ]]
    return np.concatenate([send_q, send_sel.view(np.float32)], axis=-1)


def _exchange(buf: torch.Tensor, mesh, axis: str, rounds: tuple) -> torch.Tensor:
    """The query exchange of this rank's (n, budget, W) messages: one
    all-to-all per non-empty round, slicing the buffer at ``b1``.
    Concatenating the received rounds along the slot axis gives exactly the
    single-round layout (the all-to-all permutes only the rank axis), so
    everything downstream is round-agnostic."""
    b1, b2 = rounds
    if not b2:
        return all_to_all(buf, mesh, axis)
    r1 = all_to_all(buf[:, :b1], mesh, axis)
    r2 = all_to_all(buf[:, b1:], mesh, axis)
    return torch.cat([r1, r2], dim=1)


def _masked_matmul_scan(data, ids, Q, allowed, k: int, metric: str) -> TopK:
    """The f32 shard scan: every (S, D, C) tile against the (B, D) queries
    as ``core.distance.batched_distance_matmul`` computes it, tiles taken
    in chunks of one matrix product each; a query's lanes in tiles it may
    not scan (``allowed`` (B, S) False) enter the merge at +inf, after the
    state's -1 pads, so they are never selected."""
    S, D, C = data.shape
    B = Q.shape[0]
    state = topk_init(k, (B,), Q.device)
    step = max(1, _SCAN_CHUNK_VALUES // (D * C))
    qn = torch.sum(Q * Q, dim=1, keepdim=True)                   # (B, 1)
    for lo in range(0, S, step):
        t = data[lo:lo + step]                                   # (s, D, C)
        if metric == "l1":  # no matmul form: one tile at a time
            dmat = torch.cat([batched_distance_matmul(tile, Q, metric)
                              for tile in t], dim=1)
        else:
            cross = torch.matmul(Q, t).permute(1, 0, 2).reshape(B, -1)
            if metric == "ip":
                dmat = -cross
            else:
                xn = torch.sum(t * t, dim=1).reshape(1, -1)      # (1, s*C)
                dmat = qn - 2.0 * cross + xn
        keep = allowed[:, lo:lo + step].repeat_interleave(C, dim=1)
        dmat = torch.where(keep, dmat, float("inf"))
        state = topk_merge(state, dmat, ids[lo:lo + step].reshape(-1))
    return state


def make_routed_fn(mesh, placement: Placement, rp: RoutingPlan, D: int,
                   nprobe: int, k: int, metric: str = "l2",
                   mirror=None, rerank_mult: int = 4) -> Callable:
    """Bind the routed executor to one (placement, routing plan) on this
    rank: this rank's (n, budget, D + nprobe) send buffer -> the replicated
    (B, k) TopK.

    One all-to-all per exchange round (two only when the plan spilled a
    skewed budget) plus ONE packed all-gather per call, whatever B and
    nprobe; ``obs.meters.collective_counts`` holds this in the tests.
    With ``mirror`` (a reduced-precision ``core.layout.DeviceMirror``) the
    rank scans its arranged mirror slice with the batched distance kernel
    and re-ranks locally against its f32 masters."""
    axis = placement.axis
    n = axis_size(mesh, axis)
    if placement.n_shards != n:
        raise ValueError(
            f"placement built for {placement.n_shards} shards, mesh axis "
            f"'{axis}' has {n}"
        )
    rank = axis_rank(mesh, axis)
    dev = mesh_device(mesh)
    quantized = mirror is not None and mirror.dtype != "f32"
    rk = min(max(rerank_mult * k, k),
             placement.num_slots * placement.data.shape[2]) if quantized else k
    sl = placement.slots(rank)
    d_sh, i_sh = (t.to(dev) for t in placement.local(rank))
    sb_sh = torch.from_numpy(
        np.asarray(placement.slot_bucket[sl], np.int32)).to(dev)
    dest_shard = torch.from_numpy(rp.dest_shard).to(dev)
    dest_slot = torch.from_numpy(rp.dest_slot).to(dev)
    src_of = torch.from_numpy(rp.src_of).to(dev)
    if quantized:
        qd_sh = placement.arranged_mirror(mirror)[sl].to(dev)
        sc = mirror.scale.to(dev) if mirror.quantized else None
        off = mirror.offset.to(dev) if mirror.quantized else None

    def local(buf: torch.Tensor) -> TopK:
        budget = buf.shape[1]
        B = dest_shard.shape[0]
        recv = _exchange(buf, mesh, axis, rp.round_budgets)
        Bl = n * budget  # received queries, flat index = src * budget + slot
        Qr = recv[..., :D].reshape(Bl, D)
        selr = recv[..., D:].contiguous().view(torch.int32).reshape(Bl, nprobe)
        # query q may scan local slot p iff p's bucket is one q selected
        allowed = (selr[:, :, None] == sb_sh[None, None, :]).any(dim=1)
        if not quantized:
            res = _masked_matmul_scan(d_sh, i_sh, Qr, allowed, k, metric)
        else:
            from ..core.plan import _tile_scan

            W, _, C = qd_sh.shape
            pos = torch.arange(W * C, dtype=torch.int32, device=dev).reshape(W, C)
            pos = torch.where(i_sh >= 0, pos, -1)
            cand = _tile_scan(qd_sh, pos, Qr, sc, off, rk, metric,
                              mirror.packed, mirror.dim, allowed=allowed)
            # exact f32 re-rank against the rank's MASTER slice: candidate
            # distances are exact before they cross the mesh
            res = rerank_positions(d_sh, i_sh, Qr, cand, k, metric)

        # the wire stays f32 even for quantized scans: the merge decides
        # the global k-boundary (module docstring)
        wire = torch.cat(
            [res.dists, res.ids.to(torch.int32).view(torch.float32)], dim=1
        )                                                        # (Bl, 2k)
        allp = all_gather(wire, mesh, axis).reshape(n, Bl, 2 * k)

        # hierarchical merge (replicated): per query, only the candidate
        # blocks of the ranks it was routed to
        pad = dest_shard < 0                                     # (B, md)
        t = torch.clamp(dest_shard, min=0).long()
        row = (src_of[:, None] * budget + torch.clamp(dest_slot, min=0)).long()
        cand = allp[t, row]                                      # (B, md, 2k)
        cd = torch.where(pad[:, :, None], float("inf"), cand[..., :k])
        ci = cand[..., k:].contiguous().view(torch.int32)
        ci = torch.where(pad[:, :, None], -1, ci)
        return topk_merge(topk_init(k, (B,), dev), cd.reshape(B, -1),
                          ci.reshape(B, -1))

    return local


@dataclasses.dataclass
class RoutedLaunch:
    """Host-side product of ``prepare_routed``: everything needed to fire
    the device half of one routed batch.  Splitting lets a serving loop
    overlap batch N+1's host work (``plan_routing``, send-buffer packing,
    binding) with batch N's device collectives."""

    fn: Callable         # bound routed executor: send buffer -> (B, k) TopK
    buf: torch.Tensor    # this rank's (n, budget, D + nprobe) send buffer
    rp: RoutingPlan
    n_shards: int
    D: int
    C: int
    num_slots: int
    nprobe: int
    k: int
    quantized: bool
    mirror_dtype: str
    mirror_bpv: float   # 0.5 for packed int4 — bytes, not whole bytes
    rerank_mult: int


def prepare_routed(
    mesh,
    placement: Placement,
    Q: torch.Tensor,
    sel: np.ndarray,
    k: int,
    *,
    metric: str = "l2",
    mirror=None,
    rerank_mult: int = 4,
) -> RoutedLaunch:
    """The HOST half of a routed batch search: exchange planning, send-
    buffer packing, binding, and the upload of this rank's messages.  No
    collective is issued here — ``launch_routed`` fires the exchange.

    ``Q`` (B, D) — pruner-transformed queries; ``sel`` (B, nprobe) — ranked
    bucket ids per query (``IVFIndex.route_batch``)."""
    if placement.kind != "bucket":
        raise ValueError(
            f"routed search needs a 'bucket' placement, got {placement.kind!r}"
        )
    Qnp = torch.as_tensor(Q, dtype=torch.float32).cpu().numpy()
    selnp = np.asarray(sel, np.int32)
    quantized = mirror is not None and mirror.dtype != "f32"
    with _trace.span("route", nprobe=selnp.shape[1],
                     n_shards=placement.n_shards):
        rp = plan_routing(
            selnp, placement.bucket_shard, placement.bucket_parts,
            placement.n_shards,
        )
        buf = build_send_buffer(Qnp, selnp, rp)
        fn = make_routed_fn(
            mesh, placement, rp, Qnp.shape[1], selnp.shape[1], k, metric,
            mirror=mirror if quantized else None, rerank_mult=rerank_mult,
        )
    mine = buf[axis_rank(mesh, placement.axis)]
    return RoutedLaunch(
        fn=fn, buf=torch.from_numpy(mine).to(mesh_device(mesh)), rp=rp,
        n_shards=placement.n_shards, D=Qnp.shape[1],
        C=placement.data.shape[2], num_slots=placement.num_slots,
        nprobe=selnp.shape[1], k=k, quantized=quantized,
        mirror_dtype=mirror.dtype if quantized else "f32",
        mirror_bpv=mirror.bytes_per_value if quantized else 4,
        rerank_mult=rerank_mult,
    )


def launch_routed(launch: RoutedLaunch) -> TopK:
    """The DEVICE half: issue the all-to-all exchange, the masked shard scan
    and the packed all-gather merge of a prepared batch; returns the
    replicated (B, k) TopK.  Also the metrics point — bytes and collectives
    are recorded when the exchange fires, not when it is planned."""
    if _metrics.enabled():
        from ..obs import meters as _meters

        rounds = 2 if launch.rp.round_budgets[1] else 1
        _meters.count_issued("routed_bucket", all_to_all=rounds, all_gather=1)
        comps = _meters.routed_batch_bytes(
            launch.rp, n_shards=launch.n_shards, D=launch.D,
            C=launch.C, num_slots=launch.num_slots,
            nprobe=launch.nprobe, k=launch.k,
            bytes_per_value=launch.mirror_bpv,
            rerank_mult=launch.rerank_mult, quantized=launch.quantized,
        )
        _meters.record_device_bytes(
            "routed_bucket", launch.mirror_dtype, comps
        )
    if launch.quantized:
        # the exact f32 re-rank runs on the rank, before the collective — a
        # zero-width span marks it in the trace
        with _trace.span("rerank", fused="on-shard",
                         rk=launch.rerank_mult * launch.k):
            pass
    return _trace.fence(launch.fn(launch.buf))


def search_routed_bucket(
    mesh,
    placement: Placement,
    Q: torch.Tensor,
    sel: np.ndarray,
    k: int,
    *,
    metric: str = "l2",
    mirror=None,
    rerank_mult: int = 4,
) -> TopK:
    """Routed batch search over a ``bucket`` placement — the synchronous
    composition ``launch_routed(prepare_routed(...))``.

    Exact over the union of each query's selected buckets: the masked scan
    computes full distances (never prunes), so with nprobe == nlist this
    equals the exact full scan.  With a reduced-precision ``mirror`` the
    rank scan streams mirror-width bytes; the on-shard f32 re-rank keeps
    the merged candidates exact, and the wire stays f32.  Returns a
    replicated (B, k) TopK."""
    return launch_routed(prepare_routed(
        mesh, placement, Q, sel, k, metric=metric, mirror=mirror,
        rerank_mult=rerank_mult,
    ))
