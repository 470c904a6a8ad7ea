"""PDXearch — the paper's three-phase dimension-by-dimension pruned search.

Counterpart of ``repro.core.pdxearch`` (the ``adaptive`` executor and the
batched exact scan; the shape-static masked ``pdxearch_jit`` is not ported
yet).

* ``pdxearch`` (host-orchestrated): START linear-scans the first
  partition(s) to seed the top-k threshold; WARMUP streams dimension slices
  in exponentially growing steps, evaluating the pruning predicate on *all*
  vectors of a partition group; once the surviving fraction drops below
  ``sel_frac`` (paper: 20%), PRUNE compacts survivor columns (capacity
  rounded up by 4x steps) and finishes only those.

* ``search_batch_matmul``: exact scan of a (B, D) query batch — the PDX
  tile is already K-major, so the distance matrix is one matmul per tile.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .distance import batched_distance_matmul, pdx_distance
from .layout import PDXStore
from .pruners import Pruner
from .topk import TopK, topk_init, topk_merge, topk_threshold

__all__ = [
    "SearchStats",
    "make_boundaries",
    "pdxearch",
    "search_batch_matmul",
]

_INF = float("inf")


@dataclasses.dataclass
class SearchStats:
    """Work accounting for the paper's pruning-power metric (Tables 2/6)."""

    values_total: float = 0.0     # D * vectors visited
    values_computed: float = 0.0  # dimension values actually used in DCOs
    values_avoided: float = 0.0   # paper's pruning power numerator
    partitions_visited: int = 0
    prune_phase_entries: int = 0

    @property
    def pruning_power(self) -> float:
        if self.values_total == 0:
            return 0.0
        return self.values_avoided / self.values_total

    @property
    def computed_fraction(self) -> float:
        if self.values_total == 0:
            return 1.0
        return self.values_computed / self.values_total


def make_boundaries(
    dim: int, schedule: str = "adaptive", delta_d: int = 32, start: int = 2
) -> tuple[int, ...]:
    """Cumulative dimension boundaries at which the predicate is evaluated.

    adaptive (the paper's fix for fixed-step tail latency): 2, 6, 14, 30,
    62, ... doubling steps.
    fixed (ADSampling/BSA original): delta_d, 2*delta_d, ...
    """
    bounds: list[int] = []
    if schedule == "adaptive":
        b, step = 0, start
        while b < dim:
            b = min(b + step, dim)
            bounds.append(b)
            step *= 2
    elif schedule == "fixed":
        b = 0
        while b < dim:
            b = min(b + delta_d, dim)
            bounds.append(b)
    else:
        raise ValueError(f"unknown schedule {schedule!r}")
    return tuple(bounds)


def _accum_gdc(block: torch.Tensor, qd: torch.Tensor, metric: str) -> torch.Tensor:
    """(G, d, C), (d,) -> (G, C) partial-distance contribution."""
    if metric == "l2":
        diff = block - qd[None, :, None]
        return torch.sum(diff * diff, dim=1)
    if metric == "l1":
        return torch.sum(torch.abs(block - qd[None, :, None]), dim=1)
    return -torch.sum(block * qd[None, :, None], dim=1)


def _accum_rows(block: torch.Tensor, qd: torch.Tensor, metric: str) -> torch.Tensor:
    """(cap, d), (d,) -> (cap,)."""
    if metric == "l2":
        diff = block - qd[None, :]
        return torch.sum(diff * diff, dim=1)
    if metric == "l1":
        return torch.sum(torch.abs(block - qd[None, :]), dim=1)
    return -torch.sum(block * qd[None, :], dim=1)


def _start_scan_metric(data, pids, q, metric):
    """START phase: full linear scan of the seed partitions -> (S, C)."""
    tiles = data[pids]
    if metric == "l2":
        diff = tiles - q[None, :, None]
        return torch.sum(diff * diff, dim=1)
    return torch.stack([pdx_distance(t, q, metric) for t in tiles])


def _pow2_at_least(x: int, lo: int = 64) -> int:
    c = lo
    while c < x:
        c *= 4
    return c


def _compact(alive, acc, gids, cap):
    """Survivor positions of a (G, C) group, padded to ``cap``."""
    flat_alive = alive.reshape(-1)
    n = flat_alive.shape[0]
    idx = torch.nonzero(flat_alive).reshape(-1)
    idx = torch.cat([idx, torch.full((cap - idx.shape[0],), n, device=idx.device,
                                     dtype=idx.dtype)])
    valid = idx < n
    idx = torch.clamp(idx, max=n - 1)
    return (
        idx,
        valid,
        acc.reshape(-1)[idx],
        torch.where(valid, gids.reshape(-1)[idx], -1),
    )


def pdxearch(
    store: PDXStore,
    q: torch.Tensor,
    k: int,
    pruner: Pruner,
    *,
    metric: str = "l2",
    schedule: str = "adaptive",
    delta_d: int = 32,
    sel_frac: float = 0.2,
    group: int = 8,
    pid_order: Optional[np.ndarray] = None,
    start_parts: int = 1,
    stats: Optional[SearchStats] = None,
) -> TopK:
    """Search ``store`` for the top-k nearest neighbours of ``q``.

    ``pid_order`` — partition visit order (e.g. IVF bucket ranking); defaults
    to sequential.  The first ``start_parts`` partitions form the START phase.
    """
    if metric == "ip" and not pruner.name == "linear":
        raise ValueError("pruned PDXearch requires a monotone metric (l2/l1)")
    D, C = store.dim, store.capacity
    dev = store.device
    qt = pruner.transform_query(q.to(device=dev, dtype=torch.float32))
    perm = pruner.dim_order(qt) if pruner.dim_order is not None else None
    qp = qt[perm] if perm is not None else qt
    bounds = make_boundaries(D, schedule, delta_d)

    if pid_order is None:
        pid_order = np.arange(store.num_partitions)
    pid_order = np.asarray(pid_order)
    counts = store.counts.cpu().numpy()

    state = topk_init(k, device=dev)

    # -- PHASE 0: START -----------------------------------------------------
    start_pids = torch.as_tensor(pid_order[:start_parts], device=dev, dtype=torch.int64)
    d0 = _start_scan_metric(store.data, start_pids, qt, metric)
    state = topk_merge(state, d0.reshape(-1), store.ids[start_pids].reshape(-1))
    if stats is not None:
        nvalid = float(counts[pid_order[:start_parts]].sum())
        stats.values_total += nvalid * D
        stats.values_computed += nvalid * D
        stats.partitions_visited += start_parts

    dims_all = perm if perm is not None else torch.arange(D, device=dev)

    # -- WARMUP / PRUNE over remaining partitions, in groups ----------------
    rest = pid_order[start_parts:]
    for lo in range(0, len(rest), group):
        pids_np = rest[lo: lo + group]
        pids = torch.as_tensor(pids_np, device=dev, dtype=torch.int64)
        G = len(pids_np)
        thr = topk_threshold(state)
        acc = torch.zeros((G, C), dtype=torch.float32, device=dev)
        gids = store.ids[pids]
        alive = gids >= 0
        n_valid = float(counts[pids_np].sum())
        if stats is not None:
            stats.values_total += n_valid * D
            stats.partitions_visited += G

        prev = 0
        cand_d = cand_i = None
        prev_alive = int(alive.sum())
        for b in bounds:
            dims = dims_all[prev:b]
            block = store.data[pids[:, None], dims[None, :], :]       # (G, d, C)
            acc = acc + _accum_gdc(block, qp[prev:b], metric)
            alive = alive & pruner.keep_mask(acc, b, thr)
            n_alive = int(alive.sum())
            if stats is not None:
                stats.values_computed += prev_alive * (b - prev)
                stats.values_avoided += (prev_alive - n_alive) * (D - b)
            prev_alive = n_alive
            prev = b
            if b < D and n_alive <= sel_frac * max(n_valid, 1.0):
                # ---- PHASE 2: PRUNE — compact survivors, finish them ------
                cap = _pow2_at_least(max(n_alive, 1))
                idx, valid, acc_c, ids_c = _compact(alive, acc, gids, cap)
                p_sel = pids[idx // C]
                c_sel = idx % C
                alive_c = valid
                if stats is not None:
                    stats.prune_phase_entries += 1
                pa = n_alive
                for b2 in bounds:
                    if b2 <= prev:
                        continue
                    dims = dims_all[prev:b2]
                    block = store.data[p_sel[:, None], dims[None, :], c_sel[:, None]]
                    acc_c = acc_c + _accum_rows(block, qp[prev:b2], metric)
                    alive_c = alive_c & pruner.keep_mask(acc_c, b2, thr)
                    if stats is not None:
                        na = int(alive_c.sum())
                        stats.values_computed += pa * (b2 - prev)
                        stats.values_avoided += (pa - na) * (D - b2)
                        pa = na
                    prev = b2
                cand_d = torch.where(alive_c, acc_c, _INF)
                cand_i = ids_c
                break
        if cand_d is None:  # finished WARMUP without entering PRUNE
            cand_d = torch.where(alive, acc, _INF).reshape(-1)
            cand_i = gids.reshape(-1)
        state = topk_merge(state, cand_d, cand_i)
    return state


def search_batch_matmul(
    data: torch.Tensor, ids: torch.Tensor, Q: torch.Tensor, k: int,
    metric: str = "l2",
) -> TopK:
    """Exact linear scan for a (B, D) query batch over (P, D, C) PDX tiles,
    merged tile by tile (the stable merge keeps the reference's tie order)."""
    state = topk_init(k, (Q.shape[0],), Q.device)
    for tile, tids in zip(data, ids):
        state = topk_merge(state, batched_distance_matmul(tile, Q, metric), tids)
    return state
