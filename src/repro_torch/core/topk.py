"""Fixed-size top-k candidate sets and the exact-f32 re-rank.

Counterpart of ``repro.core.topk``.  State is a sorted-ascending
``(..., k)`` pair of (distances, ids); leading dimensions batch queries.

Selection is a **stable** ascending sort, then a slice.  The reference
selects with ``jax.lax.top_k``, which puts the lower index first among
equal values; ``torch.topk`` does not promise any order among ties.  The
order matters where many entries tie at ``+inf``: the fused scan feeds
every dead lane with ``+inf``, and when fewer than ``rk`` lanes survive,
which tied entries fill the list decides what ``rerank_positions``
re-ranks.  A stable sort over ``[state, candidates]`` reproduces
``lax.top_k`` exactly, and merging candidate batches one after another is
the same as one stable selection over their concatenation.
"""
from __future__ import annotations

import dataclasses

import torch

__all__ = [
    "TopK", "topk_init", "topk_merge", "topk_from_batch", "topk_threshold",
    "rerank_positions",
]

INF = float("inf")


@dataclasses.dataclass
class TopK:
    dists: torch.Tensor  # (..., k) ascending
    ids: torch.Tensor    # (..., k) int32, -1 = empty slot


def topk_init(k: int, batch: tuple = (), device="cpu") -> TopK:
    return TopK(
        dists=torch.full(batch + (k,), INF, dtype=torch.float32, device=device),
        ids=torch.full(batch + (k,), -1, dtype=torch.int32, device=device),
    )


def topk_merge(state: TopK, cand_dists: torch.Tensor, cand_ids: torch.Tensor) -> TopK:
    """Merge a (..., m) candidate batch into the (..., k) state.  Candidates
    with id < 0 are padding and count as +inf.  ``cand_ids`` may omit the
    leading batch dimensions (one id row shared by every query)."""
    k = state.dists.shape[-1]
    cand_dists = torch.where(cand_ids < 0, INF, cand_dists)
    cand_ids = cand_ids.expand(cand_dists.shape)
    all_d = torch.cat([state.dists, cand_dists.to(torch.float32)], dim=-1)
    all_i = torch.cat([state.ids, cand_ids.to(torch.int32)], dim=-1)
    d, idx = torch.sort(all_d, dim=-1, stable=True)
    return TopK(dists=d[..., :k], ids=torch.gather(all_i, -1, idx[..., :k]))


def topk_from_batch(cand_dists: torch.Tensor, cand_ids: torch.Tensor, k: int) -> TopK:
    batch = tuple(cand_dists.shape[:-1])
    return topk_merge(topk_init(k, batch, cand_dists.device), cand_dists, cand_ids)


def topk_threshold(state: TopK) -> torch.Tensor:
    """Pruning threshold: worst distance currently in the candidate set."""
    return state.dists[..., -1]


def rerank_positions(
    master: torch.Tensor,
    ids: torch.Tensor,
    Q: torch.Tensor,
    cand: TopK,
    k: int,
    metric: str = "l2",
) -> TopK:
    """Exact f32 re-rank: ``cand.ids`` are (B, rk) flat tile positions
    (-1 = pad) into the (P, D, C) ``master`` tiles; gather those columns,
    recompute their distances to the (B, D) queries, and keep the best
    ``k`` as global ids from the (P, C) ``ids`` array."""
    C = master.shape[2]
    safe = torch.clamp(cand.ids, min=0).long()                 # (B, rk)
    vecs = master[safe // C, :, safe % C]                      # (B, rk, D)
    if metric == "l2":
        diff = vecs - Q[:, None, :]
        d = torch.sum(diff * diff, dim=2)
    elif metric == "l1":
        d = torch.sum(torch.abs(vecs - Q[:, None, :]), dim=2)
    else:
        d = -torch.sum(vecs * Q[:, None, :], dim=2)
    d = torch.where(cand.ids >= 0, d, INF)
    gids = torch.where(cand.ids >= 0, ids.reshape(-1)[safe], -1)
    return topk_from_batch(d, gids, k)
