"""Distance functions on horizontal (N-ary) and PDX layouts — plain torch.

Counterpart of ``repro.core.distance``: the same contracts, eager PyTorch
instead of jitted jnp.  Each function runs on the device of its inputs.

Conventions:
  * horizontal data: ``X   (N, D)``  — one row per vector
  * PDX data:        ``T   (D, V)``  — one row per dimension (a partition tile)
  * metrics return *uncorrected* values (squared L2; IP negated so that all
    metrics minimize).
"""
from __future__ import annotations

import torch

__all__ = [
    "METRICS",
    "nary_distance",
    "pdx_distance",
    "pdx_accumulate",
    "pdx_partial",
    "batched_distance_matmul",
]

METRICS = ("l2", "ip", "l1")


def _check_metric(metric: str) -> None:
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")


def nary_distance(X: torch.Tensor, q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """(N, D), (D,) -> (N,). Reduction runs along each row (per-vector)."""
    _check_metric(metric)
    if metric == "l2":
        diff = X - q[None, :]
        return torch.sum(diff * diff, dim=1)
    if metric == "l1":
        return torch.sum(torch.abs(X - q[None, :]), dim=1)
    return -torch.sum(X * q[None, :], dim=1)


def pdx_distance(T: torch.Tensor, q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """(D, V), (D,) -> (V,). Accumulation runs across dimensions; each value
    of the output vector lives in its own lane (no horizontal reduce)."""
    _check_metric(metric)
    if metric == "l2":
        diff = T - q[:, None]
        return torch.sum(diff * diff, dim=0)
    if metric == "l1":
        return torch.sum(torch.abs(T - q[:, None]), dim=0)
    return -torch.sum(T * q[:, None], dim=0)


def pdx_accumulate(
    T_slice: torch.Tensor, q_slice: torch.Tensor, acc: torch.Tensor,
    metric: str = "l2",
) -> torch.Tensor:
    """Partial-distance accumulation over a dimension slice:
    (d, V), (d,), (V,) -> (V,) — the inner step of PDXearch."""
    _check_metric(metric)
    if metric == "l2":
        diff = T_slice - q_slice[:, None]
        return acc + torch.sum(diff * diff, dim=0)
    if metric == "l1":
        return acc + torch.sum(torch.abs(T_slice - q_slice[:, None]), dim=0)
    return acc - torch.sum(T_slice * q_slice[:, None], dim=0)


def pdx_partial(
    T: torch.Tensor, q: torch.Tensor, d0: int, d1: int, acc: torch.Tensor,
    metric: str = "l2",
) -> torch.Tensor:
    """Accumulate dimensions [d0, d1) of tile T into acc."""
    return pdx_accumulate(T[d0:d1], q[d0:d1], acc, metric)


def batched_distance_matmul(
    T: torch.Tensor, Q: torch.Tensor, metric: str = "l2"
) -> torch.Tensor:
    """(D, V), (B, D) -> (B, V).  ``||q||^2 - 2 q.x + ||x||^2`` for l2 (one
    matmul over the K-major PDX tile), ``-q.x`` for ip; l1 has no matmul
    form and runs one ``pdx_distance`` per query."""
    if metric == "l1":
        return torch.stack([pdx_distance(T, q, "l1") for q in Q])
    cross = Q @ T
    if metric == "ip":
        return -cross
    qn = torch.sum(Q * Q, dim=1, keepdim=True)
    xn = torch.sum(T * T, dim=0, keepdim=True)
    return qn - 2.0 * cross + xn
