"""Lloyd's k-means — the IVF trainer — and the two-level centroid tree
built on it (counterpart of ``repro.index.kmeans``).

Runs on the device of the rows given as a tensor, or for a NumPy array on
``device`` (None: the CUDA card, raising without one).  The initial
centroids come from the same NumPy RNG draw as the reference, so seeds
match; chunked assignment keeps the (N, K) distance matrix out of memory.
Sums go through ``index_add_`` in PyTorch's deterministic mode (on CUDA a
sorted, fixed-order reduction instead of atomics), so one seed builds the
same index on every run; they round differently from JAX's
``segment_sum``, so the two packages agree on the seeds, not bit for bit
on the centroids.

``build_centroid_tree`` clusters the centroids themselves with that
k-means, then assigns children by the reference's greedy, balance-capped
rule in NumPy, line for line, so the same super-centroids give the same
child table.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["kmeans", "assign", "build_centroid_tree"]


def _rows(X, device) -> torch.Tensor:
    """A tensor stays where it is; NumPy rows go to ``device``."""
    if isinstance(X, torch.Tensor):
        return X.to(torch.float32)
    return torch.as_tensor(np.asarray(X, np.float32), device=resolve_device(device))


@contextlib.contextmanager
def _deterministic():
    """PyTorch's deterministic mode for the block, then the caller's mode."""
    mode = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(mode, warn_only=warn_only)


def assign(X, centroids, chunk: int = 16384, *, device=None) -> torch.Tensor:
    """Nearest-centroid assignment, (N,) int32 (first minimum on ties), on
    X's device (see the module note for NumPy rows)."""
    X = _rows(X, device)
    centroids = torch.as_tensor(centroids, device=X.device)
    n = X.shape[0]
    chunk = min(chunk, max(n, 1))
    cn = torch.sum(centroids * centroids, dim=1)
    out = torch.empty((n,), dtype=torch.int32, device=X.device)
    for lo in range(0, n, chunk):
        xc = X[lo:lo + chunk]
        d = (
            torch.sum(xc * xc, dim=1, keepdim=True)
            - 2.0 * (xc @ centroids.T)
            + cn[None, :]
        )
        out[lo:lo + chunk] = torch.argmin(d, dim=1).to(torch.int32)
    return out


def _update(X: torch.Tensor, a: torch.Tensor, centroids: torch.Tensor):
    k = centroids.shape[0]
    with _deterministic():  # atomics would make the index differ run to run
        sums = torch.zeros_like(centroids).index_add_(0, a.long(), X)
    cnts = torch.bincount(a.long(), minlength=k).to(torch.float32)
    new = sums / torch.clamp(cnts, min=1.0)[:, None]
    # Empty clusters keep their previous centroid (FAISS behaviour).
    return torch.where((cnts > 0)[:, None], new, centroids), cnts


def kmeans(
    X, k: int, iters: int = 10, seed: int = 0, chunk: int = 16384, *,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (centroids (K, D) float32, assignments (N,) int32) as NumPy,
    trained on X's device (see the module note for NumPy rows)."""
    X = _rows(X, device)
    n = X.shape[0]
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    rng = np.random.default_rng(seed)
    sel = torch.from_numpy(np.sort(rng.choice(n, size=k, replace=False)))
    centroids = X[sel.to(X.device)]
    for _ in range(iters):
        a = assign(X, centroids, chunk)
        centroids, _ = _update(X, a, centroids)
    a = assign(X, centroids, chunk)
    return centroids.cpu().numpy(), a.cpu().numpy()


def build_centroid_tree(
    centroids: np.ndarray,
    super_k: int,
    *,
    iters: int = 10,
    seed: int = 0,
    balance: float = 1.5,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """k-means over the centroids themselves (on ``device``, None: the CUDA
    card) -> a two-level routing tree.

    Returns ``(super_centroids (SK, D) float32, children (SK, M) int32)``
    where row ``s`` of ``children`` lists the centroid ids assigned to
    super-centroid ``s``, right-padded with -1 to the max child count M.
    The child lists partition ``[0, K)``, so ranking the top
    super-centroids and then only their children visits
    ``SK + nprobe_super * M`` centroids instead of K.

    ``balance`` caps each super at ``ceil(balance * K / SK)`` children:
    centroids are assigned greedily (closest-first) to their nearest
    super with room, so one runaway cluster cannot inflate M."""
    centroids = np.asarray(centroids, np.float32)
    K = centroids.shape[0]
    super_k = int(min(max(super_k, 1), K))
    sc, _ = kmeans(centroids, super_k, iters=iters, seed=seed, device=device)
    cap = max(int(np.ceil(balance * K / super_k)), 1)
    # (K, SK) distances; SK ~ sqrt(K), so this stays small even at 10^5.
    d2 = (
        np.sum(centroids * centroids, axis=1, keepdims=True)
        - 2.0 * centroids @ sc.T
        + np.sum(sc * sc, axis=1)[None, :]
    )
    pref = np.argsort(d2, axis=1)           # each centroid's super order
    order = np.argsort(d2.min(axis=1))      # closest-first claim order
    room = np.full(super_k, cap, np.int64)
    a = np.empty(K, np.int64)
    for cid in order:
        for s in pref[cid]:
            if room[s] > 0:
                a[cid] = s
                room[s] -= 1
                break
    counts = np.bincount(a, minlength=super_k)
    M = max(int(counts.max()), 1)
    children = np.full((super_k, M), -1, np.int32)
    fill = np.zeros(super_k, np.int64)
    for cid, s in enumerate(a):
        children[s, fill[s]] = cid
        fill[s] += 1
    return sc, children
