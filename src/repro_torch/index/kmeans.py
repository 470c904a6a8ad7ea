"""Lloyd's k-means — the IVF trainer (counterpart of
``repro.index.kmeans``; the centroid tree is not ported yet).

Runs on the device of the rows given as a tensor, or for a NumPy array on
``device`` (None: the CUDA card, raising without one).  The initial
centroids come from the same NumPy RNG draw as the reference, so seeds
match; chunked assignment keeps the (N, K) distance matrix out of memory.
Sums go through ``index_add_`` in PyTorch's deterministic mode (on CUDA a
sorted, fixed-order reduction instead of atomics), so one seed builds the
same index on every run; they round differently from JAX's
``segment_sum``, so the two packages agree on the seeds, not bit for bit
on the centroids.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..core.device import resolve_device

__all__ = ["kmeans", "assign"]


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
