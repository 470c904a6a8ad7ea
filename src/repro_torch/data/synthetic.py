"""Synthetic vector collections matching the paper's dataset taxonomy
(Section 2.2): *normal* (DEEP/GloVe/Contriever-like) vs *skewed*
(SIFT/GIST/MSong/OpenAI-like), plus *clustered* mixtures so IVF has real
structure to find.  Also exact ground-truth KNN and recall@k.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_dataset", "ground_truth", "recall_at_k", "DATASET_KINDS"]

DATASET_KINDS = ("normal", "skewed", "clustered")


def make_dataset(
    n: int,
    dim: int,
    kind: str = "normal",
    *,
    n_queries: int = 16,
    n_clusters: int = 64,
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (X (n, dim), Q (n_queries, dim)) float32.

    normal    — i.i.d. standard normal dims (hard to prune; paper Table 2).
    skewed    — per-dimension gamma with varying scale (easy to prune).
    clustered — mixture of Gaussians (IVF-friendly), mildly anisotropic.
    """
    rng = np.random.default_rng(seed)
    if kind == "normal":
        X = rng.standard_normal((n, dim))
        Q = rng.standard_normal((n_queries, dim))
    elif kind == "skewed":
        shape = rng.uniform(0.5, 2.0, size=dim)
        scale = rng.uniform(0.2, 5.0, size=dim)
        X = rng.gamma(shape[None, :], scale[None, :], size=(n, dim))
        Q = rng.gamma(shape[None, :], scale[None, :], size=(n_queries, dim))
    elif kind == "clustered":
        centers = rng.standard_normal((n_clusters, dim)) * 4.0
        widths = rng.uniform(0.3, 1.2, size=(n_clusters, 1))
        ca = rng.integers(0, n_clusters, size=n)
        X = centers[ca] + rng.standard_normal((n, dim)) * widths[ca]
        qa = rng.integers(0, n_clusters, size=n_queries)
        Q = centers[qa] + rng.standard_normal((n_queries, dim)) * widths[qa]
    else:
        raise ValueError(f"kind must be one of {DATASET_KINDS}")
    return X.astype(np.float32), Q.astype(np.float32)


def ground_truth(
    X: np.ndarray, Q: np.ndarray, k: int, metric: str = "l2", chunk: int = 65536
) -> tuple[np.ndarray, np.ndarray]:
    """Exact top-k by brute force (numpy, chunked): (B, k) ids and dists."""
    B = Q.shape[0]
    ids = np.zeros((B, k), np.int64)
    ds = np.zeros((B, k), np.float32)
    for qi in range(B):
        q = Q[qi]
        best_d = None
        best_i = None
        for lo in range(0, len(X), chunk):
            xc = X[lo : lo + chunk]
            if metric == "l2":
                d = ((xc - q[None, :]) ** 2).sum(1)
            elif metric == "l1":
                d = np.abs(xc - q[None, :]).sum(1)
            else:
                d = -(xc @ q)
            idx = np.argpartition(d, min(k, len(d) - 1))[:k]
            cd, ci = d[idx], idx + lo
            if best_d is None:
                best_d, best_i = cd, ci
            else:
                alld = np.concatenate([best_d, cd])
                alli = np.concatenate([best_i, ci])
                sel = np.argpartition(alld, k - 1)[:k]
                best_d, best_i = alld[sel], alli[sel]
        order = np.argsort(best_d, kind="stable")
        ids[qi], ds[qi] = best_i[order], best_d[order]
    return ids, ds


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray) -> float:
    """Mean |found ∩ true| / k over queries (paper Section 2.1)."""
    found_ids = np.atleast_2d(found_ids)
    true_ids = np.atleast_2d(true_ids)
    k = true_ids.shape[1]
    hits = 0
    for f, t in zip(found_ids, true_ids):
        hits += len(set(f.tolist()) & set(t.tolist()))
    return hits / (len(true_ids) * k)
