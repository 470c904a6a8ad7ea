"""Dimension-pruning predicates hosted by PDXearch.

Counterpart of ``repro.core.pruners``.  Each pruner bundles:
  * ``preprocess``  — build-time transform of the collection (NumPy in,
    NumPy out, line for line the reference's, so both packages store the
    same vectors), e.g. ADSampling's random rotation, BSA's PCA.
  * ``transform_query`` / ``transform_batch`` — per-query preparation of a
    (D,) tensor / a (B, D) batch, on the pruner's device.
  * ``keep_mask(partial, d, thr)`` — the pruning predicate after ``d``
    dimensions (a Python int): True = vector still alive.
  * ``is_exact`` — whether pruning preserves exact top-k.

The transforms are built in NumPy exactly as the reference builds them,
then copied to ``device``.

References: ADSampling [Gao & Long, SIGMOD'23], BSA [Yang et al., 2024],
BOND [de Vries et al., SIGMOD'02].
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Callable, Optional

import numpy as np
import torch

from .device import resolve_device

__all__ = [
    "Pruner",
    "pruner_fingerprint",
    "make_plain_pruner",
    "make_adsampling",
    "make_bsa",
    "pca_components",
    "make_bond",
    "make_bond_decreasing",
    "random_orthogonal",
]


def pruner_fingerprint(name: str, *params) -> str:
    """Stable identity of a pruning predicate: name + hash of its parameters
    (recorded in the plan trace)."""
    h = hashlib.sha1()
    for p in params:
        if isinstance(p, (np.ndarray, torch.Tensor)):
            a = p.cpu().numpy() if isinstance(p, torch.Tensor) else p
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
        else:
            h.update(repr(p).encode())
    return f"{name}:{h.hexdigest()[:16]}"


_ANON_IDS = itertools.count()


def _identity(x):
    return x


@dataclasses.dataclass(frozen=True)
class Pruner:
    name: str
    is_exact: bool
    needs_preprocess: bool
    # (X (N, D) numpy) -> transformed X; build-time.
    preprocess: Callable[[np.ndarray], np.ndarray]
    # (q (D,) tensor) -> transformed q.
    transform_query: Callable[[torch.Tensor], torch.Tensor]
    # (partial (..., V) tensor, n_dims_seen int, thr tensor) -> keep mask.
    keep_mask: Callable[[torch.Tensor, int, torch.Tensor], torch.Tensor]
    # Optional query-aware dimension order: (q (D,)) -> permutation (D,).
    dim_order: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    fingerprint: str = ""
    # (Q (B, D) tensor) -> transformed batch; identity when not set.
    transform_batch: Callable[[torch.Tensor], torch.Tensor] = _identity
    # Factory parameters (eps0 for the fused scan, BSA's components).
    aux: Optional[dict] = dataclasses.field(
        default=None, compare=False, repr=False
    )

    def __post_init__(self):
        if not self.fingerprint:
            object.__setattr__(
                self, "fingerprint", f"{self.name}:anon{next(_ANON_IDS)}"
            )


def make_plain_pruner() -> Pruner:
    """No-op pruner: PDX linear scan (never prunes)."""
    return Pruner(
        name="linear",
        is_exact=True,
        needs_preprocess=False,
        preprocess=_identity,
        transform_query=_identity,
        keep_mask=lambda partial, d, thr: torch.ones_like(partial, dtype=torch.bool),
        fingerprint=pruner_fingerprint("linear"),
    )


# --------------------------------------------------------------------------
# ADSampling — random orthogonal projection + hypothesis-test pruning:
# prune v when  partial * D / d  >  thr * (1 + eps0 / sqrt(d))^2.
# --------------------------------------------------------------------------
def random_orthogonal(dim: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((dim, dim)).astype(np.float64)
    q, r = np.linalg.qr(a)
    q *= np.sign(np.diag(r))[None, :]  # fix signs -> Haar distributed
    return q.astype(np.float32)


def adsampling_bound_factors(dim: int, eps0: float, d: int) -> tuple[float, float]:
    """The test's f32 scalars after ``d`` dimensions: ``(dim / d, (1 +
    eps0 / sqrt(d))**2)``, each rounded as the reference rounds it (f32
    operands, true division and root).  Python floats holding exact f32
    values, so a product with an f32 tensor is a plain f32 product."""
    d32 = np.float32(max(d, 1))
    ratio = np.float32(dim) / d32
    s = np.float32(1.0) + np.float32(eps0) / np.sqrt(d32)
    return float(ratio), float(s * s)


def make_adsampling(dim: int, eps0: float = 2.1, seed: int = 0, *,
                    rotation: Optional[np.ndarray] = None,
                    device=None) -> Pruner:
    """``rotation`` overrides the seeded random orthogonal matrix (state
    carried over from another engine).  The rotation lives on ``device``
    (None: the CUDA card, raising without one)."""
    device = resolve_device(device)
    P = random_orthogonal(dim, seed) if rotation is None else np.asarray(
        rotation, np.float32)
    Pt = torch.from_numpy(P).to(device)
    Ptt = Pt.T.contiguous()

    def keep_mask(partial: torch.Tensor, d: int, thr: torch.Tensor) -> torch.Tensor:
        ratio, infl = adsampling_bound_factors(dim, eps0, d)
        return partial * ratio <= thr * infl

    fp = (pruner_fingerprint("adsampling", dim, eps0, seed) if rotation is None
          else pruner_fingerprint("adsampling", P, eps0))
    return Pruner(
        name="adsampling",
        is_exact=False,
        needs_preprocess=True,
        preprocess=lambda X: (np.asarray(X, np.float32) @ P.T),
        transform_query=lambda q: Pt @ q,
        transform_batch=lambda Q: Q @ Ptt,
        keep_mask=keep_mask,
        fingerprint=fp,
        aux={"eps0": eps0, "dim": dim, "seed": seed, "rotation": P},
    )


# --------------------------------------------------------------------------
# BSA — PCA projection + error-quantile pruning:
# prune when  partial + max(0, mu_res(d) - m * sigma_res(d))  >  thr.
# --------------------------------------------------------------------------
def pca_components(X_sample: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """PCA of a row sample -> ((D, D) orthonormal components as columns,
    ordered by decreasing eigenvalue; (D,) eigenvalues in that order)."""
    X_sample = np.asarray(X_sample, dtype=np.float32)
    mean = X_sample.mean(axis=0)
    cov = np.cov((X_sample - mean).T).astype(np.float64)
    if cov.ndim == 0:  # D == 1 degenerate
        cov = cov.reshape(1, 1)
    eigval, eigvec = np.linalg.eigh(cov)
    order = np.argsort(eigval)[::-1]
    components = eigvec[:, order].astype(np.float32)
    return components, eigval[order]


def make_bsa(X_sample: Optional[np.ndarray] = None, m: float = 3.0, seed: int = 0,
             *, components: Optional[np.ndarray] = None,
             eigval: Optional[np.ndarray] = None, device=None) -> Pruner:
    """From a row sample (PCA fitted here), or from fitted ``components``
    and ``eigval`` carried over from another engine; the projection lives
    on ``device`` (None: the CUDA card, raising without one)."""
    device = resolve_device(device)
    if components is None:
        X_sample = np.asarray(X_sample, dtype=np.float32)
        components, eigval = pca_components(X_sample)
    components = np.asarray(components, np.float32)
    dim = components.shape[0]
    lam = np.maximum(eigval, 0.0)
    tail = 2.0 * np.concatenate([np.cumsum(lam[::-1])[::-1], [0.0]])  # (D+1,)
    tail_var = 8.0 * np.concatenate([np.cumsum((lam**2)[::-1])[::-1], [0.0]])
    # the residual floor per cut d, in f32 as the reference computes it
    mu_res = torch.from_numpy(tail.astype(np.float32)).to(device)
    sigma_res = torch.from_numpy(np.sqrt(tail_var).astype(np.float32)).to(device)
    floor = torch.clamp(mu_res - m * sigma_res, min=0.0)
    Cj = torch.from_numpy(components).to(device)

    def keep_mask(partial: torch.Tensor, d: int, thr: torch.Tensor) -> torch.Tensor:
        d = min(max(int(d), 0), dim)
        return partial + floor[d] <= thr

    return Pruner(
        name="bsa",
        is_exact=False,
        needs_preprocess=True,
        preprocess=lambda X: (np.asarray(X, np.float32) @ components),
        transform_query=lambda q: q @ Cj,
        transform_batch=lambda Q: Q @ Cj,
        keep_mask=keep_mask,
        fingerprint=pruner_fingerprint("bsa", components, m),
        aux={"components": components, "eigval": np.asarray(eigval),
             "m": m, "seed": seed},
    )


# --------------------------------------------------------------------------
# PDX-BOND — the paper's own pruner.  No preprocessing; exact.  Visits
# dimensions by decreasing |q_d - mean_d|, optionally in contiguous zones.
# --------------------------------------------------------------------------
def make_bond(dim_means, zone_size: int = 0, *, device=None) -> Pruner:
    """The means live on ``device`` (None: the CUDA card, raising without
    one)."""
    device = resolve_device(device)
    means = torch.as_tensor(np.asarray(dim_means, np.float32)).to(device)
    dim = means.shape[0]

    def dim_order(q: torch.Tensor) -> torch.Tensor:
        score = torch.abs(q - means)
        if zone_size and zone_size > 1:
            nz = dim // zone_size
            zone_score = score[: nz * zone_size].reshape(nz, zone_size).sum(dim=1)
            zrank = torch.argsort(-zone_score, stable=True)
            base = zrank[:, None] * zone_size + torch.arange(zone_size, device=q.device)[None, :]
            perm = base.reshape(-1)
            if nz * zone_size < dim:  # leftover dims go last, in order
                perm = torch.cat(
                    [perm, torch.arange(nz * zone_size, dim, device=q.device)]
                )
            return perm.to(torch.int64)
        return torch.argsort(-score, stable=True)

    return Pruner(
        name="bond",
        is_exact=True,
        needs_preprocess=False,
        preprocess=_identity,
        transform_query=_identity,
        keep_mask=lambda partial, d, thr: partial <= thr,
        dim_order=dim_order,
        fingerprint=pruner_fingerprint("bond", means, zone_size),
        aux={"zone_size": zone_size},
    )


def make_bond_decreasing(dim: int) -> Pruner:
    """BOND's original 'decreasing query value' criterion."""

    def dim_order(q: torch.Tensor) -> torch.Tensor:
        return torch.argsort(-q, stable=True)

    return Pruner(
        name="bond-decreasing",
        is_exact=True,
        needs_preprocess=False,
        preprocess=_identity,
        transform_query=_identity,
        keep_mask=lambda partial, d, thr: partial <= thr,
        dim_order=dim_order,
        fingerprint=pruner_fingerprint("bond-decreasing", dim),
    )
