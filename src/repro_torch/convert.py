"""Carry an engine's state across from NumPy arrays.

``engine_from_arrays`` builds a port engine from another engine's state —
in practice the JAX reference's, exported as NumPy arrays — so the two can
be held to each other on identical stores, pruners and IVF buckets, with
no k-means or rotation of the port's own in between.  Keys:

  store    ``data`` (P, D, C) f32, ``ids`` (P, C) int32, ``counts`` (P,),
           ``dim_means`` (D,), ``dim_vars`` (D,)
  pruner   ``pruner`` (name), ``eps0`` and ``rotation`` (D, D) for
           ADSampling; ``components`` (D, D), ``eigval`` (D,) and ``bsa_m``
           for BSA; ``zone_size`` for BOND (its means are ``dim_means``)
  IVF      ``centroids`` (K, D), ``part_offsets`` (K,), ``part_counts``
           (K,), ``nlist`` — present only for an IVF engine
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .core.engine import PRUNERS, VectorSearchEngine
from .core.layout import PDXStore, build_flat_store
from .core.pruners import (
    make_adsampling,
    make_bond,
    make_bond_decreasing,
    make_bsa,
    make_plain_pruner,
)
from .core.spec import SearchSpec
from .index.ivf import IVFIndex

__all__ = ["engine_from_arrays"]


def _pruner(arrays: dict, dim: int, device):
    name = str(arrays["pruner"])
    if name == "linear":
        return make_plain_pruner()
    if name == "adsampling":
        return make_adsampling(dim, eps0=float(arrays["eps0"]),
                               rotation=arrays["rotation"], device=device)
    if name == "bsa":
        return make_bsa(m=float(arrays["bsa_m"]), components=arrays["components"],
                        eigval=arrays["eigval"], device=device)
    if name == "bond":
        return make_bond(arrays["dim_means"], zone_size=int(arrays.get("zone_size", 0)),
                         device=device)
    if name == "bond-decreasing":
        return make_bond_decreasing(dim)
    raise ValueError(f"pruner must be one of {PRUNERS}, got {name!r}")


def engine_from_arrays(arrays: dict, *, device, spec: SearchSpec | None = None
                       ) -> VectorSearchEngine:
    """A port engine on ``device`` holding exactly the given state."""
    dev = resolve_device(device)

    def t(key, dtype):
        return torch.from_numpy(np.array(arrays[key], dtype)).to(dev)

    store = PDXStore(
        data=t("data", np.float32), ids=t("ids", np.int32),
        counts=t("counts", np.int32), dim_means=t("dim_means", np.float32),
        dim_vars=t("dim_vars", np.float32),
    )
    ivf = None
    if "centroids" in arrays:
        nlist = int(arrays["nlist"])
        centroids = np.array(arrays["centroids"], np.float32)
        ivf = IVFIndex(
            store=store,
            centroid_store=build_flat_store(
                centroids, capacity=min(1024, max(64, nlist)), device=dev
            ),
            centroids=torch.from_numpy(centroids).to(dev),
            part_offsets=np.asarray(arrays["part_offsets"]),
            part_counts=np.asarray(arrays["part_counts"]),
            nlist=nlist,
        )
    return VectorSearchEngine(
        store=store, pruner=_pruner(arrays, store.dim, dev),
        spec=spec if spec is not None else SearchSpec(), ivf=ivf,
        zone_size=int(arrays.get("zone_size", 0)),
    )
