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
           (K,), ``nlist`` — present only for an IVF engine; with a
           two-level centroid tree also ``super_centroids`` (SK, D),
           ``super_children`` (SK, M) and ``nprobe_super``
  mutable  the keys of ``mutable_store_arrays`` — present only when the
           engine's store is a ``MutablePDXStore``; the store keys are then
           its host masters, and the IVF bucket boundaries come from it

``mutable_store_arrays`` reads a ``MutablePDXStore``'s whole state — of
this package or of the reference, whose store keeps the same fields — as
NumPy arrays, and ``mutable_store_from_arrays`` builds the port's store
from them, so both packages can start from one churned state.

``lm_params_from_arrays`` carries an LM's weights across: the reference's
params pytree as NumPy arrays (``jax.tree.map(np.asarray, params)``) in,
the port's params on ``device`` holding the same numbers out.  Both keep
weights (in, out) and multiply ``x @ w``, so nothing is transposed.  This
is the only place weights cross between the packages: the reference's
``jax.random`` init cannot be reproduced in torch.  ``opt_state_from_arrays``
carries the optimizer state beside them: the reference's AdamW (``mu``,
``nu``, ``step``) or Adafactor (``vr``, ``vc``, ``v``, ``step``) state as
NumPy arrays in, the port's on ``device`` out.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .core.engine import PRUNERS, VectorSearchEngine
from .core.layout import MutablePDXStore, PDXStore, build_flat_store
from .core.pruners import (
    make_adsampling,
    make_bond,
    make_bond_decreasing,
    make_bsa,
    make_plain_pruner,
)
from .core.spec import SearchSpec
from .index.ivf import IVFIndex
from .models.lm import build_model

__all__ = ["engine_from_arrays", "lm_params_from_arrays", "mutable_store_arrays",
           "mutable_store_from_arrays", "opt_state_from_arrays"]

# MutablePDXStore state: public attributes, then private ones (``_`` + key)
_PUBLIC_FIELDS = ("head_capacity", "num_buckets", "meta_staleness", "version",
                  "tiles_version")
_PRIVATE_FIELDS = ("data", "ids", "counts", "dim_means", "dim_vars",
                   "head_data", "head_ids", "head_assign", "head_n",
                   "part_bucket", "next_id", "sum", "sumsq", "n_live",
                   "mutations_since_meta")


def mutable_store_arrays(store) -> dict:
    """A ``MutablePDXStore``'s state as NumPy arrays and Python scalars:
    the host masters (``data``, ``ids``, ``counts``, ``dim_means``,
    ``dim_vars``), the write-head, the bucket of each partition, the next
    id, the running moments and both versions."""
    out = {k: getattr(store, k) for k in _PUBLIC_FIELDS}
    out.update({k: np.array(getattr(store, "_" + k), copy=True)
                for k in _PRIVATE_FIELDS})
    return out


def mutable_store_from_arrays(arrays: dict, *, device) -> MutablePDXStore:
    """The port's ``MutablePDXStore`` on ``device`` holding exactly the
    state of ``mutable_store_arrays``."""
    nb = arrays["num_buckets"]
    store = MutablePDXStore(
        arrays["data"], arrays["ids"], arrays["counts"], arrays["dim_means"],
        arrays["dim_vars"], head_capacity=int(arrays["head_capacity"]),
        num_buckets=None if nb is None else int(nb),
        part_bucket=arrays["part_bucket"],
        meta_staleness=float(arrays["meta_staleness"]), device=device,
    )
    store._head_data = np.array(arrays["head_data"], np.float32)
    store._head_ids = np.array(arrays["head_ids"], np.int32)
    store._head_assign = np.array(arrays["head_assign"], np.int32)
    store._head_n = int(arrays["head_n"])
    store._id_loc.update(
        (int(i), ("h", int(j)))
        for j, i in enumerate(store._head_ids.tolist()) if i >= 0
    )
    store._next_id = int(arrays["next_id"])
    store._sum = np.array(arrays["sum"], np.float64)
    store._sumsq = np.array(arrays["sumsq"], np.float64)
    store._n_live = int(arrays["n_live"])
    store._mutations_since_meta = int(arrays["mutations_since_meta"])
    store.version = int(arrays["version"])
    store.tiles_version = int(arrays["tiles_version"])
    return store


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

    if "head_ids" in arrays:
        store = mutable_store_from_arrays(arrays, device=dev)
    else:
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
            part_offsets=(store.part_offsets if isinstance(store, MutablePDXStore)
                          else np.asarray(arrays["part_offsets"])),
            part_counts=(store.part_counts if isinstance(store, MutablePDXStore)
                         else np.asarray(arrays["part_counts"])),
            nlist=nlist,
        )
        if arrays.get("super_centroids") is not None:
            ivf.super_centroids = t("super_centroids", np.float32)
            ivf.super_children = t("super_children", np.int32)
            ivf.nprobe_super = int(arrays["nprobe_super"])
    return VectorSearchEngine(
        store=store, pruner=_pruner(arrays, store.dim, dev),
        spec=spec if spec is not None else SearchSpec(), ivf=ivf,
        zone_size=int(arrays.get("zone_size", 0)),
    )


def _tensor(a, dev) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: exact through f32
        return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dev)


def lm_params_from_arrays(cfg, arrays: dict, device=None) -> dict:
    """The port's LM params on ``device`` (``None`` means the CUDA card)
    holding exactly the reference's numbers.  ``arrays`` is the nested
    params dict: ``embed`` (V, d), ``final_norm``, ``lm_head`` when the
    embeddings are untied, ``enc_final_norm`` for an encoder-decoder,
    ``stack{i}`` -> ``sub{j}`` -> the sub-block's leaves (``norm``, ``wq``,
    ..., ``router``, ``w_dkv``, ``in_proj``, ...) with a leading unit axis.
    Keys and shapes are checked against the params ``build_model(cfg)``
    draws; a missing, extra or misshapen array raises.  Each leaf keeps
    its array's dtype, so a bf16 model's f32 leaves (``router_bias``,
    ``A_log``, ``dt_bias``, ``D``) stay f32."""
    dev = resolve_device(device)
    want = build_model(cfg).param_shapes()

    def convert(a, w, path):
        if isinstance(w, dict):
            if not isinstance(a, dict) or set(a) != set(w):
                got = sorted(a) if isinstance(a, dict) else type(a).__name__
                raise ValueError(f"{path or 'params'}: keys {got}, the model's are {sorted(w)}")
            return {k: convert(a[k], w[k], f"{path}.{k}".lstrip(".")) for k in w}
        if tuple(np.shape(a)) != w:
            raise ValueError(f"{path}: shape {tuple(np.shape(a))}, the model's is {w}")
        return _tensor(a, dev)

    return convert(arrays, want, "")


_OPT_KEYS = ({"mu", "nu", "step"}, {"vr", "vc", "v", "step"})


def opt_state_from_arrays(arrays: dict, device=None) -> dict:
    """The port's optimizer state on ``device`` (``None`` means the CUDA
    card) holding exactly the reference's numbers: ``arrays`` is the
    reference's state as NumPy (``jax.tree.map(np.asarray, state)``), AdamW's
    ``{mu, nu, step}`` or Adafactor's ``{vr, vc, v, step}``, the moments
    nested like the params.  ``step`` becomes a 0-d int32 tensor."""
    dev = resolve_device(device)
    if set(arrays) not in _OPT_KEYS:
        raise ValueError(f"optimizer state keys {sorted(arrays)}: expected AdamW's "
                         f"{sorted(_OPT_KEYS[0])} or Adafactor's {sorted(_OPT_KEYS[1])}")

    def convert(a):
        if isinstance(a, dict):
            return {k: convert(v) for k, v in a.items()}
        return _tensor(a, dev)

    out = {k: convert(v) for k, v in arrays.items() if k != "step"}
    out["step"] = torch.tensor(int(np.asarray(arrays["step"])), dtype=torch.int32, device=dev)
    return out
