"""Declarative sharding rules: param / batch / decode-cache partition specs
(counterpart of ``repro.dist.sharding``).

The rules are name-based (the model zoo uses consistent leaf names across
architectures; the family table is in ``repro.dist``'s package docstring)
and every spec passes through the ``_divisible`` guard before it becomes a
``NamedSharding``, so the same rule set works on any mesh shape.

A spec is a ``PartitionSpec``: a tuple with one entry per tensor dim, each
``None`` (replicated), a mesh axis name, or a tuple of names (the dim
splits over several axes, major to minor).  A ``NamedSharding`` pairs a
spec with a ``DeviceMesh`` and gives its DTensor ``placements``: for each
mesh dim ``Shard(d)`` where entry ``d`` names that axis, else
``Replicate()``.  ``device_put`` puts a tree of tensors onto a tree of
shardings with ``distribute_tensor`` (the reference's ``jax.device_put``).
A mesh here is the port's ``DeviceMesh`` (``dist.make_mesh``) or, for the
rules alone, any object whose ``.shape`` maps axis names to sizes.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable

import torch

from ..train._tree import map_with_paths, tree_map

__all__ = [
    "DATA_AXES",
    "batch_pspec",
    "batch_shardings",
    "cache_pspecs",
    "cache_shardings",
    "data_axes",
    "param_pspec",
    "param_shardings",
    "strip_axes",
]

# Mesh axes that carry (pure or FSDP) data parallelism, outermost first.
DATA_AXES = ("pod", "data")


class PartitionSpec(tuple):
    """One entry per tensor dim (trailing dims may be left out): ``None``,
    an axis name, or a tuple of names.  Entries normalise as JAX's do: an
    empty tuple is ``None`` and a one-name tuple is the name."""

    def __new__(cls, *entries):
        def norm(e):
            if isinstance(e, (tuple, list)):
                e = tuple(e)
                return None if not e else e[0] if len(e) == 1 else e
            return e
        return super().__new__(cls, (norm(e) for e in entries))

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def _mesh_shape(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a duck-typed mesh
    whose ``.shape`` is already such a mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def _axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        names = getattr(mesh, "axis_names", None)
    return tuple(names) if names is not None else tuple(_mesh_shape(mesh))


def data_axes(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axis names, outermost first."""
    return tuple(a for a in _axis_names(mesh) if a in DATA_AXES)


def _axes_of(entry) -> tuple[str, ...]:
    return entry if isinstance(entry, tuple) else (entry,)


def _divisible(spec: PartitionSpec, shape: tuple[int, ...], mesh) -> PartitionSpec:
    """Divisibility guard: per dim, drop mesh axes absent from ``mesh`` and,
    if the remaining axis-size product does not divide the dim, drop the
    whole entry.  ``mesh`` only needs a ``.shape`` mapping (duck-typed)."""
    sizes = _mesh_shape(mesh)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for size, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        names = tuple(n for n in _axes_of(entry) if n in sizes)
        prod = math.prod(sizes[n] for n in names)
        if not names or size % prod != 0:
            out.append(None)
        elif isinstance(entry, tuple):
            out.append(names)
        else:
            out.append(names[0])
    return P(*out)


def _batch_entry(axes: Iterable[str]):
    axes = tuple(axes)
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else axes


# --------------------------------------------------------------------------
# Shardings on a DeviceMesh.
# --------------------------------------------------------------------------
def placements(mesh, spec: PartitionSpec) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``, one per mesh dim.
    An entry naming several axes must name them in the mesh's own order
    (JAX's major-to-minor, DTensor's default split order); any other
    order, or an axis named twice, raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = _axis_names(mesh)
    out = [Replicate() for _ in names]
    seen: list[str] = []
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = _axes_of(entry)
        for a in axes:
            if a not in names:
                raise ValueError(f"{spec}: mesh {names} has no axis {a!r}")
            if a in seen:
                raise ValueError(f"{spec}: mesh axis {a!r} is named twice")
            seen.append(a)
        if [names.index(a) for a in axes] != sorted(names.index(a) for a in axes):
            raise ValueError(
                f"{spec}: entry {entry} names its axes out of the mesh's order {names}")
        for a in axes:
            out[names.index(a)] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: object
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.mesh, self.spec)


def device_put(tree, shardings):
    """Every tensor of ``tree`` as a DTensor on its sharding in
    ``shardings`` (same structure; ``jax.device_put``).  Each rank passes
    the whole tensor and keeps its own shard, on the mesh's device; a
    DTensor is redistributed.  Each shard is memory of its own: the
    trainer and the decode caches update in place, and that must not reach
    the tensors passed in."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def one(t, s):
        if t is None:
            return None
        if isinstance(t, DTensor):
            out, before = t.redistribute(s.mesh, s.placements), t.to_local()
        else:
            before = t = torch.as_tensor(t)
            out = distribute_tensor(t, s.mesh, s.placements)
        local = out.to_local()
        if local.untyped_storage().data_ptr() == before.untyped_storage().data_ptr():
            out = DTensor.from_local(local.clone(), s.mesh, s.placements,
                                     shape=out.shape, stride=out.stride())
        return out

    return tree_map(one, tree, shardings)


# --------------------------------------------------------------------------
# Batch rules.
# --------------------------------------------------------------------------
def batch_pspec(mesh, global_batch: int) -> PartitionSpec:
    """Shard the batch dim over the largest divisible suffix of the data
    axes (drop outermost first: a batch too small for pod x data still
    shards over data alone)."""
    sizes = _mesh_shape(mesh)
    axes = list(data_axes(mesh))
    while axes and global_batch % math.prod(sizes[a] for a in axes):
        axes.pop(0)
    if not axes:
        return P()
    return P(_batch_entry(axes))


def batch_shardings(batch, mesh):
    """Tree of NamedShardings: leading dim is the batch dim, rest replicated."""

    def one(leaf):
        if not getattr(leaf, "shape", ()):
            return NamedSharding(mesh, P())
        return NamedSharding(mesh, batch_pspec(mesh, leaf.shape[0]))

    return tree_map(one, batch)


# --------------------------------------------------------------------------
# Param rules.
# --------------------------------------------------------------------------
_COL_2D = {
    "wq", "wk", "wv", "w_gate", "w_up", "w_dkv", "w_kr", "w_dq",
    "in_proj", "router",
}
_ROW_2D = {"wo", "w_down", "out_proj"}
_HEAD_3D = {"w_uk", "w_uv", "w_uq", "w_q"}
_SCALAR = {"A_log", "D", "norm_w"}


def param_pspec(path, leaf, cfg) -> PartitionSpec:
    """PartitionSpec for one param leaf, keyed on its tree path (a tuple of
    keys, as ``train._tree.flatten_with_paths`` yields it).

    Stacked layer params (under a ``stack{i}`` key) get a leading ``None``
    for the unit axis; the body follows the family table.  The result is
    *unguarded*: callers run ``_divisible``.
    """
    keys = [str(p) for p in path]
    name = keys[-1]
    stacked = bool(keys) and keys[0].startswith("stack")
    lead = (None,) if stacked else ()
    r = len(leaf.shape) - len(lead)

    if name == "embed":
        body = ("model", "data")
    elif name == "lm_head":
        body = ("data", "model")
    elif name.endswith("norm") or name in _SCALAR:
        body = (None,) * r
    elif name in ("w_gate", "w_up") and r == 3:    # routed experts (E, d, f)
        body = ("model", "data", None)
    elif name == "w_down" and r == 3:              # routed experts (E, f, d)
        body = ("model", None, "data")
    elif name in _HEAD_3D and r == 3:              # (d_in, H, head_feat)
        body = ("data", "model", None)
    elif name in _ROW_2D and r == 2:
        body = ("model", "data")
    elif name in _COL_2D and r == 2:
        body = ("data", "model")
    elif name == "conv_w":                         # (K, conv_dim)
        body = (None, "model")
    elif name.endswith(("_bias", "_b")) or (name.startswith("b") and r == 1):
        body = (None,) * (r - 1) + ("model",)
    else:
        body = (None,) * r
    return P(*(lead + body))


def param_shardings(params, mesh, cfg):
    """Full param tree -> NamedShardings (rules + divisibility guard)."""

    def one(path, leaf):
        spec = _divisible(param_pspec(path, leaf, cfg), leaf.shape, mesh)
        return NamedSharding(mesh, spec)

    return map_with_paths(one, params)


# --------------------------------------------------------------------------
# Decode-cache rules.
# --------------------------------------------------------------------------
def cache_pspecs(caches, mesh, cfg):
    """Decode caches: leading unit axis replicated, batch dim (axis 1) over
    the data axes, KV-head axis of (L, B, S, Hkv, hd) leaves over model.
    An encoder stack's ``None`` stays ``None``."""
    return tree_map(lambda leaf: _cache_pspec(leaf, mesh, cfg), caches)


def _cache_pspec(leaf, mesh, cfg):
    if leaf is None:
        return None
    shape = leaf.shape
    if len(shape) < 2:
        return P()
    spec = [None, _batch_entry(data_axes(mesh))] + [None] * (len(shape) - 2)
    if len(shape) == 5 and shape[3] == getattr(cfg, "n_kv_heads", 0):
        spec[3] = "model"
    return _divisible(P(*spec), shape, mesh)


def cache_shardings(caches, mesh, cfg):
    """``cache_pspecs`` as NamedShardings (the jit in_shardings form)."""

    def one(leaf):
        spec = _cache_pspec(leaf, mesh, cfg)
        return None if spec is None else NamedSharding(mesh, spec)

    return tree_map(one, caches)


# --------------------------------------------------------------------------
# Spec surgery.
# --------------------------------------------------------------------------
def strip_axes(shardings, axes: Iterable[str]):
    """Remove the named mesh axes from every sharding in the tree (e.g. the
    weight-stationary serving layout: params TP-sharded, FSDP axes gone)."""
    axes = set(axes)

    def one(s):
        if s is None:
            return None
        entries = []
        for e in s.spec:
            if e is None:
                entries.append(None)
            elif isinstance(e, tuple):
                kept = tuple(n for n in e if n not in axes)
                entries.append(kept if kept else None)
            else:
                entries.append(None if e in axes else e)
        return NamedSharding(s.mesh, P(*entries))

    return tree_map(one, shardings)
