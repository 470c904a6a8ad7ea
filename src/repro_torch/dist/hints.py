"""Activation-sharding hints (counterpart of ``repro.dist.hints``): layout
anchors that are exact identities outside an ``activation_sharding``
context.

Model code calls these unconditionally (residual stream, attention heads,
FFN hidden) and stays mesh-agnostic: off a mesh, or on a plain tensor,
every hint returns its input itself.  Inside the context a hint on a
DTensor redistributes it to the guarded spec (``DTensor.redistribute``,
where the reference's ``with_sharding_constraint`` re-anchors GSPMD), so
the Megatron pattern holds: batch over the data axes, heads / FFN hidden
over model, residual stream replicated over model.

GSPMD also reshards by itself wherever a view needs it; DTensor does not,
so port-only anchors sit where the model handles heads: ``split_heads``
(the (B, S, H * hd) -> (B, S, H, hd) view of q, k and v) and
``per_head`` (attention run on each rank's own rows and heads); and
``rows`` looks the token embedding up in the table gathered whole.
Inside the context plain tensors that the model builds (positions, RoPE
tables, masks) count as replicated (``implicit_replication``).
"""
from __future__ import annotations

import contextlib
import math

import torch

from .sharding import P, _batch_entry, _divisible, data_axes, placements

__all__ = ["act", "activation_sharding", "ffn_hidden", "heads"]

# Stack of (mesh, batch_axes) contexts; empty means hints are identities.
_ACTIVE: list[tuple] = []


class activation_sharding:
    """Context manager activating the hints on ``mesh``.

    ``batch_axes``: mesh axes the activations' batch dim shards over
    (defaults to the mesh's data axes).
    """

    def __init__(self, mesh, batch_axes=None):
        self.mesh = mesh
        self.batch_axes = (
            tuple(batch_axes) if batch_axes is not None else data_axes(mesh)
        )

    def __enter__(self):
        if not _ACTIVE:  # the outermost context lets plain tensors mix in
            from torch.distributed.tensor.experimental import implicit_replication

            self._replication = contextlib.ExitStack()
            self._replication.enter_context(implicit_replication())
        _ACTIVE.append((self.mesh, self.batch_axes))
        return self

    def __exit__(self, *exc):
        _ACTIVE.pop()
        if not _ACTIVE:
            self._replication.close()
        return False


def _dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _to(x, mesh, want: tuple):
    """``x`` on ``want``.  It always goes through ``redistribute``, also
    where ``x`` has that layout already: the node it leaves in the graph
    puts the gradient back on ``x``'s layout in the backward pass, as
    ``with_sharding_constraint`` constrains the cotangent."""
    return x.redistribute(mesh, tuple(want))


def _hint(x: torch.Tensor, body: tuple) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to P(batch, *body) under the active
    context; anything else comes back as it is."""
    if not _ACTIVE or not _dtensor(x):
        return x
    mesh, baxes = _ACTIVE[-1]
    spec = _divisible(P(_batch_entry(baxes), *body), x.shape, mesh)
    return _to(x, mesh, placements(mesh, spec))


def act(x: torch.Tensor) -> torch.Tensor:
    """Residual stream (B, S, d): batch over data, d replicated (TP keeps
    the residual unsharded; column/row weight pairing reduces into it)."""
    return _hint(x, (None,) * (x.ndim - 1))


def heads(x: torch.Tensor) -> torch.Tensor:
    """Per-head activations (B, S, H, hd): heads over the model axis."""
    if x.ndim == 4:
        return _hint(x, (None, "model", None))
    return _hint(x, (None,) * (x.ndim - 1))


def ffn_hidden(h: torch.Tensor) -> torch.Tensor:
    """FFN hidden (B, S, f): the column-parallel output dim over model."""
    return _hint(h, (None,) * (h.ndim - 2) + ("model",))


def split_heads(x: torch.Tensor, n_heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, n_heads * head_dim) -> (B, S, n_heads, head_dim).  Under the
    context a DTensor first takes the layout ``heads`` gives the result,
    expressed on the flat dim (whole heads over model, or none), so that
    the view keeps it."""
    B, S = x.shape[:2]
    if _ACTIVE and _dtensor(x):
        mesh, baxes = _ACTIVE[-1]
        spec = _divisible(P(_batch_entry(baxes), None, "model", None),
                          (B, S, n_heads, head_dim), mesh)
        x = _to(x, mesh, placements(mesh, P(spec[0], None, spec[2])))
    return x.reshape(B, S, n_heads, head_dim)


def rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]``, a gather of rows (the token embedding).  On a mesh
    the table is gathered whole first (the FSDP unshard; its gradient goes
    back to the table's layout as a reduce-scatter) and each rank looks up
    its own rows with ``F.embedding``: DTensor's rules for indexing a
    table, and for a vocab-parallel lookup, fail in some torch releases."""
    if not on_mesh(table):
        return table[idx]
    from torch.distributed.tensor import Replicate

    whole = _to(table, table.device_mesh, (Replicate(),) * table.device_mesh.ndim)
    return torch.nn.functional.embedding(idx, whole)


def on_mesh(x) -> bool:
    """Whether ``x`` is a DTensor under an active context."""
    return bool(_ACTIVE) and _dtensor(x)


def per_head(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *args, **kwargs):
    """``fn(q, k, v, ...)``, an attention over (B, S, H, hd) heads, run by
    every rank on its own batch rows and heads as plain tensors; the
    result, (B, Sq, H, Dv), comes back a DTensor on q's layout.  Attention
    is independent across rows and across kv groups, so no collective is
    needed once q's head split falls on whole groups: where it does not
    (H over the model axis but not Hkv), q's heads are gathered first, and
    k and v take q's layout.  GSPMD partitions the attention itself; DTensor
    cannot carry the einsums' flattened (batch, group) dims."""
    from torch.distributed.tensor import DTensor, Replicate

    mesh, n_kv = q.device_mesh, k.shape[2]
    split = [i for i, p in enumerate(q.placements) if p.is_shard(2)]
    want = tuple(q.placements)
    if n_kv % math.prod(mesh.size(i) for i in split):
        want = tuple(Replicate() if i in split else p for i, p in enumerate(want))
    q, k, v = (_to(t, mesh, want) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(), *args, **kwargs)
    return DTensor.from_local(out, mesh, want)
