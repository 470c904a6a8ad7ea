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
(the (B, S, H * hd) -> (B, S, H, hd) view of q, k and v),
``column_operands`` (the operands of every column-parallel product,
``common.matmul`` lays them out where ``column_parallel`` holds, and of
MLA's head products, split over model), ``like`` (MLA's rope key, split
by heads over model) and ``per_head`` (attention run on each rank's own
rows and heads); ``rows`` looks the token embedding up in the table
gathered whole; ``per_rows`` runs a block on each rank's own rows with its
weights gathered whole, ``per_experts`` the MoE on them with each rank's
own experts, and ``per_heads`` the Mamba2 mixer with each rank's own
heads (its decode with ``in_proj`` and ``out_proj`` kept on their "model"
split, ``model_block``).
Inside the context plain tensors that the model builds (positions, RoPE
tables, masks) count as replicated (``implicit_replication``).
"""
from __future__ import annotations

import contextlib
import math

import torch

from .sharding import P, _batch_entry, _divisible, data_axes, placements

__all__ = ["act", "activation_sharding", "ffn_hidden", "heads"]

# Stack of (mesh, batch_axes, anchor) contexts; empty means hints are identities.
_ACTIVE: list[tuple] = []


class activation_sharding:
    """Context manager activating the hints on ``mesh``.

    ``batch_axes``: mesh axes the activations' batch dim shards over
    (defaults to the mesh's data axes).  ``anchor=False`` leaves ``act``,
    ``heads`` and ``ffn_hidden`` identities, as the reference's hints are
    outside their context, and keeps only the port-only reshards
    (``split_heads``, ``column_operands``, ``like``, ``per_head``, ``rows``
    and the ``per_*`` blocks) that DTensor needs where GSPMD reshards by
    itself: the dry-run's step without ``--hints``.
    """

    def __init__(self, mesh, batch_axes=None, *, anchor: bool = True):
        self.mesh = mesh
        self.batch_axes = (
            tuple(batch_axes) if batch_axes is not None else data_axes(mesh)
        )
        self.anchor = anchor

    def __enter__(self):
        if not _ACTIVE:  # the outermost context lets plain tensors mix in
            from torch.distributed.tensor.experimental import implicit_replication

            self._replication = contextlib.ExitStack()
            self._replication.enter_context(implicit_replication())
        _ACTIVE.append((self.mesh, self.batch_axes, self.anchor))
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
    if not _ACTIVE or not _ACTIVE[-1][2] or not _dtensor(x):
        return x
    mesh, baxes, _ = _ACTIVE[-1]
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
        mesh, baxes, _ = _ACTIVE[-1]
        spec = _divisible(P(_batch_entry(baxes), None, "model", None),
                          (B, S, n_heads, head_dim), mesh)
        x = _to(x, mesh, placements(mesh, P(spec[0], None, spec[2])))
    return x.reshape(B, S, n_heads, head_dim)


def column_operands(x: torch.Tensor, w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x`` (..., r) and ``w`` (r, n, ...) laid out for the column-parallel
    product ``x @ w`` (the dense FFN's gate and up, GQA's q, k and v, MLA's
    down products) or the product split by heads (``w`` (r, H, e), MLA's
    head products): under the context ``x`` keeps its batch split and is
    gathered over every other mesh dim, ``w`` is split over model on dim 1
    (its columns or whole heads, where n divides and ``x``'s rows do not
    split over model; else gathered whole) and gathered over the rest, so
    that DTensor's product gives each rank its own columns without a
    collective.  GSPMD finds this layout by itself, with or without
    anchors; DTensor, given an ``x`` split over r (a column-parallel
    product before it) sums a partial product of every column, and given
    an ``x`` that is a partial sum over model (a row-parallel product
    before it, no anchor between) splits its rows over model and makes
    every column.  Like ``split_heads`` it acts with the anchors off.  An
    operand already on its layout is left as it is: the gradients of the
    products that read it stay partial sums, which DTensor sums once where
    they meet, not once a product."""
    if not (_ACTIVE and _dtensor(x) and _dtensor(w)):
        return x, w
    from torch.distributed.tensor import Replicate

    mesh = w.device_mesh
    rows = tuple(q if q.is_shard(0) else Replicate() for q in x.placements)
    spec = _divisible(P(None, "model"), tuple(w.shape), mesh)
    cols = tuple(Replicate() if q.is_shard(0) else c
                 for q, c in zip(rows, placements(mesh, spec)))
    return tuple(t if tuple(t.placements) == want else _to(t, mesh, want)
                 for t, want in ((x, rows), (w, cols)))


def column_parallel(w: torch.Tensor) -> bool:
    """Whether ``w`` is a DTensor under the context whose columns (dim 1)
    "model" splits: a column-parallel weight of the rules."""
    if not (_ACTIVE and _dtensor(w)) or "model" not in (w.device_mesh.mesh_dim_names or ()):
        return False
    return w.placements[w.device_mesh.mesh_dim_names.index("model")].is_shard(1)


def summed(x: torch.Tensor) -> torch.Tensor:
    """``x`` with its partial sums summed under the context (its splits
    kept); anything else, and a DTensor that holds no partial sum, as it
    is.  Where the anchors are off, DTensor carries the residual stream
    after a row-parallel product as a partial sum through the linear ops
    of a norm, and every product that reads the norm's output sums it
    again; GSPMD sums it once, at the norm."""
    if not (_ACTIVE and _dtensor(x)) or not any(q.is_partial() for q in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return _to(x, x.device_mesh, tuple(Replicate() if q.is_partial() else q
                                       for q in x.placements))


def like(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """``x`` on ``ref``'s splits under the context (MLA's head-less rope key,
    broadcast over the heads, takes the head split of the keys it is
    concatenated with; where ``ref`` is a partial sum, ``x`` is whole);
    anything else comes back as it is."""
    if not (_ACTIVE and _dtensor(x) and _dtensor(ref)):
        return x
    from torch.distributed.tensor import Replicate

    return _to(x, ref.device_mesh,
               tuple(Replicate() if q.is_partial() else q for q in ref.placements))


def merge_heads(y: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, H * hd).  Under the context a DTensor whose
    head features (dim 3) split over a mesh dim is gathered over it first:
    DTensor's rules may split them where the heads do not divide (MLA's
    absorbed decode), and some torch releases refuse to flatten that
    split.  The result goes through ``redistribute`` to the layout the view
    gave it, so that in the backward pass its gradient comes back on that
    layout before the view splits it into heads again: a product against
    ``wo`` may hand the gradient back split over model across a head's
    boundary (24 heads over 16 ranks), which some torch releases refuse to
    view."""
    if _ACTIVE and _dtensor(y) and any(q.is_shard(3) for q in y.placements):
        from torch.distributed.tensor import Replicate

        y = _to(y, y.device_mesh, tuple(Replicate() if q.is_shard(3) else q
                                        for q in y.placements))
    out = y.reshape(y.shape[0], y.shape[1], -1)
    if _ACTIVE and _dtensor(out):
        out = _to(out, out.device_mesh, out.placements)
    return out


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


def _whole(v, grad: tuple):
    """The DTensor ``v`` gathered whole as a plain tensor whose gradient
    goes back on the placements ``grad``; anything else as it is."""
    if not _dtensor(v):
        return v
    from torch.distributed.tensor import Replicate

    mesh = v.device_mesh
    return _to(v, mesh, (Replicate(),) * mesh.ndim).to_local(grad_placements=grad)


def _blocks(x: torch.Tensor, dims: tuple[int, ...], whole: bool = False):
    """The layouts for a block of work computed by each rank of the mesh
    dims ``dims`` on the same batch rows of the DTensor ``x``, the blocks'
    results summed over ``dims`` -> ``(rows, share, grad, back, block)``:
    the rows each rank runs (``x`` gathered over ``dims``; over every dim
    with ``whole``), a block's result (a partial sum over ``dims``), the
    gradient of a param gathered whole (a partial sum over ``dims`` and the
    dims that split the rows), the sum's layout (``x``'s own split) and the
    rank's block over ``dims`` (DTensor's order of a dim split over several
    mesh dims)."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    mesh = x.device_mesh
    rows = tuple(q if q.is_shard(0) and not whole and i not in dims else Replicate()
                 for i, q in enumerate(x.placements))
    share = tuple(Partial() if i in dims else q for i, q in enumerate(rows))
    grad = tuple(Partial() if i in dims or q.is_shard(0) else Replicate()
                 for i, q in enumerate(rows))
    back = tuple(Shard(0) if i in dims and x.placements[i].is_shard(0) and not whole else q
                 for i, q in enumerate(rows))
    coord, block = mesh.get_coordinate(), 0
    for i in dims:
        block = block * mesh.size(i) + coord[i]
    return rows, share, grad, back, block


def per_rows(fn, p: dict, x: torch.Tensor, *args, whole: bool = False, **kwargs):
    """``fn(p, x, *args, **kwargs)`` run by every rank on its own batch
    rows of the DTensor ``x`` as plain tensors, with the params ``p``
    gathered whole (the FSDP unshard, as ``rows`` gathers the embedding,
    and over any other dim that splits them: the Mamba2 decode's weights,
    experts that no rule splits; ``per_experts`` keeps split experts);
    ``whole`` makes every rank run the whole batch.  A DTensor in ``args``
    (a decode cache, split over the batch) goes in as its local tensor, so
    that ``fn``'s in-place writes land in its shard, and the rows follow
    its layout.  Each tensor of the result comes back a DTensor on the
    rows' layout.  For a block that is independent across batch rows and
    whose ops DTensor has no rules for in every torch release (the MoE
    dispatch's sort and search, the SSD scan); a rank's param grads are
    then a partial sum over the mesh dims that split the batch."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from ..train._tree import leaves, tree_map

    mesh = x.device_mesh
    held = [v for v in leaves(list(args)) if _dtensor(v)]
    if held:
        rows = tuple(held[0].placements)
    else:
        rows = tuple(q if q.is_shard(0) and not whole else Replicate() for q in x.placements)
    partial = tuple(Partial() if q.is_shard(0) else Replicate() for q in rows)

    def local(v):
        if not _dtensor(v):
            return v
        if tuple(v.placements) != rows:
            raise ValueError(f"per_rows: an argument on {tuple(v.placements)}, the rows on {rows}")
        return v.to_local()

    out = fn(tree_map(lambda v: _whole(v, partial), p), _to(x, mesh, rows).to_local(),
             *tree_map(local, args), **kwargs)
    return tree_map(lambda t: DTensor.from_local(t, mesh, rows)
                    if isinstance(t, torch.Tensor) else t, out)


def expert_dims(w) -> tuple[int, ...]:
    """The mesh dims that split dim 0 of the DTensor ``w`` (an expert
    tensor's expert axis); none for a plain tensor."""
    if not _dtensor(w):
        return ()
    return tuple(i for i, q in enumerate(w.placements) if q.is_shard(0))


class _AllToAll(torch.autograd.Function):
    """``dist.all_to_all`` over the ranks of ``axis``, differentiable: the
    gradient goes back by the same exchange (row s of the result came from
    rank s, so row s of its gradient returns there)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        from . import all_to_all

        ctx.mesh, ctx.axis = mesh, axis
        return all_to_all(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        from . import all_to_all

        return all_to_all(g, ctx.mesh, ctx.axis), None, None


def per_experts(fn, p: dict, x: torch.Tensor, experts: tuple[str, ...], *,
                whole: bool = False, exchange: bool = False):
    """``fn(p, x, first, a2a)``, a mixture of experts, run by every rank on
    its own batch rows of the DTensor ``x`` as plain tensors, with the
    expert tensors ``p[name]`` (``name`` in ``experts``, the experts on dim
    0) kept at the rank's own block of experts, those numbered ``first``
    up, and the other params gathered whole.  An expert tensor is gathered
    only over the dims that split its other axes (the FSDP unshard of d or
    f), never over the expert dims; in the weight-stationary layout
    nothing is gathered.  Two layouts of the rows:

    * ``exchange`` (the rows split over the one expert dim too): each rank
      keeps its own rows; ``a2a`` is the all-to-all over that dim (dim 0,
      row j to rank j, differentiable), through which ``fn`` sends its
      tokens to the experts' ranks and takes their outputs back, and
      ``fn`` gives its rows' whole result;
    * otherwise every rank of an expert group runs the same rows (gathered
      over the expert dims where ``x`` splits over them), ``a2a`` is
      ``None``, ``fn`` gives its block's share of the result, and the
      shares are summed over the expert dims (an all-reduce, as GSPMD
      combines the reference's expert-parallel layer; a reduce-scatter
      back to ``x``'s split).  ``whole`` makes every rank run the whole
      batch.

    Gradients: an expert tensor's stays on its rank's block and is a
    partial sum over the other dims that split the rows; the other params'
    are partial sums over every dim that splits the rows, and over the
    expert dims where each rank saw only its block's share (``x``'s too).
    Where the experts split over no dim, this is ``per_rows``."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from ..train._tree import tree_map

    ep = expert_dims(p[experts[0]])
    if not ep:
        return per_rows(lambda p_, x_: fn(p_, x_, 0, None), p, x, whole=whole)
    mesh = x.device_mesh
    if exchange and (len(ep) != 1 or not x.placements[ep[0]].is_shard(0) or whole):
        raise ValueError(f"per_experts: an exchange needs the rows split over the one "
                         f"expert dim, got experts over {ep}, x on {tuple(x.placements)}")
    # an exchange keeps each rank's own rows and sums nothing
    rows, share, grad, back, block = _blocks(x, () if exchange else ep, whole)
    n_blocks = math.prod(mesh.size(i) for i in ep)
    E = p[experts[0]].shape[0]
    if E % n_blocks:
        raise ValueError(f"per_experts: {E} experts do not split evenly over {n_blocks} ranks")
    own = tuple(Shard(0) if i in ep else Replicate() for i in range(mesh.ndim))
    own_grad = tuple(Shard(0) if i in ep else g for i, g in enumerate(grad))

    def param(name, v):
        if not _dtensor(v) or name not in experts:
            return _whole(v, grad)
        if expert_dims(v) != ep:
            raise ValueError(f"per_experts: {name} splits its experts over mesh dims "
                             f"{expert_dims(v)}, {experts[0]} over {ep}")
        return _to(v, mesh, own).to_local(grad_placements=own_grad)

    local = {k: tree_map(lambda t, k=k: param(k, t), v) for k, v in p.items()}
    xl = _to(x, mesh, rows).to_local(grad_placements=share)
    if exchange:
        axis = mesh.mesh_dim_names[ep[0]]
        y = fn(local, xl, 0, lambda t: _AllToAll.apply(t, mesh, axis))
        return DTensor.from_local(y, mesh, rows)
    y = fn(local, xl, block * (E // n_blocks), None)
    return DTensor.from_local(y, mesh, share).redistribute(mesh, back)


class _SumOver(torch.autograd.Function):
    """``dist.psum`` over the mesh axis ``axis``, differentiable: every
    rank's result is the sum of every rank's input, so each input's
    gradient is the sum of every rank's result gradient (a psum again)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        from . import psum

        ctx.mesh, ctx.axis = mesh, axis
        return psum(t, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        from . import psum

        return psum(g, ctx.mesh, ctx.axis), None, None


class Heads:
    """The block of heads ``[lo, hi)`` of ``n`` that a rank computes
    (``per_heads``), with the sum and the gather over the ranks of the mesh
    axis ``axis`` that compute the other blocks.  ``Heads(0, n, n)``, every
    head on its rank and no axis, sums and gathers nothing."""

    def __init__(self, lo: int, hi: int, n: int, mesh=None, axis: str | None = None):
        self.lo, self.hi, self.n, self.mesh, self.axis = lo, hi, n, mesh, axis

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the blocks, the same on every rank;
        differentiable."""
        return t if self.axis is None else _SumOver.apply(t, self.mesh, self.axis)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every block's ``t`` concatenated along ``dim`` in block order,
        the same on every rank.  The result carries no gradient (it is a
        prefill's state)."""
        if self.axis is None:
            return t
        from . import all_gather

        return all_gather(t.detach().movedim(dim, 0), self.mesh, self.axis).movedim(0, dim)


def per_heads(fn, p: dict, x: torch.Tensor, n_heads: int, *args, groups: int = 1,
              own: dict | None = None, **kwargs):
    """``fn(p, x, heads, *args, **kwargs)``, a block of ``n_heads`` heads
    (the Mamba2 mixer), run by every rank on its own batch rows of the
    DTensor ``x`` as plain tensors and on its own block of heads, ``heads``
    (a ``Heads``: the ranks of the "model" axis split the heads evenly, in
    the order of their coordinate), with the params ``p`` gathered whole
    (``fn`` takes its heads' share of them), except those that ``own``
    names: ``own[name]`` is the dim of ``p[name]`` that the rules split
    over "model", and where they do, ``fn`` gets the rank's block along it,
    gathered over the other mesh dims only (``model_block``; the Mamba2
    decode's ``in_proj`` columns and ``out_proj`` rows).  A DTensor in
    ``args`` (a decode cache, split over the batch) goes in as its local
    tensor, so that ``fn``'s in-place writes land in its shard, and the
    rows follow its layout.  ``fn`` gives its block's share of the result,
    a partial sum (a row-parallel product), or a tuple of it and tensors
    that are whole on every rank of the axis (``heads.gather`` made them
    so: a prefill's state, a decode's cache); the shares are summed over
    "model" (an all-reduce, or a reduce-scatter back to ``x``'s split), the
    rest come back DTensors on the rows' layout.  The heads share inputs by
    ``groups`` (Mamba2's B and C): a block must hold whole groups or lie
    within one.

    Gradients: every param's, a partial sum over the dims that split the
    rows and over "model" (the other blocks' columns get zeros from this
    rank), a block's split over "model"; ``x``'s, a partial sum over
    "model".  Where the heads do not split evenly over "model" (or a block
    would cut a group), this is ``per_rows`` with every head on every rank
    and every param whole; on a mesh without a "model" axis, one block of
    every head."""
    from torch.distributed.tensor import DTensor, Shard

    from ..train._tree import leaves, tree_map

    mesh = x.device_mesh
    names = mesh.mesh_dim_names
    d = names.index("model") if "model" in names else None
    m = 1 if d is None else mesh.size(d)
    size, rep = n_heads // m, n_heads // groups
    if n_heads % m or (size % rep and rep % size):
        return per_rows(lambda p_, x_, *a, **k: fn(p_, x_, Heads(0, n_heads, n_heads), *a, **k),
                        p, x, *args, **kwargs)
    held = [v for v in leaves(list(args)) if _dtensor(v)]
    if held:  # the rows follow the arguments' layout, as in per_rows
        x = _to(x, mesh, held[0].placements)
    rows, share, grad, back, block = _blocks(x, () if d is None else (d,))
    heads = Heads(block * size, (block + 1) * size, n_heads, mesh,
                  None if d is None else "model")
    own = own or {}

    def param(name, v):
        if name in own and d is not None:
            return model_block(v, own[name], tuple(
                Shard(own[name]) if i == d else g for i, g in enumerate(grad)))
        return _whole(v, grad)

    def local(v):
        if not _dtensor(v):
            return v
        if tuple(v.placements) != rows:
            raise ValueError(f"per_heads: an argument on {tuple(v.placements)}, the rows on {rows}")
        return v.to_local()

    out = fn({k: tree_map(lambda t, k=k: param(k, t), v) for k, v in p.items()},
             _to(x, mesh, rows).to_local(grad_placements=share), heads,
             *tree_map(local, args), **kwargs)
    y, rest = (out[0], out[1:]) if isinstance(out, tuple) else (out, None)
    y = DTensor.from_local(y, mesh, share).redistribute(mesh, back)
    if rest is None:
        return y
    return (y, *tree_map(lambda t: DTensor.from_local(t, mesh, rows)
                         if isinstance(t, torch.Tensor) else t, rest))


def model_block(v, dim: int, grad: tuple):
    """The DTensor ``v``'s block along ``dim`` that the rank's "model"
    coordinate names, gathered over the other mesh dims only, as a plain
    tensor whose gradient goes back on the placements ``grad``: a
    column-parallel weight's columns, a row-parallel weight's rows.  Where
    no rule splits ``dim`` over "model", ``v`` gathered whole (``_whole``,
    the gradient a partial sum where ``grad`` splits ``dim``); anything
    else as it is."""
    if not _dtensor(v):
        return v
    from torch.distributed.tensor import Partial, Replicate

    mesh = v.device_mesh
    d = mesh.mesh_dim_names.index("model")
    if not v.placements[d].is_shard(dim):
        return _whole(v, tuple(Partial() if q.is_shard(dim) else q for q in grad))
    want = tuple(q if i == d else Replicate() for i, q in enumerate(v.placements))
    return _to(v, mesh, want).to_local(grad_placements=grad)


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
    # a partial sum (a projection split over its input) is summed first
    want = tuple(Replicate() if p.is_partial() else p for p in q.placements)
    if n_kv % math.prod(mesh.size(i) for i in split):
        want = tuple(Replicate() if i in split else p for i, p in enumerate(want))
    q, k, v = (_to(t, mesh, want) for t in (q, k, v))
    out = fn(q.to_local(), k.to_local(), v.to_local(), *args, **kwargs)
    return DTensor.from_local(out, mesh, want)
