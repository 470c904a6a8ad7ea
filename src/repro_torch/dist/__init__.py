"""repro_torch.dist — the mesh, tile placement, the sharded PDXearch
executors and the bucket-routed search (``routing``), the LM side's
sharding rules (``sharding``), activation hints (``hints``) and pipeline
schedule (``pipeline``), on ``torch.distributed`` (counterpart of
``repro.dist``).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` whose
``mesh_dim_names`` name its axes ("data" for partition sharding, "model"
for dimension sharding, as in the reference).  ``make_mesh`` stands in for
``jax.make_mesh``: it needs an initialised default process group (NCCL on
GPUs, gloo on the CPU) and one process per rank.

**The SPMD contract.**  Every rank calls ``VectorSearchEngine.build`` and
``search`` with the same arguments — the same X, seed and Q — and every
rank gets the same, replicated result.  This stands in for ``shard_map``'s
``in_specs`` of ``P(axis)`` (each rank takes its slice of the replicated
store: ``placement.Placement.local``) and ``out_specs`` of ``P()`` (the
collectives leave every rank with the whole answer).

The LM side shards params, optimizer state, batches and caches as
``torch.distributed.tensor.DTensor`` leaves: ``sharding`` turns the
reference's name-based partition specs into DTensor placements on a
``DeviceMesh``, and DTensor's own dispatch issues the collectives of the
sharded step (they are not counted here).

Every collective the executors, ``train.compression.compressed_psum`` and
``pipeline.pipeline_apply`` issue goes through ``all_gather``,
``all_to_all``, ``psum``, ``pmax`` and ``ppermute`` below, which count each
call under the reference's primitive name;
``repro_torch.obs.meters.collective_counts`` reads those counts around a
call.
"""
from __future__ import annotations

import threading

import torch
import torch.distributed as dist

__all__ = [
    "make_mesh", "mesh_shape", "axis_size", "axis_rank", "mesh_device",
    "all_gather", "all_to_all", "psum", "pmax", "ppermute", "issued_counts",
    "hints", "pipeline", "sharding",
]


def make_mesh(shape, axis_names, *, device=None):
    """A ``DeviceMesh`` of ``shape`` over the initialised default process
    group, its axes named ``axis_names``.  ``device=None`` means "cuda" and
    raises without a card; the CPU tests pass ``device="cpu"`` (gloo)."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group (NCCL on GPUs, gloo on the "
            "CPU) on every rank first"
        )
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: make_mesh builds a 'cuda' mesh "
                "by default; pass device='cpu' for a gloo mesh on the CPU"
            )
        device = "cuda"
    from torch.distributed.device_mesh import init_device_mesh

    shape, names = tuple(int(s) for s in shape), tuple(axis_names)
    if len(shape) != len(names):
        raise ValueError(f"mesh shape {shape} and axis names {names} differ in length")
    return init_device_mesh(str(device), shape, mesh_dim_names=names)


def mesh_shape(mesh) -> dict:
    """``{axis name: size}`` — the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axis_size(mesh, axis: str) -> int:
    return mesh_shape(mesh)[axis]


def axis_rank(mesh, axis: str) -> int:
    """This process's coordinate along ``axis``."""
    return mesh.get_local_rank(mesh_dim=axis)


def mesh_device(mesh) -> torch.device:
    """The device this rank's shard lives on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


# ------------------------------------------------------ counted collectives
_lock = threading.Lock()
_issued: dict[str, int] = {}


def _count(primitive: str) -> None:
    with _lock:
        _issued[primitive] = _issued.get(primitive, 0) + 1


def issued_counts() -> dict[str, int]:
    """Collectives issued by this process so far, by primitive name."""
    with _lock:
        return dict(_issued)


def all_gather(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Tiled all-gather along dim 0 over the ranks of ``axis``: (m, ...)
    per rank -> (n * m, ...), rank order (``lax.all_gather(tiled=True)``)."""
    t = t.contiguous()
    out = t.new_empty((axis_size(mesh, axis) * t.shape[0],) + tuple(t.shape[1:]))
    _count("all_gather")
    dist.all_gather_into_tensor(out, t, group=mesh.get_group(mesh_dim=axis))
    return out


def all_to_all(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """All-to-all along dim 0 over the ranks of ``axis``: (n, ...) per rank,
    row t goes to rank t and row s of the result came from rank s
    (``lax.all_to_all(x, axis, 0, 0, tiled=True)``).  ``t`` may be a view
    (a spilled round is a slice of the send buffer); it is made contiguous
    here."""
    n = axis_size(mesh, axis)
    if t.shape[0] != n:
        raise ValueError(
            f"all_to_all over {n} ranks of '{axis}' needs dim 0 of size {n}, "
            f"got shape {tuple(t.shape)}"
        )
    t = t.contiguous()
    out = torch.empty_like(t)
    _count("all_to_all")
    dist.all_to_all_single(out, t, group=mesh.get_group(mesh_dim=axis))
    return out


def psum(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over the ranks of ``axis``, the same result on every rank
    (``lax.psum``)."""
    out = t.clone().contiguous()
    _count("psum")
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.get_group(mesh_dim=axis))
    return out


def pmax(t: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Elementwise maximum over the ranks of ``axis``, the same result on
    every rank (``lax.pmax``)."""
    out = t.clone().contiguous()
    _count("pmax")
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=mesh.get_group(mesh_dim=axis))
    return out


def ppermute(t: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """Send ``t`` along the (source, destination) pairs of ``perm``, axis
    coordinates of ``axis``; a rank that no pair sends to gets zeros
    (``lax.ppermute``).  Every send and receive of this rank goes out in
    one ``batch_isend_irecv``, so no order of ranks can deadlock; a pair
    from a rank to itself is a copy."""
    group = mesh.get_group(mesh_dim=axis)
    me = axis_rank(mesh, axis)
    t = t.contiguous()
    out = torch.zeros_like(t)
    ops = []
    for src, dst in perm:
        if src == me and dst == me:
            out.copy_(t)
        elif src == me:
            ops.append(dist.P2POp(dist.isend, t, dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    _count("ppermute")
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


# the LM side's modules (imported last: they use the helpers above)
from . import hints, pipeline, sharding  # noqa: E402
