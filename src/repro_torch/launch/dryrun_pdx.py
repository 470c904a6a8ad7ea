"""Dry-run for the paper's own workload at production scale (counterpart of
``repro.launch.dryrun_pdx``): distributed PDX similarity search over the
16x16 / 2x16x16 mesh, on meta tensors over a one-process ``fake`` process
group of 256 or 512 ranks.

Corpus: 100M vectors x 1536 dims in partitions of 8192 (12,207, padded to
12,288), 128 queries, k = 10.  Variants:

  block            -- partitions sharded across ranks; a local scan and
                      top-k, then an all-gather of every rank's top-k
  dim              -- dimension sharding: one psum of the partial
                      distances over "model" per tile
  block_matmul     -- the queries batched into one product per tile
  block_matmul_bf16-- + bf16 storage
  block_matmul_int8-- + int8 storage, dequantized on read at a constant
                      0.02 scale (the dry-run measures structure, not
                      answers)
  block_pruned     -- + an ADSampling-style mask on the first 64 dims

Where the reference builds a ``shard_map``, the port runs an SPMD per-rank
body (``local_fn``) on rank 0's meta shards: (48, 1536, 8192) for the
block variants on 256 ranks, (768, 96, 8192) for ``dim``.  Its
collectives are the port's own (``repro_torch.dist.all_gather``, ``psum``)
over the axes' sub-groups of the ``DeviceMesh``.  Every query is merged at
once: a tile's distances for all 128 queries go into a batch of 128 top-10
states (``core.topk.topk_merge``), so ``dim`` issues one psum of
(128, 8192) f32 a tile, 768 in all, where a loop per query would issue
98,304.

Each record has ``dryrun.py``'s schema: ``jaxpr_cost`` is
``analysis.step_cost`` of the per-rank body times the ranks, ``collectives``
and ``memory`` are rank 0's, ``compile_s`` is 0 and ``lower_s`` the
seconds of the meta runs.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun_pdx --mesh single_pod \\
        --out results/dryrun_pdx_torch
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from ..core.topk import topk_init, topk_merge
from ..dist import all_gather, mesh_shape, psum
from .analysis import memory_trace, step_cost
from .dryrun import open_world
from .mesh import make_production_mesh

__all__ = ["N_VECTORS", "DIM", "CAPACITY", "QUERIES", "K", "VARIANTS", "tile_dists",
           "build_pdx_cell", "local_fn", "run_variant", "main"]

N_VECTORS = 100_000_000
DIM = 1536
CAPACITY = 8192
QUERIES = 128
K = 10
INT8_SCALE = 0.02

VARIANTS = ["block", "dim", "block_matmul", "block_matmul_bf16",
            "block_matmul_int8", "block_pruned"]


def tile_dists(tile: torch.Tensor, Q: torch.Tensor, metric_bf16: bool = False) -> torch.Tensor:
    """(D, C) tile x (B, D) queries -> (B, C) f32 squared L2 distances in
    the matmul form: ||q||^2 - 2 q.x + ||x||^2, the product in the tile's
    compute dtype with an f32 result."""
    if tile.dtype == torch.int8:  # dequantize on read
        tile_c = tile.to(torch.bfloat16) * torch.tensor(INT8_SCALE, dtype=torch.bfloat16,
                                                        device=tile.device)
    elif metric_bf16:
        tile_c = tile.to(torch.bfloat16)
    else:
        tile_c = tile
    cross = (Q.to(tile_c.dtype) @ tile_c).to(torch.float32)
    qn = torch.sum(Q.to(torch.float32) ** 2, dim=1, keepdim=True)
    xn = torch.sum(tile_c.to(torch.float32) ** 2, dim=0, keepdim=True)
    return qn - 2.0 * cross + xn


def _scan_tiles_batched(data_l, ids_l, Q, k, metric_bf16=False):
    """(P_loc, D, C) x (B, D) -> the shard's TopK of every query, (B, k)."""
    state = topk_init(k, (Q.shape[0],), Q.device)
    for tile, tids in zip(data_l, ids_l):
        state = topk_merge(state, tile_dists(tile, Q, metric_bf16), tids)
    return state


def _scan_tiles_diff(data_l, ids_l, Q, k, pruned: bool = False, reduce=None):
    """The difference form over every query at once: per tile, (B, D, C)
    differences; ``pruned`` masks a column whose first 64 dims already put
    it past the merged threshold, ``reduce`` sums the partial distances
    across ranks (``dim``)."""
    state = topk_init(k, (Q.shape[0],), Q.device)
    for tile, tids in zip(data_l, ids_l):
        diff = tile.to(torch.float32)[None] - Q[:, :, None]
        d = torch.sum(diff * diff, dim=1)
        if reduce is not None:
            d = reduce(d)
        if pruned:  # ADSampling-style mask on the first 64 dims
            part = torch.sum(diff[:, :64] * diff[:, :64], dim=1)
            thr = topk_merge(state, d, tids).dists[:, -1:]
            d = torch.where(part * (DIM / 64.0) <= thr * (1.0 + 2.1 / 8.0) ** 2, d,
                            torch.inf)
        state = topk_merge(state, d, tids)
    return state


def _gather(t: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """Tiled all-gather over the ranks of ``axes`` (major to minor), one
    collective: a single axis's group, else the axes flattened into one."""
    if len(axes) == 1:
        return all_gather(t, mesh, axes[0])
    flat = mesh[axes]._flatten()
    return all_gather(t, flat, flat.mesh_dim_names[0])


def _merge_gathered(all_d, all_i, k):
    """(nrep * B, k) gathered states, rank-major -> the (B, k) merge of
    every rank's."""
    B = QUERIES
    d = all_d.reshape(-1, B, k).permute(1, 0, 2).reshape(B, -1)
    i = all_i.reshape(-1, B, k).permute(1, 0, 2).reshape(B, -1)
    merged = topk_merge(topk_init(k, (B,), all_d.device), d, i)
    return merged.dists, merged.ids


def local_fn(variant: str, mesh):
    """The per-rank body of ``variant`` on ``mesh``: local (data, ids, Q)
    shards -> the merged (QUERIES, K) dists and ids, the same on every rank
    (the reference's ``shard_map`` with ``out_specs=P()``)."""
    axes = tuple(mesh.mesh_dim_names)
    if variant.startswith("block"):
        def local(data_l, ids_l, Q_l):
            if "matmul" in variant:
                st = _scan_tiles_batched(data_l, ids_l, Q_l, K, metric_bf16="bf16" in variant)
            else:
                st = _scan_tiles_diff(data_l, ids_l, Q_l, K, pruned="pruned" in variant)
            return _merge_gathered(_gather(st.dists, mesh, axes),
                                   _gather(st.ids, mesh, axes), K)
        return local
    if variant == "dim":
        daxes = tuple(a for a in axes if a != "model")

        def local_dim(data_l, ids_l, Q_l):
            st = _scan_tiles_diff(data_l, ids_l, Q_l, K,
                                  reduce=lambda d: psum(d, mesh, "model"))
            return _merge_gathered(_gather(st.dists, mesh, daxes),
                                   _gather(st.ids, mesh, daxes), K)
        return local_dim
    raise ValueError(variant)


def build_pdx_cell(variant: str, mesh, dtype=torch.float32):
    """-> (per-rank fn, rank 0's meta shards (data, ids, Q), the ranks that
    run the body).  The partitions pad to a multiple of the ranks."""
    sizes = mesh_shape(mesh)
    nd = math.prod(sizes.values())
    n_parts = N_VECTORS // CAPACITY  # 12207 -> pad to a multiple of nd
    n_parts = ((n_parts + nd - 1) // nd) * nd
    store_dtype = dtype
    if "bf16" in variant:
        store_dtype = torch.bfloat16
    elif "int8" in variant:
        store_dtype = torch.int8
    if variant.startswith("block"):   # every axis shards the partitions
        p_loc, d_loc, q_dim = n_parts // nd, DIM, DIM
    elif variant == "dim":            # dims over "model", partitions over the rest
        p_loc, d_loc = n_parts // (nd // sizes["model"]), DIM // sizes["model"]
        q_dim = d_loc
    else:
        raise ValueError(variant)

    def meta(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")

    args = (meta((p_loc, d_loc, CAPACITY), store_dtype), meta((p_loc, CAPACITY), torch.int32),
            meta((QUERIES, q_dim), torch.float32))
    return local_fn(variant, mesh), args, nd


def run_variant(variant: str, mesh_name: str, out_dir: str) -> dict:
    """One variant's record (written to ``out_dir`` when it is given);
    opens the mesh's fake world unless a process group is open."""
    import torch.distributed as dist

    rec = {"arch": f"pdx-search-{variant}", "shape": "batch128_100Mx1536",
           "mesh": mesh_name, "step": "search"}
    if not dist.is_initialized():
        open_world(mesh_name)
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi_pod"), device="cpu")
    try:
        t0 = time.time()
        fn, args, nd = build_pdx_cell(variant, mesh)
        jcost = step_cost(fn, *args, ranks=nd)
        _, coll, mem = memory_trace(fn, *args)
        dt = time.time() - t0
        rec.update(
            status="ok", lower_s=round(dt, 2), compile_s=0.0, jaxpr_cost=jcost,
            collectives=coll, memory=mem, n_devices=nd,
            params_total=float(N_VECTORS) * DIM, params_active=float(N_VECTORS) * DIM,
            tokens=QUERIES,
        )
        print(f"[dryrun-pdx] {variant} x {mesh_name}: OK meta run {dt:.1f}s "
              f"flops={jcost['flops']:.3e} coll={coll['total']:.3e}B", flush=True)
        print(f"  memory: {mem}", flush=True)
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-2500:])
        print(f"[dryrun-pdx] {variant} x {mesh_name}: FAIL {e}", flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(
            out_dir, f"pdx-search-{variant}__batch128__{mesh_name}.json"
        ), "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", default=None, choices=VARIANTS)
    ap.add_argument("--mesh", default="single_pod",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--out", default="results/dryrun_pdx_torch")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    variants = [args.variant] if args.variant else VARIANTS
    meshes = ["single_pod", "multi_pod"] if args.mesh == "both" else [args.mesh]
    fails = 0
    for m in meshes:
        open_world(m)
        for v in variants:
            fails += run_variant(v, m, args.out)["status"] == "error"
        dist.destroy_process_group()
    print(f"[dryrun-pdx] done, {fails} failures", flush=True)
    raise SystemExit(1 if fails else 0)


if __name__ == "__main__":
    main()
