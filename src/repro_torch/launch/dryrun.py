"""Multi-pod dry-run (counterpart of ``repro.launch.dryrun``): every
(architecture x input-shape x mesh) cell's step runs on meta tensors
(shapes and dtypes, no storage) over a one-process ``fake`` process group
of the production mesh's 256 or 512 ranks, and its roofline terms (FLOPs,
bytes, collective bytes by kind, memory) go into one JSON record a cell.
Nothing is allocated on any device, as the reference's ShapeDtypeStructs
allocate nothing; the mesh is a CPU ``DeviceMesh`` over the fake group.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape decode_32k --mesh single_pod --out results/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out results/dryrun_torch

The world.  ``open_world`` initialises ``dist.init_process_group("fake",
store=FakeStore(), rank=0, world_size=256|512)``; one process has one
world, so ``--mesh both`` destroys it and opens the next.  The process is
rank 0, which holds the largest shard wherever a split is uneven, and its
numbers are the record's.

The record keeps the reference's keys, so one reader takes both:
``status``, ``arch``, ``shape``, ``mesh``, ``tag``, ``step``,
``n_devices``, ``params_total``, ``params_active``, ``tokens`` and
``collectives`` (``analysis.collective_bytes``: each collective's result
bytes on rank 0, by the reference's kind names) mean what they mean
there.  These differ:

* ``jaxpr_cost`` holds ``analysis.step_cost`` of the step on *unsharded*
  meta tensors, the global program the reference's jaxpr is; no jaxpr is
  involved.
* ``memory`` gives rank 0's bytes over the sharded meta run
  (``analysis.memory_trace``): ``argument_size_in_bytes`` the local shards
  of the arguments, ``output_size_in_bytes`` the outputs that do not alias
  an argument, ``peak_memory_in_bytes`` the high-water mark of live
  storages, arguments included, and ``temp_size_in_bytes`` that peak less
  the arguments and the outputs.
* ``lower_s`` is the seconds of building the cell and of both meta runs;
  ``compile_s`` is 0, and ``cost`` (XLA's ``cost_analysis``) is ``{}``:
  nothing is compiled.
* ``levers`` records the flags the cell ran under.

The levers.  ``--hints`` runs the step under
``hints.activation_sharding(mesh)``; without it the step runs under
``activation_sharding(mesh, anchor=False)``, which keeps only the reshards
DTensor needs where GSPMD reshards by itself.  ``--infer-params`` strips
the data axes from the params' shardings (weight-stationary serving);
``--kv-dtype bf16|f8`` stores the decode caches narrower
(``LMModel.init_caches(kv_dtype=)``); ``--no-remat`` trains without
recomputing the units.  ``--out-shardings`` has no eager counterpart: the
port's step always returns the params, the state and the grads on their
own placements, so the flag is accepted and recorded only.

Where a cell fails its record says ``status: "error"`` with the trace, the
run goes on, and the exit code is 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import time
import traceback

import torch

from ..configs import SHAPES, get_config, list_configs, shape_is_applicable
from ..configs.base import ShapeSpec
from ..dist import hints
from ..dist.sharding import (
    NamedSharding,
    PartitionSpec as P,
    batch_shardings,
    cache_shardings,
    data_axes,
    device_put,
    param_shardings,
    strip_axes,
)
from ..models.lm import build_model
from ..train._tree import flatten_with_paths, tree_map
from ..train.optimizer import OptConfig, opt_init
from ..train.trainer import TrainConfig, make_train_step
from .analysis import memory_trace, step_cost
from .mesh import MESH_SHAPES, make_production_mesh
from .specs import input_specs

__all__ = ["OPT_KIND", "count_params", "build_cell", "run_cell", "open_world", "main"]

# Per-arch training policy (the reference's production choices)
OPT_KIND = {"deepseek-v3-671b": "adafactor"}

KV_DTYPES = {None: None, "bf16": torch.bfloat16, "f8": torch.float8_e4m3fn}


def count_params(params_abs, path_prefix=()) -> tuple[float, float]:
    """(total, non-expert) parameter counts of a tree of tensors; routed-
    expert tensors (stacked (L, E, d, f)) count in the total only, and the
    caller adds their top_k / E share to 'active'."""
    total = active = 0.0
    for path, leaf in flatten_with_paths(params_abs, tuple(path_prefix)):
        n = float(math.prod(leaf.shape))
        total += n
        keys = [str(k) for k in path]
        if keys[-1] in ("w_gate", "w_up", "w_down") and len(leaf.shape) == 4 \
                and "shared" not in keys:
            continue
        active += n
    return total, active


def open_world(mesh_name: str) -> None:
    """A one-process ``fake`` process group of the mesh's ranks, this
    process rank 0 (any group already open is destroyed first).  The fake
    group's module is imported here, never when this module is."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(MESH_SHAPES[mesh_name][0]))


def build_cell(
    arch: str, shape_name, mesh, dtype=torch.bfloat16,
    kv_dtype=None, remat=True, infer_params: bool = False,
):
    """-> (fn, args, shardings, out_shardings): the step, its unsharded
    meta arguments, their shardings on ``mesh`` (a tree of the same
    structure) and ``None`` (no eager counterpart; see the module).

    ``shape_name`` is a name in ``SHAPES`` or a ``ShapeSpec``: the second
    is a test hook, so that a cell a single card holds can be built.
    ``kv_dtype``: decode-cache storage dtype (f8 KV); ``remat``: recompute
    each unit in the train step's backward pass; ``infer_params``:
    weight-stationary serving, the params sharded over the model axis only.
    """
    cfg = get_config(arch)
    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    model = build_model(cfg)
    batch_abs = input_specs(cfg, shape, dtype=dtype)
    bsh = batch_shardings(batch_abs, mesh)
    with torch.device("meta"):
        params_abs = model._draw(torch.Generator(), dtype)
    psh = param_shardings(params_abs, mesh, cfg)
    if infer_params and shape.step != "train":
        psh = strip_axes(psh, data_axes(mesh))

    if shape.step == "train":
        oc = OptConfig(kind=OPT_KIND.get(arch, "adamw"))
        opt_abs = opt_init(params_abs, oc)
        # the state is replicated, but for the moments that mirror the
        # params (AdamW); Adafactor's factored accumulators stay replicated
        osh = tree_map(lambda leaf: NamedSharding(mesh, P()), opt_abs)
        if "mu" in opt_abs:
            osh["mu"], osh["nu"] = psh, psh
        step_fn = make_train_step(model, TrainConfig(opt=oc, remat=remat))
        return step_fn, (params_abs, opt_abs, batch_abs), (psh, osh, bsh), None

    if shape.step == "prefill":
        @torch.no_grad()
        def prefill_fn(params, batch):
            return model.prefill(params, batch, cache_len=shape.seq_len)

        return prefill_fn, (params_abs, batch_abs), (psh, bsh), None

    # decode: one new token against a seq_len cache
    caches_abs = model.init_caches(shape.global_batch, shape.seq_len, dtype,
                                   kv_dtype=kv_dtype, device="meta")
    csh = cache_shardings(caches_abs, mesh, cfg)
    pos = shape.seq_len - 1

    @torch.no_grad()
    def decode_fn(params, caches, tokens):
        return model.decode_step(params, tokens["tokens"], caches, pos)

    return decode_fn, (params_abs, caches_abs, batch_abs), (psh, csh, bsh), None


def _fname(arch, shape_name, mesh_name, tag) -> str:
    return f"{arch}__{shape_name}__{mesh_name}{tag}.json".replace("/", "_")


def _write(rec: dict, out_dir: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, _fname(rec["arch"], rec["shape"], rec["mesh"],
                                               rec["tag"])), "w") as f:
            json.dump(rec, f, indent=1)


def run_cell(
    arch: str, shape_name, mesh_name: str, out_dir: str,
    kv_dtype=None, remat=True, tag: str = "", use_hints: bool = False,
    infer_params: bool = False, out_shardings: bool = False,
) -> dict:
    """One cell's record (written to ``out_dir`` when it is given).  Opens
    the mesh's fake world unless a process group is open; the mesh raises
    if that group's world is not the mesh's size."""
    import torch.distributed as dist

    shape = shape_name if isinstance(shape_name, ShapeSpec) else SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape.name, "mesh": mesh_name, "tag": tag}
    cfg = get_config(arch)
    ok, why = shape_is_applicable(cfg, shape.name)
    if not ok:
        rec.update(status="skipped", reason=why)
        _write(rec, out_dir)
        return rec
    if not dist.is_initialized():
        open_world(mesh_name)
    mesh = make_production_mesh(multi_pod=(mesh_name == "multi_pod"), device="cpu")
    try:
        t0 = time.time()
        fn, args, shardings, _ = build_cell(arch, shape, mesh, kv_dtype=kv_dtype,
                                            remat=remat, infer_params=infer_params)
        # the global cost: the same step on the unsharded meta arguments
        jcost = step_cost(fn, *args)
        p_total, p_nonexpert = count_params(args[0])
        frac = (cfg.top_k / cfg.n_experts) if cfg.moe else 0.0
        p_active = p_nonexpert + (p_total - p_nonexpert) * frac
        sharded = device_put(args, shardings)
        ctx = (hints.activation_sharding(mesh, data_axes(mesh)) if use_hints
               else hints.activation_sharding(mesh, data_axes(mesh), anchor=False))
        with ctx:
            _, coll, mem = memory_trace(fn, *sharded)
        t_lower = time.time() - t0
        rec.update(
            status="ok",
            lower_s=round(t_lower, 2),
            compile_s=0.0,
            memory=mem,
            cost={},
            jaxpr_cost=jcost,
            collectives=coll,
            n_devices=int(mesh.size()),
            params_total=p_total,
            params_active=p_active,
            tokens=(shape.global_batch * shape.seq_len
                    if shape.step in ("train", "prefill") else shape.global_batch),
            step=shape.step,
            levers={"kv_dtype": None if kv_dtype is None else str(kv_dtype).split(".")[-1],
                    "remat": remat, "hints": use_hints, "infer_params": infer_params,
                    "out_shardings": out_shardings},
        )
        print(f"[dryrun] {arch} x {shape.name} x {mesh_name}: OK "
              f"(meta run {t_lower:.1f}s flops={jcost['flops']:.3e} "
              f"coll={coll['total']:.3e}B)", flush=True)
        print(f"  memory: {mem}", flush=True)
    except Exception as e:  # noqa: BLE001 -- record and continue
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-3000:])
        print(f"[dryrun] {arch} x {shape.name} x {mesh_name}: FAIL {e}", flush=True)
        traceback.print_exc()
    _write(rec, out_dir)
    return rec


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--mesh", default="single_pod",
                    choices=["single_pod", "multi_pod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--kv-dtype", default=None, choices=[None, "bf16", "f8"],
                    help="decode-cache dtype (perf lever)")
    ap.add_argument("--no-remat", action="store_true",
                    help="disable activation checkpointing (perf lever)")
    ap.add_argument("--hints", action="store_true",
                    help="anchor activation shardings (perf lever)")
    ap.add_argument("--infer-params", action="store_true",
                    help="weight-stationary serving sharding (perf lever)")
    ap.add_argument("--out-shardings", action="store_true",
                    help="recorded only: the eager step keeps its placements")
    ap.add_argument("--tag", default="", help="suffix for the result file")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    archs = list_configs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single_pod", "multi_pod"] if args.mesh == "both" else [args.mesh]
    n_fail = 0
    for mesh_name in meshes:
        open_world(mesh_name)
        for arch in archs:
            for shape_name in shapes:
                rec = run_cell(
                    arch, shape_name, mesh_name, args.out,
                    kv_dtype=KV_DTYPES[args.kv_dtype], remat=not args.no_remat,
                    tag=args.tag, use_hints=args.hints, infer_params=args.infer_params,
                    out_shardings=args.out_shardings,
                )
                n_fail += rec["status"] == "error"
        with contextlib.suppress(Exception):
            dist.destroy_process_group()
    print(f"[dryrun] done, {n_fail} failures", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
