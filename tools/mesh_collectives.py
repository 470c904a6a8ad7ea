#!/usr/bin/env python3
"""The collectives of a reduced config's default train step (no hints) on a
(2, 4) ("data", "model") mesh, the reference's against the port's: which
kinds each issues, how many bytes, and over which mesh axes.

    PYTHONPATH=src python tools/mesh_collectives.py --arch deepseek-moe-16b \\
        [--port-src OTHER/src] [--seq 64] [--batch 8]

The reference's side compiles its ``launch.dryrun.build_cell`` step with
its ``param_shardings`` on 8 fake CPU devices and reads the partitioned
HLO: count and bytes by kind (``collective_bytes_hlo``), and each
collective's replica groups named by the axes they span ("data",
"model", or both), and the shapes of its partitioned products (``dots``,
forward and backward). The port's side runs its ``build_cell`` step with the
anchors off (as ``launch/dryrun.py`` runs a cell without ``--hints``) on
meta tensors over a fake group of 8 and gives rank 0's count and bytes by
kind (``analysis.memory_trace``); ``--port-src`` points it at another
tree (a parent commit's ``src``). Each side runs in a subprocess of its
own, on the CPU; about a minute for an MoE config. Prints one JSON object
a side.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]

_REFERENCE = r"""
import collections, json, os, re, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import base, get_config
from repro.launch import dryrun
from repro.launch.analysis import collective_bytes_hlo

arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dryrun.get_config = lambda a: get_config(a).reduced()
dryrun.SHAPES["cell"] = base.ShapeSpec("cell", seq, batch, "train")
mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "model"))
fn, args, shardings, _ = dryrun.build_cell(arch, "cell", mesh, dtype=jnp.float32)
with mesh:
    hlo = jax.jit(fn, in_shardings=shardings).lower(*args).compile().as_text()

def groups(line):
    # the replica groups of one collective, as lists of device ids
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?", line)
    if m:
        ids = np.arange(int(np.prod([int(d) for d in m.group(3).split(",")])))
        ids = ids.reshape([int(d) for d in m.group(3).split(",")])
        if m.group(4):
            ids = ids.transpose([int(d) for d in m.group(4).split(",")])
        return ids.reshape(int(m.group(1)), int(m.group(2))).tolist()
    m = re.search(r"replica_groups=\{(\{[\d,]*\}(?:,\{[\d,]*\})*)\}", line)
    if m:
        return [[int(d) for d in g.split(",") if d] for g in re.findall(r"\{([\d,]*)\}", m.group(1))]
    return None

def axes(gs):
    # the mesh axes a collective's groups span (device d sits at divmod(d, 4))
    if not gs or max(len(g) for g in gs) <= 1:
        return "none"
    span = {name for g in gs for name, i in (("data", 0), ("model", 1))
            if len({divmod(d, 4)[i] for d in g}) > 1}
    return "+".join(sorted(span)) or "none"

by_axes = collections.Counter()
for line in hlo.splitlines():
    m = re.search(r" (all-reduce|all-gather|reduce-scatter|all-to-all)(?:-start)?\(", line)
    if m:
        by_axes[m.group(1) + " over " + axes(groups(line))] += 1
coll = collective_bytes_hlo(hlo)
dots = sorted(set(re.findall(r"= (\w+\[[\d,]*\])(?:\{[\d,]*\})? dot\(", hlo)))
print(json.dumps({"side": "reference", "arch": arch, "bytes": coll["bytes"],
                  "count": coll["count"], "count_by_axes": dict(sorted(by_axes.items())),
                  "dots": dots}))
"""

_PORT = r"""
import json, sys
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs import ShapeSpec, get_config
from repro_torch.dist import hints, make_mesh
from repro_torch.dist.sharding import device_put
from repro_torch.launch import analysis, dryrun

arch, seq, batch = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
mesh = make_mesh((2, 4), ("data", "model"), device="cpu")
dryrun.get_config = lambda a: get_config(a).reduced()
fn, args, shardings, _ = dryrun.build_cell(arch, ShapeSpec("cell", seq, batch, "train"), mesh,
                                           dtype=torch.float32)
args = device_put(args, shardings)
with hints.activation_sharding(mesh, anchor=False):
    _, coll, _ = analysis.memory_trace(fn, *args)
print(json.dumps({"side": "port", "arch": arch, "bytes": coll["bytes"], "count": coll["count"]}))
"""


def run_side(code: str, src: pathlib.Path, arch: str, seq: int, batch: int,
             env_extra: dict | None = None) -> dict:
    """One side's JSON line, run in a subprocess on the CPU."""
    env = dict(os.environ, PYTHONPATH=str(src), JAX_PLATFORMS="cpu", **(env_extra or {}))
    run = subprocess.run([sys.executable, "-c", code, arch, str(seq), str(batch)], env=env,
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    if run.returncode:
        raise RuntimeError(run.stderr[-4000:])
    return json.loads(run.stdout.strip().splitlines()[-1])


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--port-src", default=str(ROOT / "src"))
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    a = ap.parse_args(argv)
    ref = run_side(_REFERENCE, ROOT / "src", a.arch, a.seq, a.batch,
                   {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    print(json.dumps(ref))
    print(json.dumps(run_side(_PORT, pathlib.Path(a.port_src), a.arch, a.seq, a.batch)))


if __name__ == "__main__":
    main()
