#!/usr/bin/env python3
"""Time the port's training on one CUDA card outside ``chip_smoke.py``, with
the port taken from any tree, so that a change and its parent can be timed
in turns within one call.

    python tools/chip_phases.py [--src DIR] [--seed 0] PHASE [PHASE ...]

PHASE is ``train``: phase ``train``'s step on its own (llama3.2-3b at full
width, f32, params drawn on the card from ``--seed``, AdamW at
``TRAIN_LR``, remat, ``TRAIN_STEPS`` steps on one ``TokenStream`` batch of
``TRAIN_BATCH`` x ``TRAIN_SEQ``, timed by ``chip_smoke._timed_steps``),
``train_families``: ``chip_smoke.train_families_phase`` itself, or
``mesh_lm``: ``chip_smoke.mesh_lm_phase`` itself (its own NCCL world of
one; no decode of phase ``lm`` to set beside its own).  The
helpers always come from this tree's ``chip_smoke.py``; ``--src`` is the
``src/`` directory whose ``repro_torch`` they run (default: this tree's;
a parent unpacked with ``git archive`` under ``build/`` works too, for
``train``).  Prints one JSON line a phase (``train_families`` prints its
own lines, then a done line).  Needs the card.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def train_step(torch, cs, dev, seed: int) -> dict:
    """``chip_smoke._timed_steps`` over phase ``train``'s step on fresh
    params -> the step walls, peak memory and the profiled step."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import TokenStream, to_device
    from repro_torch.models.lm import build_model
    from repro_torch.train import trainer
    from repro_torch.train.optimizer import OptConfig, opt_init

    cfg = get_config(cs.LM_ARCH)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    batch = to_device(dev)(TokenStream(cfg, cs.TRAIN_SEQ, cs.TRAIN_BATCH, seed).batch_at(0))
    oc = OptConfig(lr=cs.TRAIN_LR, warmup_steps=0)
    step = trainer.make_train_step(model, trainer.TrainConfig(opt=oc))
    state = opt_init(params, oc)
    torch.cuda.reset_peak_memory_stats()
    steps = cs._timed_steps(torch, step, params, state, batch)
    prof = steps.pop("profiled_step")
    return {"arch": cfg.name, "batch": cs.TRAIN_BATCH, "seq": cs.TRAIN_SEQ, **steps,
            "peak_device_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profiled_step": {k: prof[k] for k in ("wall_ms", "device_busy_ms",
                                                    "device_idle_share", "top")}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="+", choices=("train", "train_families", "mesh_lm"))
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path[:0] = [args.src, str(ROOT)]

    import torch

    if not torch.cuda.is_available():
        print("chip_phases: no CUDA device available", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels.batched_matmul import batched_distance_quant_cuda
    from repro_torch.kernels.pdx_scan import (
        pdx_prune_scan_multi_cuda, pdx_prune_scan_multi_prefetch_cuda,
    )

    dev = torch.device("cuda")
    counters = {"k1": pdx_prune_scan_multi_cuda, "k2": batched_distance_quant_cuda,
                "k3": pdx_prune_scan_multi_prefetch_cuda}
    print(cs.nvidia_smi(), flush=True)
    for phase in args.phases:
        t0 = time.perf_counter()
        if phase == "train":
            line = {"phase": "train_alone", **train_step(torch, cs, dev, args.seed)}
        elif phase == "train_families":
            cs.train_families_phase(torch, dev, args.seed, counters)
            line = {"phase": "train_families_alone"}
        else:
            cs.mesh_lm_phase(torch, dev, args.seed, None, counters)
            line = {"phase": "mesh_lm_alone"}
        gc.collect()
        torch.cuda.empty_cache()
        print(json.dumps({**line, "src": args.src, "seconds": time.perf_counter() - t0}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
