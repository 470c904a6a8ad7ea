"""The serving entry point (counterpart of ``repro.launch.serve``): batched
generation with optional PDX retrieval (RAG), on the CUDA card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-3b \\
        --requests 8 --max-new 16 --rag
    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b --reduced \\
        --requests 4 --max-new 8 --rag --device cpu

The weights are random, drawn from a ``torch.Generator`` seeded with 0 on
the device: no checkpoint is read.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.device import resolve_device
from ..models.lm import build_model
from ..serve.engine import GenerationEngine
from ..serve.rag import RagPipeline

__all__ = ["main"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--rag", action="store_true")
    ap.add_argument("--docs", type=int, default=64)
    ap.add_argument("--pruner", default="adsampling")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    # a VLM's patch embeddings take cache rows before the prompt
    cache_len = args.prompt_len * 3 + args.max_new + 8 + (cfg.n_patches if cfg.vlm else 0)
    eng = GenerationEngine(model=model, params=params, cache_len=cache_len)

    rng = np.random.default_rng(0)
    batch = {
        "tokens": rng.integers(
            0, cfg.vocab, (args.requests, args.prompt_len)
        ).astype(np.int32)
    }
    if cfg.vlm:
        batch["vision_embeds"] = rng.standard_normal(
            (args.requests, cfg.n_patches, cfg.d_model)
        ).astype(np.float32)
    if cfg.encdec:
        batch["enc_frames"] = rng.standard_normal(
            (args.requests, cfg.enc_seq, cfg.d_model)
        ).astype(np.float32)

    if args.rag:
        docs = rng.integers(0, cfg.vocab, (args.docs, args.prompt_len)).astype(
            np.int32
        )
        rag = RagPipeline.build(eng, docs, pruner=args.pruner, device=dev)
        t0 = time.perf_counter()
        out, doc_ids = rag.answer(batch, max_new_tokens=args.max_new)
        dt = time.perf_counter() - t0
        print(f"[serve] RAG answered {args.requests} reqs in {dt*1e3:.0f}ms; "
              f"retrieved docs {doc_ids[:, 0].tolist()}")
    else:
        t0 = time.perf_counter()
        out = eng.generate(batch, max_new_tokens=args.max_new)
        dt = time.perf_counter() - t0
    tput = args.requests * args.max_new / dt
    print(f"[serve] {cfg.name} on {dev}: generated {out.shape} tokens, {tput:.1f} tok/s")
    print(f"[serve] first row: {out[0].tolist()}")


if __name__ == "__main__":
    main()
