"""Training entry point (counterpart of ``repro.launch.train``): config-driven,
fault-tolerant, resumable, on the CUDA card unless ``--device cpu`` is
given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --reduced --steps 100 --batch 8 --seq 128 --ckpt-dir ck
    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-3b \\
        --reduced --steps 5 --batch 2 --seq 32 --device cpu

Wires together the model, the deterministic data pipeline with prefetch
(batches copied to the device on the prefetch thread), AdamW/Adafactor,
the remat train step, async checkpointing with resume from the newest
checkpoint under ``ckpt_dir``, and the straggler monitor.  The weights are
drawn from a ``torch.Generator`` seeded with ``seed`` on the device (the
reference's ``jax.random`` init cannot be reproduced in torch).
"""
from __future__ import annotations

import argparse

import torch

from ..configs import get_config
from ..core.device import resolve_device
from ..data.pipeline import Prefetcher, TokenStream, to_device
from ..models.lm import build_model
from ..train import checkpoint as ckpt
from ..train.compression import ef_init
from ..train.optimizer import OptConfig, opt_init
from ..train.straggler import StepTimeMonitor
from ..train.trainer import TrainConfig, make_train_step

__all__ = ["train_loop", "main"]


def train_loop(
    arch: str,
    *,
    reduced: bool = True,
    steps: int = 50,
    batch: int = 4,
    seq: int = 64,
    lr: float = 1e-3,
    ckpt_dir: str | None = None,
    ckpt_every: int = 25,
    accum_steps: int = 1,
    compress_grads: bool = False,
    seed: int = 0,
    log_every: int = 10,
    opt_kind: str = "adamw",
    device=None,
) -> dict:
    """Train ``arch`` for ``steps`` steps (from the newest checkpoint under
    ``ckpt_dir``, if any) on ``device`` (``None`` means the CUDA card).
    -> {final_loss, history, median_step_s, straggler_steps}."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    oc = OptConfig(lr=lr, warmup_steps=min(100, steps // 10 + 1), kind=opt_kind)
    tc = TrainConfig(opt=oc, accum_steps=accum_steps, compress_grads=compress_grads)
    step_fn = make_train_step(model, tc)

    params = model.init(torch.Generator(device=dev).manual_seed(seed), device=dev)
    opt_state = opt_init(params, oc)
    start_step = 0
    saver = ckpt.AsyncCheckpointer(ckpt_dir) if ckpt_dir else None
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        start_step, tree = ckpt.restore(ckpt_dir, {"params": params, "opt": opt_state})
        params, opt_state = tree["params"], tree["opt"]
        print(f"[train] resumed from step {start_step}")

    stream = TokenStream(cfg, seq, batch, seed=seed)
    pf = Prefetcher(stream.iter_from(start_step), place=to_device(dev))
    mon = StepTimeMonitor()
    ef_state = ef_init(params) if compress_grads else None

    history = []
    try:
        for step in range(start_step, steps):
            b = pf.next()
            mon.start()
            if compress_grads:
                params, opt_state, metrics, ef_state = step_fn(params, opt_state, b, ef_state)
            else:
                params, opt_state, metrics = step_fn(params, opt_state, b)
            loss = float(metrics["loss"])
            dt, slow = mon.stop()
            history.append(loss)
            if step % log_every == 0 or step == steps - 1:
                print(f"[train] step {step} loss {loss:.4f} "
                      f"({dt*1e3:.0f} ms{' STRAGGLER' if slow else ''})")
            if saver and (step + 1) % ckpt_every == 0:
                saver.save(step + 1, {"params": params, "opt": opt_state})
    finally:
        pf.close()
        if saver:
            saver.wait()
    return {"final_loss": history[-1], "history": history,
            "median_step_s": mon.median, "straggler_steps": mon.flagged}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--opt", default="adamw", choices=["adamw", "adafactor"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run on the CPU)")
    args = ap.parse_args(argv)
    out = train_loop(
        args.arch, reduced=args.reduced, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every, accum_steps=args.accum_steps,
        compress_grads=args.compress_grads, opt_kind=args.opt, device=args.device,
    )
    print(f"[train] done: final_loss={out['final_loss']:.4f} "
          f"median_step={out['median_step_s']*1e3:.0f}ms")


if __name__ == "__main__":
    main()
