"""Train-step construction (counterpart of ``repro.train.trainer``): loss ->
grads (autograd, each unit recomputed in the backward pass) -> optional
error-feedback compression -> clip -> AdamW or Adafactor, in place.

Where the reference takes ``jax.value_and_grad`` under ``jit``, the port
runs the step eagerly on the params' device: the params' leaves require
grad only inside the step, ``torch.autograd.grad`` returns the grads
(the tied embedding's sums the lookup's and the head's), and
``opt_update`` writes the new params and state into the old tensors.
Gradient accumulation sums each micro-batch's grads into f32 zeros in
the reference's order, then multiplies by ``1 / accum_steps``.

The same step trains params spread over a mesh: DTensor params, optimizer
state and batch (``dist.sharding``), run inside
``dist.hints.activation_sharding``.  Each grad then comes back on its
param's placements (a partial sum over the data axes becomes a
reduce-scatter, the FSDP grad), so the in-place update stays on every
rank's own shard.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from ..models.lm import LMModel
from ._tree import leaves, unflatten
from .compression import ef_compress
from .optimizer import OptConfig, opt_init, opt_update

__all__ = ["TrainConfig", "make_train_step", "init_train_state"]


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    opt: OptConfig = OptConfig()
    accum_steps: int = 1
    compress_grads: bool = False
    remat: bool = True


def init_train_state(model: LMModel, generator: torch.Generator, opt_cfg: OptConfig,
                     dtype=torch.float32, *, device=None):
    """-> (params drawn from ``generator`` on ``device``, zero optimizer
    state); ``device=None`` means the CUDA card."""
    params = model.init(generator, dtype=dtype, device=device)
    return params, opt_init(params, opt_cfg)


def _batch_tensors(batch: dict, device) -> dict:
    """The batch as tensors on ``device``; a DTensor stays as it is."""
    from torch.distributed.tensor import DTensor

    return {k: v if isinstance(v, DTensor) else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


def _on_param_layout(g: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A DTensor param's grad on the param's placements."""
    from torch.distributed.tensor import DTensor

    if isinstance(p, DTensor) and tuple(g.placements) != tuple(p.placements):
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(model: LMModel, tc: TrainConfig = TrainConfig()) -> Callable:
    """Returns train_step(params, opt_state, batch[, ef_state]) ->
    (params, opt_state, metrics[, ef_state]); ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-d tensors.  ``params`` and the states
    are updated in place and returned."""

    def value_and_grad(params, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        try:
            loss = model.loss(params, batch, remat=tc.remat)
            # a leaf the loss does not reach (DeepSeek-V3's router bias
            # only orders the experts) gets zeros, as jax.grad gives it
            grads = [_on_param_layout(g, p) for g, p in zip(
                torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True),
                flat)]
        finally:
            for p in flat:
                p.requires_grad_(False)
        return loss.detach(), unflatten(params, grads)

    def compute_grads(params, batch):
        batch = _batch_tensors(batch, leaves(params)[0].device)
        if tc.accum_steps == 1:
            return value_and_grad(params, batch)
        B = next(iter(batch.values())).shape[0]
        if B % tc.accum_steps:
            raise ValueError(f"batch {B} does not split into {tc.accum_steps} micro-batches")
        micro = B // tc.accum_steps
        loss_sum = torch.zeros((), dtype=torch.float32, device=leaves(params)[0].device)
        g_sum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for p in leaves(params)]
        for i in range(tc.accum_steps):
            mb = {k: v[i * micro:(i + 1) * micro] for k, v in batch.items()}
            loss, g = value_and_grad(params, mb)
            loss_sum = loss_sum + loss
            for a, c in zip(g_sum, leaves(g)):
                a.add_(c.to(a.dtype))
            del g
        inv = 1.0 / tc.accum_steps
        return loss_sum * inv, unflatten(params, [a.mul_(inv) for a in g_sum])

    if tc.compress_grads:

        def train_step(params, opt_state, batch, ef_state):
            loss, grads = compute_grads(params, batch)
            grads, ef_state = ef_compress(grads, ef_state)
            params, opt_state, metrics = opt_update(grads, opt_state, params, tc.opt)
            metrics["loss"] = loss
            return params, opt_state, metrics, ef_state

        return train_step

    def train_step(params, opt_state, batch):
        loss, grads = compute_grads(params, batch)
        params, opt_state, metrics = opt_update(grads, opt_state, params, tc.opt)
        metrics["loss"] = loss
        return params, opt_state, metrics

    return train_step

