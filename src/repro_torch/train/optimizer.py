"""AdamW + Adafactor with dtype-configurable moments (counterpart of
``repro.train.optimizer``).

``opt_update`` keeps the reference's signature and return values, but it
updates the params and the optimizer state in place, leaf by leaf, under
``torch.no_grad()``: the reference's functional update would hold a new
params/``mu``/``nu`` tree and a clipped copy of the grads beside the old
ones, which at llama3.2-3b's width (12.85 GB a tree at f32) does not fit
on an 80 GB card.  Each leaf is clipped as it is updated, and every
element goes through the reference's arithmetic in its order (f32 math,
moments stored in ``state_dtype``).  At most two leaf-sized f32
temporaries live at a time.  The grads are read, never written.

The step count is a 0-d int32 tensor; the learning rate and the bias
corrections are f32 tensors computed from it, as XLA computes them, not
Python doubles.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ._tree import leaves, tree_map

__all__ = ["OptConfig", "opt_init", "opt_update", "global_norm", "clip_by_global_norm"]

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: Any = torch.float32  # bf16 for the largest configs
    warmup_steps: int = 100
    kind: str = "adamw"               # adamw | adafactor


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def opt_init(params, cfg: OptConfig) -> dict:
    """Zero state on the params' device."""
    dev = leaves(params)[0].device

    def zeros(shape, dtype=F32):
        return torch.zeros(shape, dtype=dtype, device=dev)

    step = zeros((), torch.int32)
    if cfg.kind == "adafactor":
        def vc(p):  # col accumulator (drop second-to-last dim)
            if _factored(p.shape):
                return zeros(p.shape[:-2] + p.shape[-1:])
            return zeros((1,))  # unused for unfactored

        def vfull(p):
            return zeros((1,)) if _factored(p.shape) else zeros(p.shape)

        return {
            "vr": tree_map(lambda p: zeros(p.shape[:-1]), params),  # row accumulator
            "vc": tree_map(vc, params),
            "v": tree_map(vfull, params),
            "step": step,
        }
    return {
        "mu": tree_map(lambda p: zeros(p.shape, cfg.state_dtype), params),
        "nu": tree_map(lambda p: zeros(p.shape, cfg.state_dtype), params),
        "step": step,
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's f32 sum of squares, leaves in the
    reference's order."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32))) for x in leaves(tree)))


def _clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """-> (clipped grads, norm): a new tree, as in the reference."""
    norm = global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), norm


def _clipped(g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """A new f32 tensor: ``g`` clipped (in f32, rounded to its dtype)."""
    out = g.to(F32) * scale
    return out if g.dtype == F32 else out.to(g.dtype).to(F32)


def _schedule(step: torch.Tensor, cfg: OptConfig) -> torch.Tensor:
    warm = torch.clamp(step.to(F32) / max(cfg.warmup_steps, 1), max=1.0)
    return cfg.lr * warm


def _f32(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself at f32 (updated in place), else an f32 copy to store back."""
    return x if x.dtype == F32 else x.to(F32)


def _adamw_leaf(p, g, mu, nu, scale, lr, bc1, bc2, cfg: OptConfig) -> None:
    g32 = _clipped(g, scale)
    tmp = torch.mul(g32, 1 - cfg.b1)
    mu32, nu32, p32 = _f32(mu), _f32(nu), _f32(p)
    mu32.mul_(cfg.b1).add_(tmp)                       # mu b1 + g (1 - b1)
    g32.mul_(g32).mul_(1 - cfg.b2)
    nu32.mul_(cfg.b2).add_(g32)                       # nu b2 + g g (1 - b2)
    den = torch.div(nu32, bc2, out=g32).sqrt_().add_(cfg.eps)
    delta = torch.div(mu32, bc1, out=tmp).div_(den)   # mhat / (sqrt(vhat) + eps)
    delta.add_(torch.mul(p32, cfg.weight_decay, out=den))
    p32.sub_(delta.mul_(lr))
    for dst, src in ((p, p32), (mu, mu32), (nu, nu32)):
        if dst is not src:
            dst.copy_(src)


def _adafactor_leaf(p, g, vr, vc, v, scale, lr, beta2, cfg: OptConfig) -> None:
    g32 = _clipped(g, scale)
    g2 = torch.mul(g32, g32).add_(1e-30)
    if _factored(p.shape):
        vr.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-1))
        vc.mul_(beta2).add_((1 - beta2) * torch.mean(g2, dim=-2))
        r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
        precond = torch.mul(r[..., None], vc[..., None, :], out=g2)
        update = g32.mul_(precond.add_(1e-30).rsqrt_())
    else:
        v.mul_(beta2).add_(g2.mul_(1 - beta2))
        update = g32.mul_(torch.add(v, 1e-30, out=g2).rsqrt_())
    # relative update clipping (Adafactor d = 1.0)
    rms_u = torch.sqrt(torch.mean(update * update) + 1e-30)
    update.div_(torch.clamp(rms_u, min=1.0))
    p32 = _f32(p)
    decay = torch.mul(p32, lr * cfg.weight_decay, out=g2)
    p32.sub_(update.mul_(lr)).sub_(decay)             # p - lr u - lr wd p
    if p32 is not p:
        p.copy_(p32)


@torch.no_grad()
def opt_update(grads, state: dict, params, cfg: OptConfig):
    """-> (params, state, metrics), the params and the state's tensors
    updated in place; ``metrics`` holds ``grad_norm`` and ``lr``."""
    gnorm = global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = state["step"] + 1
    lr = _schedule(step, cfg)
    t = step.to(F32)
    flat_p, flat_g = leaves(params), leaves(grads)
    if cfg.kind == "adafactor":
        beta2 = 1.0 - t ** (-0.8)  # Adafactor's increasing decay schedule
        for p, g, vr, vc, v in zip(flat_p, flat_g, leaves(state["vr"]),
                                   leaves(state["vc"]), leaves(state["v"])):
            _adafactor_leaf(p, g, vr, vc, v, scale, lr, beta2, cfg)
        new_state = {"vr": state["vr"], "vc": state["vc"], "v": state["v"], "step": step}
    else:
        bc1 = 1.0 - cfg.b1 ** t
        bc2 = 1.0 - cfg.b2 ** t
        for p, g, mu, nu in zip(flat_p, flat_g, leaves(state["mu"]), leaves(state["nu"])):
            _adamw_leaf(p, g, mu, nu, scale, lr, bc1, bc2, cfg)
        new_state = {"mu": state["mu"], "nu": state["nu"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}
