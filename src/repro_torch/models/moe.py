"""FFN blocks (counterpart of ``repro.models.moe``): the dense GLU FFN
(SwiGLU / GeGLU).  The routed Mixture-of-Experts (``moe_ffn``,
``pick_group_count``) is ported with the MoE family (ROADMAP, modules
item 2)."""
from __future__ import annotations

import torch

from .common import act_fn, dense_init

__all__ = ["dense_ffn"]


class dense_ffn:
    @staticmethod
    def init(generator: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32,
             lead: tuple = ()) -> dict:
        """``lead``: leading axes (a stack's unit count) of every tensor."""
        return {
            "w_gate": dense_init(generator, lead + (d_model, d_ff), dtype),
            "w_up": dense_init(generator, lead + (d_model, d_ff), dtype),
            "w_down": dense_init(generator, lead + (d_ff, d_model), dtype),
        }

    @staticmethod
    def forward(p, x, act: str = "silu"):
        h = act_fn(act, x @ p["w_gate"]) * (x @ p["w_up"])
        return h @ p["w_down"]
