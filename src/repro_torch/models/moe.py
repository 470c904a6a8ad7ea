"""FFN blocks (counterpart of ``repro.models.moe``): the dense GLU FFN
(SwiGLU / GeGLU) and the routed Mixture-of-Experts.

The MoE uses the reference's grouped sort-based dispatch (no (T, E, C)
one-hot): tokens are split into ``pick_group_count`` groups, each group's
routed (token, expert) pairs are sorted by expert and written into an
(E, C, d) buffer, the expert GEMMs run batched over every expert at
capacity C, and the outputs are combined with the router weights.  A pair
past its expert's capacity goes to a drop bin (slot E*C) and contributes
nothing.  Shared experts (DeepSeek-style) run densely; the aux-free
balancing bias (DeepSeek-V3) is an f32 router parameter added to the
selection logits only.

What decides which tokens drop is reproduced exactly: C from Python floats
(``int()`` truncation, rounded up to 8, capped at Sg*k), the top-k order
(``lax.top_k``'s: larger first, ties to the lower expert, -0.0 below +0.0),
the stable sort by expert and each pair's place in its expert's queue.  The
combine sums a token's k weighted outputs in ascending expert order, the
order in which the reference's scatter-add meets them; it is a gather and
a sum, so it gives the same bits on every run (no atomics).
"""
from __future__ import annotations

import torch

from ..dist import hints
from .common import act_fn, dense_init, matmul

__all__ = ["dense_ffn", "moe_ffn", "pick_group_count"]


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
        h = act_fn(act, matmul(x, p["w_gate"])) * matmul(x, p["w_up"])
        return matmul(hints.ffn_hidden(h), p["w_down"])


def pick_group_count(n_tokens: int, n_experts: int, top_k: int) -> int:
    """Groups sized so per-group expert capacity lands >= ~8 slots, rounded
    down to a power of two (the reference's rule)."""
    g = max(1, n_tokens * top_k // (n_experts * 8))
    p = 1
    while p * 2 <= g:
        p *= 2
    return p


def _descending_order(x: torch.Tensor) -> torch.Tensor:
    """Indices sorting ``x`` (f32) along its last axis from largest to
    smallest in ``lax.top_k``'s total order: -0.0 below +0.0, ties to the
    lower index.  The float's bits become an int32 that orders as the
    float does, and a stable sort keeps tied entries in index order."""
    bits = x.contiguous().view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices


class moe_ffn:
    @staticmethod
    def init(generator: torch.Generator, cfg, dtype=torch.float32, lead: tuple = ()) -> dict:
        """``lead``: leading axes (a stack's unit count) of every tensor.
        ``router_bias`` is f32 in any model dtype."""
        d, E, fe = cfg.d_model, cfg.n_experts, cfg.d_ff_expert
        p = {
            "router": dense_init(generator, lead + (d, E), dtype, std=0.006),
            "w_gate": dense_init(generator, lead + (E, d, fe), dtype),
            "w_up": dense_init(generator, lead + (E, d, fe), dtype),
            "w_down": dense_init(generator, lead + (E, fe, d), dtype),
        }
        if cfg.router_aux_free:
            p["router_bias"] = torch.zeros(lead + (E,), dtype=torch.float32)
        if cfg.n_shared:
            p["shared"] = dense_ffn.init(generator, d, fe * cfg.n_shared, dtype, lead)
        return p

    @staticmethod
    def capacity(group_tokens: int, cfg) -> int:
        """Slots per expert in a group of ``group_tokens`` tokens."""
        E, k = cfg.n_experts, cfg.top_k
        C = int(group_tokens * k * cfg.capacity_factor / E) + 1
        C = max(8, ((C + 7) // 8) * 8)  # lane-friendly capacity
        return min(C, group_tokens * k)

    @staticmethod
    def route(p, x, cfg):
        """x (B, S, d) -> (top_idx (G, Sg, k) int64, top_w (G, Sg, k) f32, C):
        each token's experts, larger selection logit first, and their
        renormalised router probabilities."""
        B, S, d = x.shape
        E, k = cfg.n_experts, cfg.top_k
        T = B * S
        G = pick_group_count(T, E, k)
        Sg = T // G
        assert G * Sg == T, f"tokens {T} not divisible into {G} groups"
        logits = (x.reshape(G, Sg, d) @ p["router"]).to(torch.float32)
        probs = torch.softmax(logits, dim=-1)
        select = logits + p["router_bias"] if cfg.router_aux_free else logits
        top_idx = _descending_order(select)[..., :k]
        top_w = torch.gather(probs, -1, top_idx)
        top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
        return top_idx, top_w, moe_ffn.capacity(Sg, cfg)

    @staticmethod
    def dispatch(top_idx: torch.Tensor, C: int, n_experts: int):
        """Each group's (token, expert) pairs sorted by expert: -> (slot,
        order, keep), each (G, Sg*k).  ``order`` is the stable sort of the
        flat pairs (token-major), ``slot`` a pair's row of the (E*C + 1)-row
        buffer (E*C, the drop bin, where its expert's queue is full) and
        ``keep`` whether it got a slot."""
        G = top_idx.shape[0]
        fe = top_idx.reshape(G, -1)
        order = torch.argsort(fe, dim=-1, stable=True)
        se = torch.gather(fe, -1, order)
        first = torch.searchsorted(se, se, side="left")
        pos = torch.arange(se.shape[-1], device=se.device) - first
        keep = pos < C
        slot = torch.where(keep, se * C + pos, n_experts * C)
        return slot, order, keep

    @staticmethod
    def forward(p, x, cfg):
        """x (B, S, d) -> (B, S, d)."""
        B, S, d = x.shape
        E, k = cfg.n_experts, cfg.top_k
        top_idx, top_w, C = moe_ffn.route(p, x, cfg)
        G, Sg, _ = top_idx.shape
        slot, order, keep = moe_ffn.dispatch(top_idx, C, E)
        tok = order // k
        xt = x.reshape(G, Sg, d)

        # scatter into (G, E*C + 1, d); only the drop bin takes repeated
        # writes (all zeros), and it is cut off
        vals = torch.gather(xt, 1, tok[..., None].expand(-1, -1, d)) * keep[..., None].to(x.dtype)
        buf = torch.zeros((G, E * C + 1, d), dtype=x.dtype, device=x.device)
        buf.scatter_(1, slot[..., None].expand(-1, -1, d), vals)

        # batched expert GEMMs over (E, G*C, d) x (E, d, f): every expert's
        # weights are read, at capacity
        h_in = buf[:, :-1].reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
        h = act_fn(cfg.act, torch.bmm(h_in, p["w_gate"])) * torch.bmm(h_in, p["w_up"])
        out = torch.bmm(h, p["w_down"]).reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

        # combine: each pair's expert output, weighted, summed per token in
        # ascending expert order (the pairs' order in the sorted array)
        got = torch.gather(out, 1, torch.clamp(slot, max=E * C - 1)[..., None].expand(-1, -1, d))
        got = got * keep[..., None].to(got.dtype)
        w_sorted = torch.gather(top_w.reshape(G, -1), -1, order)
        contrib = got * w_sorted[..., None].to(got.dtype)
        where = torch.argsort(order, dim=-1)  # a flat pair's place in the sorted array
        where = torch.sort(where.reshape(G, Sg, k), dim=-1).values.reshape(G, Sg * k)
        per_tok = torch.gather(contrib, 1, where[..., None].expand(-1, -1, d)).reshape(G, Sg, k, d)
        y = per_tok[:, :, 0]
        for j in range(1, k):
            y = y + per_tok[:, :, j]
        y = y.reshape(B, S, d)
        if cfg.n_shared:
            y = y + dense_ffn.forward(p["shared"], x, cfg.act)
        return y
