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

On a mesh (``moe_ffn._on_mesh``) the layer is expert-parallel, as the
reference's GSPMD partitions it: each rank routes its own batch rows and
runs the GEMMs of its own block of E/m experts (the expert axis splits
over "model") on the pairs routed to them; the blocks' shares of the
output are summed over "model" with one all-reduce, or, where the rows
split over "model" too, the buffer goes to the experts' ranks and back by
an all-to-all each way.
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
    def route(p, x, cfg, groups: int | None = None):
        """x (B, S, d) -> (top_idx (G, Sg, k) int64, top_w (G, Sg, k) f32, C):
        each token's experts, larger selection logit first, and their
        renormalised router probabilities.  ``groups`` overrides G (a
        rank's share of the whole batch's groups)."""
        B, S, d = x.shape
        E, k = cfg.n_experts, cfg.top_k
        T = B * S
        G = groups or pick_group_count(T, E, k)
        Sg = T // G
        assert G * Sg == T, f"tokens {T} not divisible into {G} groups"
        logits = matmul(x.reshape(G, Sg, d), p["router"]).to(torch.float32)
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
        y = (moe_ffn._on_mesh(p, x, cfg) if hints.on_mesh(x)
             else moe_ffn.routed(p, x, cfg))
        if cfg.n_shared:
            y = y + dense_ffn.forward(p["shared"], x, cfg.act)
        return y

    @staticmethod
    def _on_mesh(p, x, cfg):
        """The routed experts of a DTensor ``x`` under an active hint
        context (``hints.per_experts``).  Each rank routes its own batch
        rows with the router gathered whole.  Where the expert tensors
        split their expert axis over a mesh dim (``param_shardings`` puts
        it on "model"), each rank runs only its own E/m experts, gathered
        over the dims that split d or f and never over the expert dim:
        where the rows split over that dim too, each rank's dispatch
        buffer goes to the experts' ranks and back by an all-to-all each
        way; where they do not, every rank of the expert group routes the
        same rows and the blocks' shares are summed over the expert dim.
        Where no rule splits the experts, they are gathered whole
        (``hints.per_rows``).  A group never spans two ranks' rows once
        the ranks split the batch into whole groups, so every token meets
        the drops of the unsharded computation; where they do not (fewer
        groups than ranks), the rows are gathered over the expert dim
        first, and where that is not enough every rank routes the whole
        batch.  DTensor has no rules for the dispatch's sort and search."""
        import math

        B, S, _ = x.shape
        G = pick_group_count(B * S, cfg.n_experts, cfg.top_k)
        mesh, ep = x.device_mesh, hints.expert_dims(p["w_gate"])
        split = [i for i, q in enumerate(x.placements) if q.is_shard(0)]
        n = math.prod(mesh.size(i) for i in split)
        exchange = len(ep) == 1 and ep[0] in split and not (G % n or B % n)
        if not exchange:
            n = math.prod(mesh.size(i) for i in split if i not in ep)
        whole = bool(G % n or B % n)
        groups = G if whole else G // n
        routed = {k: v for k, v in p.items() if k != "shared"}
        return hints.per_experts(
            lambda p_, x_, first, a2a: moe_ffn.routed(p_, x_, cfg, groups, first, a2a),
            routed, x, ("w_gate", "w_up", "w_down"), whole=whole, exchange=exchange)

    @staticmethod
    def routed(p, x, cfg, groups: int | None = None, first: int = 0, a2a=None):
        """The routed experts alone: x (B, S, d) -> (B, S, d).  The expert
        tensors of ``p`` may hold a block of El of the E experts, those
        numbered ``first`` up: the result is then those experts' share of
        the output (every token routes and drops as with all of them, and
        the blocks' shares sum to the whole).  With ``a2a``, an all-to-all
        over the m = E / El ranks of the blocks (dim 0, row j to rank j),
        the buffer of every expert's slots goes to the experts' ranks, each
        rank runs its block on every rank's groups, the outputs come back
        the same way and the result is the whole output of this rank's
        rows."""
        B, S, d = x.shape
        E, k = cfg.n_experts, cfg.top_k
        El = p["w_gate"].shape[0]
        Eb = E if a2a is not None else El  # the experts of this rank's buffer
        top_idx, top_w, C = moe_ffn.route(p, x, cfg, groups)
        G, Sg, _ = top_idx.shape
        slot, order, keep = moe_ffn.dispatch(top_idx, C, E)
        # the pairs of the buffer's experts, and their rows of it (Eb*C, the
        # drop bin, for every other pair)
        mine = keep & (slot >= first * C) & (slot < (first + Eb) * C)
        slot = torch.where(mine, slot - first * C, Eb * C)
        tok = order // k
        xt = x.reshape(G, Sg, d)

        # scatter into (G, Eb*C + 1, d); only the drop bin takes repeated
        # writes (all zeros), and it is cut off
        vals = torch.gather(xt, 1, tok[..., None].expand(-1, -1, d)) * mine[..., None].to(x.dtype)
        buf = torch.zeros((G, Eb * C + 1, d), dtype=x.dtype, device=x.device)
        buf.scatter_(1, slot[..., None].expand(-1, -1, d), vals)
        h_in = buf[:, :-1].reshape(G, Eb, C, d)
        if a2a is not None:  # (m, G, El, C, d): row s, rank s's groups for this block
            h_in = a2a(h_in.reshape(G, E // El, El, C, d).transpose(0, 1))
        h_in = h_in.reshape(-1, El, C, d)
        Gx = h_in.shape[0]  # the groups whose slots this rank's experts serve

        # batched expert GEMMs over (El, Gx*C, d) x (El, d, f): every expert's
        # weights are read, at capacity
        h_in = h_in.transpose(0, 1).reshape(El, Gx * C, d)
        h = act_fn(cfg.act, torch.bmm(h_in, p["w_gate"])) * torch.bmm(h_in, p["w_up"])
        out = torch.bmm(h, p["w_down"]).reshape(El, Gx, C, d).transpose(0, 1)
        if a2a is not None:  # back: row j, block j's outputs for this rank's groups
            out = a2a(out.reshape(E // El, G, El, C, d)).transpose(0, 1)
        out = out.reshape(G, Eb * C, d)

        # combine: each pair's expert output, weighted, summed per token in
        # ascending expert order (the pairs' order in the sorted array)
        got = torch.gather(out, 1, torch.clamp(slot, max=Eb * C - 1)[..., None].expand(-1, -1, d))
        got = got * mine[..., None].to(got.dtype)
        w_sorted = torch.gather(top_w.reshape(G, -1), -1, order)
        contrib = got * w_sorted[..., None].to(got.dtype)
        where = torch.argsort(order, dim=-1)  # a flat pair's place in the sorted array
        where = torch.sort(where.reshape(G, Sg, k), dim=-1).values.reshape(G, Sg * k)
        per_tok = torch.gather(contrib, 1, where[..., None].expand(-1, -1, d)).reshape(G, Sg, k, d)
        y = per_tok[:, :, 0]
        for j in range(1, k):
            y = y + per_tok[:, :, j]
        return y.reshape(B, S, d)
