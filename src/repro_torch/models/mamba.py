"""Mamba2 (SSD, state-space duality) block, chunked matmul form
(counterpart of ``repro.models.mamba``).

Within a chunk the SSM is a masked quadratic form (batched products);
across chunks a (B, H, N, P) state is carried in a Python loop.  Decode is
the O(1)-per-token recurrence on that state, plus a K-1 row window of the
causal depthwise convolution's input.

The reference's f32 islands are kept: ``dt`` (softplus), ``A``, the state
and the per-head inputs are f32, and ``A_log``, ``dt_bias`` and ``D`` are
f32 leaves in any model dtype.  Where the reference lets a product promote
a narrower operand to f32, the port upcasts it (exactly) first.

Shapes: d_inner = expand*d_model, H heads of head_dim P, state N, groups G.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..dist import hints
from .common import dense_init, matmul

__all__ = ["mamba2"]

_F32 = torch.float32


def _dims(cfg, d_model: int):
    di = cfg.ssm_expand * d_model
    P = cfg.ssm_head_dim
    H = di // P
    G, N = cfg.ssm_groups, cfg.ssm_state
    return di, H, P, G, N


def _gated_norm(y, z, w, eps: float, heads, di: int) -> torch.Tensor:
    """``rms_norm(y * silu(z), w)`` over all of d_inner, which spans every
    head: a block of heads (``hints.Heads``) sums its rows' squares over
    the other blocks before it scales them (every head: a sum of one)."""
    g = y * F.silu(z)
    g32 = g.to(_F32)
    var = heads.sum((g32 * g32).sum(dim=-1, keepdim=True)) / di
    return ((g32 * torch.rsqrt(var + eps)) * w.to(_F32)).to(g.dtype)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


class mamba2:
    @staticmethod
    def init(generator: torch.Generator, cfg, d_model: int, dtype=torch.float32,
             lead: tuple = ()) -> dict:
        """``lead``: leading axes (a stack's unit count) of every tensor."""
        di, H, P, G, N = _dims(cfg, d_model)
        K = cfg.conv_kernel
        conv_dim = di + 2 * G * N
        return {
            "in_proj": dense_init(generator, lead + (d_model, 2 * di + 2 * G * N + H), dtype),
            "conv_w": dense_init(generator, lead + (K, conv_dim), dtype, std=0.1),
            "conv_b": torch.zeros(lead + (conv_dim,), dtype=dtype),
            "A_log": torch.zeros(lead + (H,), dtype=_F32),
            "dt_bias": torch.full(lead + (H,), -2.0, dtype=_F32),
            "D": torch.ones(lead + (H,), dtype=_F32),
            "norm_w": torch.ones(lead + (di,), dtype=dtype),
            "out_proj": dense_init(generator, lead + (di, d_model), dtype),
        }

    # ------------------------------------------------------------------
    @staticmethod
    def _conv_train(p, u, K):
        """Causal depthwise conv along time: u (B,S,C)."""
        pad = F.pad(u, (0, 0, K - 1, 0))
        out = sum(pad[:, i:i + u.shape[1], :] * p["conv_w"][i][None, None, :]
                  for i in range(K))
        return F.silu(out + p["conv_b"])

    # ------------------------------------------------------------------
    @staticmethod
    def forward_train(p, x, cfg, d_model: int, return_state: bool = False):
        """The chunked SSD over x (B, S, d) -> out, with ``return_state``
        (out, {"ssm": (B, H, N, P) state, "conv": the conv's last K-1 input
        rows}).  On a mesh every rank runs its own batch rows and its own
        block of H/m heads (``hints.per_heads``), as the reference's rules
        split the mixer over model."""
        di, H, P, G, N = _dims(cfg, d_model)
        if hints.on_mesh(x):
            return hints.per_heads(mamba2._heads, p, x, H, cfg, d_model, return_state,
                                   groups=G)
        return mamba2._heads(p, x, hints.Heads(0, H, H), cfg, d_model, return_state)

    @staticmethod
    def _block(p, cfg, d_model, heads, g0, g1) -> dict:
        """The entries of ``p`` for the heads of the block ``heads`` and the
        groups [g0, g1) of B and C: in_proj's columns (of the weight, or of
        a decode's product) and the conv's channels of them (of its
        weights, or of a decode's ``window``), the per-head vectors,
        norm_w's and out_proj's rows of the heads' d_inner span (an
        out_proj that holds only those rows as it is); no other entry."""
        di, H, P, G, N = _dims(cfg, d_model)
        h0, h1 = heads.lo, heads.hi
        xs, bc = (h0 * P, h1 * P), (g0 * N, g1 * N)

        def cols(*spans):
            return lambda t: torch.cat([t[..., o + a:o + b] for o, (a, b) in spans], dim=-1)

        def own(t):
            return t[..., h0:h1]

        conv = ((0, xs), (di, bc), (di + G * N, bc))
        take = {"in_proj": cols((0, xs), *((di + o, s) for o, s in conv),
                                (2 * di + 2 * G * N, (h0, h1))),
                "conv_w": cols(*conv), "conv_b": cols(*conv), "window": cols(*conv),
                "A_log": own, "dt_bias": own, "D": own,
                "norm_w": lambda t: t[..., xs[0]:xs[1]],
                "out_proj": lambda t: t[xs[0]:xs[1]] if t.shape[0] == di else t}
        return {k: take[k](v) for k, v in p.items() if k in take}

    @staticmethod
    def _heads(p, x, heads, cfg, d_model: int, return_state: bool = False):
        """``forward_train`` for the block of heads ``heads`` (a
        ``hints.Heads``; every head off a mesh): the block's share of out
        (its rows of out_proj: a partial sum over the blocks) and, with
        ``return_state``, the whole state (``heads.gather``)."""
        B, S, _ = x.shape
        di, H, P, G, N = _dims(cfg, d_model)
        Q = min(cfg.ssm_chunk, S)
        assert S % Q == 0, f"seq {S} must divide chunk {Q}"
        nc = S // Q
        K = cfg.conv_kernel
        Hl, rep = heads.hi - heads.lo, H // G
        # the groups of B and C the heads read, [r0, r1); a block that holds
        # whole groups computes only its own, one within a group all G
        r0, r1 = heads.lo // rep, (heads.hi - 1) // rep + 1
        g0, g1 = (r0, r1) if Hl % rep == 0 else (0, G)
        if Hl < H:
            p = mamba2._block(p, cfg, d_model, heads, g0, g1)
        dl, gn = Hl * P, (g1 - g0) * N

        proj = matmul(x, p["in_proj"])  # (B,S,2dl+2gn+Hl)
        z, xs, Bc, Cc, dt = torch.split(proj, [dl, dl, gn, gn, Hl], dim=-1)
        conv_in = torch.cat([xs, Bc, Cc], dim=-1)
        conv_out = mamba2._conv_train(p, conv_in, K)
        xs, Bc, Cc = torch.split(conv_out, [dl, gn, gn], dim=-1)
        Gl = r1 - r0
        if (g0, g1) != (r0, r1):
            Bc = Bc[..., (r0 - g0) * N:(r1 - g0) * N]
            Cc = Cc[..., (r0 - g0) * N:(r1 - g0) * N]

        dt = _softplus(dt.to(_F32) + p["dt_bias"])    # (B,S,Hl)
        A = -torch.exp(p["A_log"])                    # (Hl,)
        a = dt * A[None, None, :]                     # (B,S,Hl) <= 0

        # chunk by chunk, one (B, Q, ...) working set at a time, carrying
        # the (B, Hl, N, P) state
        rep = Hl // Gl
        xh = xs.reshape(B, nc, Q, Hl, P).to(_F32)
        Bh = Bc.reshape(B, nc, Q, Gl, N).to(_F32)
        Ch = Cc.reshape(B, nc, Q, Gl, N).to(_F32)
        ac = a.reshape(B, nc, Q, Hl)
        dtc = dt.reshape(B, nc, Q, Hl)
        mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))

        h = torch.zeros((B, Hl, N, P), dtype=_F32, device=x.device)
        ys = []
        for c in range(nc):
            xc, bc, cc, a_c, dt_c = xh[:, c], Bh[:, c], Ch[:, c], ac[:, c], dtc[:, c]
            xbar = xc * dt_c[..., None]
            cum = torch.cumsum(a_c, dim=1)                      # (B,Q,Hl)
            li = cum[:, :, None, :] - cum[:, None, :, :]        # (B,Q,Q,Hl)
            Lm = torch.where(mask[None, :, :, None], torch.exp(li), 0.0)
            scores = torch.einsum("bqgn,bsgn->bqsg", cc, bc)    # (B,Q,Q,Gl)
            att = torch.repeat_interleave(scores, rep, dim=-1) * Lm
            y_intra = torch.einsum("bqsh,bshp->bqhp", att, xbar)
            # inter-chunk contribution from the carried state
            cc_h = torch.repeat_interleave(cc, rep, dim=2)      # (B,Q,Hl,N)
            y_inter = torch.einsum("bqh,bqhn,bhnp->bqhp", torch.exp(cum), cc_h, h)
            # state update
            decay_to_end = torch.exp(cum[:, -1:, :] - cum)      # (B,Q,Hl)
            bc_h = torch.repeat_interleave(bc, rep, dim=2)
            s_c = torch.einsum("bqh,bqhn,bqhp->bhnp", decay_to_end, bc_h, xbar)
            h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + s_c
            ys.append(y_intra + y_inter)
        y = torch.stack(ys, dim=1).reshape(B, S, Hl, P)
        y = y + p["D"][None, None, :, None] * xs.reshape(B, S, Hl, P).to(_F32)
        y = y.reshape(B, S, dl).to(x.dtype)
        out = matmul(_gated_norm(y, z, p["norm_w"], cfg.rms_eps, heads, di), p["out_proj"])
        if not return_state:
            return out
        # the conv tail is the last K-1 rows of the conv's input
        tail = conv_in[:, -(K - 1):, :] if K > 1 else conv_in[:, :0, :]
        xt, bt, ct = torch.split(tail, [dl, gn, gn], dim=-1)
        if g1 - g0 < G:  # each block computed its own groups
            bt, ct = heads.gather(bt, 2), heads.gather(ct, 2)
        conv_tail = torch.cat([heads.gather(xt, 2), bt, ct], dim=-1)
        return out, {"ssm": heads.gather(h, 1), "conv": conv_tail.to(x.dtype)}

    # ------------------------------------------------------------------
    @staticmethod
    def init_cache(cfg, d_model: int, batch: int, dtype=torch.float32, *, device,
                   lead: tuple = ()) -> dict:
        di, H, P, G, N = _dims(cfg, d_model)
        K = cfg.conv_kernel
        return {
            "ssm": torch.zeros(lead + (batch, H, N, P), dtype=_F32, device=device),
            "conv": torch.zeros(lead + (batch, K - 1, di + 2 * G * N), dtype=dtype,
                                device=device),
        }

    @staticmethod
    def forward_decode(p, x, cfg, cache, d_model: int):
        """x (B, 1, d); the O(1) state recurrence.  Shifts the conv window
        and replaces the state in the given cache, in place, and returns
        it.  On a mesh every rank runs its own batch rows and its own block
        of H/m heads (``hints.per_heads``) with ``in_proj`` and
        ``out_proj`` kept on the rules' "model" split, gathered over the
        data axes only, as GSPMD partitions the reference's decode."""
        di, H, P, G, N = _dims(cfg, d_model)
        if hints.on_mesh(x):  # per rank, into its own rows of the cache
            return hints.per_heads(mamba2._decode, p, x, H, cache, cfg, d_model, groups=G,
                                   own={"in_proj": 1, "out_proj": 0})
        return mamba2._decode(p, x, hints.Heads(0, H, H), cache, cfg, d_model)

    @staticmethod
    def _decode(p, x, heads, cache, cfg, d_model: int):
        """``forward_decode`` for the block of heads ``heads`` (a
        ``hints.Heads``; every head off a mesh) -> (the block's share of
        out: a partial sum over the blocks, the cache).  ``in_proj`` is
        whole or the rank's block of its columns, whose (B, 1, W / m)
        product every block gathers; the block takes its heads' columns of
        the product and of the conv window, and its share of the params
        (``_block``).  The conv window of every channel and the state of
        every head (``heads.gather``) go into the cache, which holds them
        whole."""
        B = x.shape[0]
        di, H, P, G, N = _dims(cfg, d_model)
        lo, hi = heads.lo, heads.hi
        Hl, rep = hi - lo, H // G
        r0, r1 = lo // rep, (hi - 1) // rep + 1  # the groups the heads read
        proj = matmul(x, p["in_proj"])                                  # (B,1,W)
        if proj.shape[-1] < 2 * di + 2 * G * N + H:  # every block's columns
            proj = heads.gather(proj, 2)
        window = torch.cat([cache["conv"], proj[..., di:2 * di + 2 * G * N]], dim=1)  # (B,K,C)
        q = dict(p, in_proj=proj, window=window)
        if Hl < H:
            q = mamba2._block(q, cfg, d_model, heads, r0, r1)
        dl, gl = Hl * P, (r1 - r0) * N
        z, _, _, _, dt = torch.split(q["in_proj"], [dl, dl, gl, gl, Hl], dim=-1)
        conv_out = F.silu(torch.einsum("bkc,kc->bc", q["window"], q["conv_w"])
                          + q["conv_b"])[:, None, :]
        xs, Bc, Cc = torch.split(conv_out, [dl, gl, gl], dim=-1)

        dt = _softplus(dt.to(_F32) + q["dt_bias"])[:, 0]               # (B,Hl)
        A = -torch.exp(q["A_log"])
        dec = torch.exp(dt * A[None, :])                                # (B,Hl)
        xh = xs.reshape(B, Hl, P).to(_F32)
        Bh = torch.repeat_interleave(Bc.reshape(B, r1 - r0, N), Hl // (r1 - r0), dim=1).to(_F32)
        Ch = torch.repeat_interleave(Cc.reshape(B, r1 - r0, N), Hl // (r1 - r0), dim=1).to(_F32)
        xbar = xh * dt[..., None]
        h = cache["ssm"][:, lo:hi] * dec[:, :, None, None] + torch.einsum(
            "bhn,bhp->bhnp", Bh, xbar)
        y = torch.einsum("bhn,bhnp->bhp", Ch, h) + q["D"][None, :, None] * xh
        y = _gated_norm(y.reshape(B, 1, dl).to(x.dtype), z, q["norm_w"], cfg.rms_eps, heads, di)
        cache["ssm"].copy_(heads.gather(h, 1))
        cache["conv"].copy_(window[:, 1:, :])
        return y @ q["out_proj"], cache
