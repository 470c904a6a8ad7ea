"""Attention (counterpart of ``repro.models.attention``): GQA/MQA with
optionally biased QKV.

``gqa`` exposes, over a param dict of (in, out) weights (``x @ w``, the
reference's layout):
    init(generator, cfg, dtype)                  -> params
    forward_train(p, x, cfg, positions)          -> y                (causal)
    forward_prefill(p, x, cfg, positions, L)     -> y, cache
    forward_decode(p, x, cfg, cache, pos)        -> y, cache         (Sq == 1)

A cache is ``{"k", "v"}`` of (B, L, Hkv, hd) sized to the target context
length; ``pos`` is its fill level.  Decode writes the new row into the given
cache in place and returns it.  The reference's sharding hints are exact
identities off a mesh and are left out here.  MLA and the cross-attention
methods are ported with their model families (ROADMAP, modules item 2).
"""
from __future__ import annotations

import torch

from .common import apply_rope, chunked_attention, decode_attention, dense_init, rope_sin_cos

__all__ = ["gqa"]


class gqa:
    @staticmethod
    def init(generator: torch.Generator, cfg, dtype=torch.float32, lead: tuple = ()) -> dict:
        """``lead``: leading axes (a stack's unit count) of every tensor."""
        d, H, Hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        hd = cfg.resolved_head_dim
        p = {
            "wq": dense_init(generator, lead + (d, H * hd), dtype),
            "wk": dense_init(generator, lead + (d, Hkv * hd), dtype),
            "wv": dense_init(generator, lead + (d, Hkv * hd), dtype),
            "wo": dense_init(generator, lead + (H * hd, d), dtype),
        }
        if cfg.qkv_bias:
            p["bq"] = torch.zeros(lead + (H * hd,), dtype=dtype)
            p["bk"] = torch.zeros(lead + (Hkv * hd,), dtype=dtype)
            p["bv"] = torch.zeros(lead + (Hkv * hd,), dtype=dtype)
        return p

    @staticmethod
    def _qkv(p, x, cfg, positions):
        B, S, d = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = x @ p["wq"]
        k = x @ p["wk"]
        v = x @ p["wv"]
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = q.reshape(B, S, H, hd)
        k = k.reshape(B, S, Hkv, hd)
        v = v.reshape(B, S, Hkv, hd)
        sin, cos = rope_sin_cos(positions, hd, cfg.rope_theta)
        return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v

    @staticmethod
    def forward_train(p, x, cfg, positions, causal: bool = True):
        q, k, v = gqa._qkv(p, x, cfg, positions)
        y = chunked_attention(q, k, v, causal=causal)
        B, S = x.shape[:2]
        return y.reshape(B, S, -1) @ p["wo"]

    @staticmethod
    def forward_prefill(p, x, cfg, positions, cache_len: int):
        B, S, _ = x.shape
        q, k, v = gqa._qkv(p, x, cfg, positions)
        y = chunked_attention(q, k, v, causal=True)
        Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        cache = {
            "k": torch.zeros((B, cache_len, Hkv, hd), dtype=x.dtype, device=x.device),
            "v": torch.zeros((B, cache_len, Hkv, hd), dtype=x.dtype, device=x.device),
        }
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        return y.reshape(B, S, -1) @ p["wo"], cache

    @staticmethod
    def forward_decode(p, x, cfg, cache, pos: int):
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v = gqa._qkv(p, x, cfg, positions)
        kc, vc = cache["k"], cache["v"]
        kc[:, pos] = k[:, 0].to(kc.dtype)  # the cache may be narrower than x
        vc[:, pos] = v[:, 0].to(vc.dtype)
        y = decode_attention(q, kc, vc, pos + 1)
        return y.reshape(B, 1, -1) @ p["wo"], cache
