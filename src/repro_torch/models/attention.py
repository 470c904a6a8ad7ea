"""Attention (counterpart of ``repro.models.attention``): GQA/MQA with
optionally biased QKV, its cross-attention form (the whisper decoder), and
MLA (DeepSeek-V3's multi-head latent attention, decoding against the
compressed cache with W_uk / W_uv absorbed).

Each of ``gqa`` and ``mla`` exposes, over a param dict of (in, out) weights
(``x @ w``, the reference's layout):
    init(generator, cfg, dtype)                  -> params
    forward_train(p, x, cfg, positions)          -> y                (causal)
    forward_prefill(p, x, cfg, positions, L)     -> y, cache
    forward_decode(p, x, cfg, cache, pos)        -> y, cache         (Sq == 1)

A GQA cache is ``{"k", "v"}`` of (B, L, Hkv, hd); an MLA cache is the
latent ``{"c_kv"}`` (B, L, r_kv) and ``{"k_rope"}`` (B, L, d_rope); both
are sized to the target context length and ``pos`` is their fill level.
Decode writes the new row into the given cache in place and returns it.
The cross-attention trio (``gqa.forward_cross``, ``cross_kv``,
``forward_cross_cached``) has no RoPE and no causal mask.  GQA's q, k and
v pass through ``dist.hints.heads``, as in the reference: an identity off
a mesh, a redistribution of a DTensor inside ``activation_sharding``.
Every GQA product promotes as JAX does (``common.matmul``): f32 frames
through a bf16 whisper encoder stay f32, and so do the cross-attention
K/V made from them.
"""
from __future__ import annotations

import torch

from ..dist import hints
from .common import (
    NEG_INF,
    apply_rope,
    chunked_attention,
    decode_attention,
    dense_init,
    matmul,
    rms_norm,
    rope_sin_cos,
)

__all__ = ["gqa", "mla"]


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
        q = matmul(x, p["wq"])
        k = matmul(x, p["wk"])
        v = matmul(x, p["wv"])
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        q = hints.heads(hints.split_heads(q, H, hd))
        k = hints.heads(hints.split_heads(k, Hkv, hd))
        v = hints.heads(hints.split_heads(v, Hkv, hd))
        sin, cos = rope_sin_cos(positions, hd, cfg.rope_theta)
        return apply_rope(q, sin, cos), apply_rope(k, sin, cos), v

    @staticmethod
    def forward_train(p, x, cfg, positions, causal: bool = True):
        q, k, v = gqa._qkv(p, x, cfg, positions)
        y = chunked_attention(q, k, v, causal=causal)
        B, S = x.shape[:2]
        return matmul(y.reshape(B, S, -1), p["wo"])

    @staticmethod
    def forward_prefill(p, x, cfg, positions, cache_len: int):
        B, S, _ = x.shape
        q, k, v = gqa._qkv(p, x, cfg, positions)
        y = chunked_attention(q, k, v, causal=True)
        Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        # new_zeros: on a mesh the caches take k's and v's layout
        cache = {
            "k": k.new_zeros((B, cache_len, Hkv, hd), dtype=x.dtype),
            "v": v.new_zeros((B, cache_len, Hkv, hd), dtype=x.dtype),
        }
        cache["k"][:, :S] = k
        cache["v"][:, :S] = v
        return matmul(y.reshape(B, S, -1), p["wo"]), cache

    @staticmethod
    def forward_decode(p, x, cfg, cache, pos: int):
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q, k, v = gqa._qkv(p, x, cfg, positions)
        kc, vc = cache["k"], cache["v"]
        kc[:, pos] = k[:, 0].to(kc.dtype)  # the cache may be narrower than x
        vc[:, pos] = v[:, 0].to(vc.dtype)
        y = decode_attention(q, kc, vc, pos + 1)
        return matmul(y.reshape(B, 1, -1), p["wo"]), cache

    # -- cross attention (whisper decoder) ---------------------------------
    @staticmethod
    def forward_cross(p, x, kv_src, cfg):
        """x (B, Sq, d) attends over kv_src (B, Sk, d); no RoPE, no causal."""
        B, Sq, _ = x.shape
        H, Hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = matmul(x, p["wq"]).reshape(B, Sq, H, hd)
        k = matmul(kv_src, p["wk"]).reshape(B, -1, Hkv, hd)
        v = matmul(kv_src, p["wv"]).reshape(B, -1, Hkv, hd)
        y = chunked_attention(q, k, v, causal=False)
        return matmul(y.reshape(B, Sq, -1), p["wo"])

    @staticmethod
    def cross_kv(p, kv_src, cfg):
        """Cross-attention K/V, computed once per request (decode path)."""
        B = kv_src.shape[0]
        Hkv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        k = matmul(kv_src, p["wk"]).reshape(B, -1, Hkv, hd)
        v = matmul(kv_src, p["wv"]).reshape(B, -1, Hkv, hd)
        return k, v

    @staticmethod
    def forward_cross_cached(p, x, k, v, cfg):
        B, Sq, _ = x.shape
        H, hd = cfg.n_heads, cfg.resolved_head_dim
        q = matmul(x, p["wq"]).reshape(B, Sq, H, hd)
        y = decode_attention(q, k, v, k.shape[1])
        return matmul(y.reshape(B, Sq, -1), p["wo"])


# ==========================================================================
# MLA -- multi-head latent attention (DeepSeek-V2/V3).
# ==========================================================================
def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32)


class mla:
    @staticmethod
    def init(generator: torch.Generator, cfg, dtype=torch.float32, lead: tuple = ()) -> dict:
        """``lead``: leading axes (a stack's unit count) of every tensor."""
        d, H = cfg.d_model, cfg.n_heads
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        rq, rkv = cfg.q_lora_rank, cfg.kv_lora_rank
        p = {
            "w_dkv": dense_init(generator, lead + (d, rkv), dtype),
            "kv_norm": torch.ones(lead + (rkv,), dtype=dtype),
            "w_uk": dense_init(generator, lead + (rkv, H, dn), dtype),
            "w_uv": dense_init(generator, lead + (rkv, H, dv), dtype),
            "w_kr": dense_init(generator, lead + (d, dr), dtype),
            "wo": dense_init(generator, lead + (H * dv, d), dtype),
        }
        if rq:
            p["w_dq"] = dense_init(generator, lead + (d, rq), dtype)
            p["q_norm"] = torch.ones(lead + (rq,), dtype=dtype)
            p["w_uq"] = dense_init(generator, lead + (rq, H, dn + dr), dtype)
        else:
            p["w_q"] = dense_init(generator, lead + (d, H, dn + dr), dtype)
        return p

    @staticmethod
    def _q(p, x, cfg, positions):
        dn, dr = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim
        if cfg.q_lora_rank:
            cq = rms_norm(x @ p["w_dq"], p["q_norm"], cfg.rms_eps)
            q = torch.einsum("bsr,rhd->bshd", cq, p["w_uq"])
        else:
            q = torch.einsum("bsd,dhe->bshe", x, p["w_q"])
        q_nope, q_rope = q[..., :dn], q[..., dn:]
        sin, cos = rope_sin_cos(positions, dr, cfg.rope_theta)
        return q_nope, apply_rope(q_rope, sin, cos)

    @staticmethod
    def _latent(p, x, cfg, positions):
        c_kv = rms_norm(x @ p["w_dkv"], p["kv_norm"], cfg.rms_eps)  # (B,S,rkv)
        k_rope = (x @ p["w_kr"])[:, :, None, :]                     # (B,S,1,dr)
        sin, cos = rope_sin_cos(positions, cfg.qk_rope_head_dim, cfg.rope_theta)
        return c_kv, apply_rope(k_rope, sin, cos)[:, :, 0, :]       # (B,S,dr)

    @staticmethod
    def forward_train(p, x, cfg, positions, causal: bool = True):
        """Materialized form (cheaper when Sq is long)."""
        B, S, _ = x.shape
        q_nope, q_rope = mla._q(p, x, cfg, positions)
        c_kv, k_rope = mla._latent(p, x, cfg, positions)
        k_nope = torch.einsum("bsr,rhd->bshd", c_kv, p["w_uk"])
        v = torch.einsum("bsr,rhd->bshd", c_kv, p["w_uv"])
        k_rope_h = k_rope[:, :, None, :].expand(B, S, cfg.n_heads, cfg.qk_rope_head_dim)
        q = torch.cat([q_nope, q_rope], -1)
        k = torch.cat([k_nope, k_rope_h], -1)
        y = chunked_attention(q, k, v, causal=causal)
        return y.reshape(B, S, -1) @ p["wo"]

    @staticmethod
    def forward_prefill(p, x, cfg, positions, cache_len: int):
        B, S, _ = x.shape
        y = mla.forward_train(p, x, cfg, positions, causal=True)
        c_kv, k_rope = mla._latent(p, x, cfg, positions)
        cache = {
            "c_kv": torch.zeros((B, cache_len, cfg.kv_lora_rank), dtype=x.dtype,
                                device=x.device),
            "k_rope": torch.zeros((B, cache_len, cfg.qk_rope_head_dim), dtype=x.dtype,
                                  device=x.device),
        }
        cache["c_kv"][:, :S] = c_kv
        cache["k_rope"][:, :S] = k_rope
        return y, cache

    @staticmethod
    def forward_decode(p, x, cfg, cache, pos: int):
        """Absorbed-latent decode: scores and values against the compressed
        cache, O(S (r_kv + d_rope)) per head.  Scores and the latent context
        accumulate in f32 (the reference's ``preferred_element_type``);
        cache rows past ``pos`` take ``NEG_INF``."""
        B = x.shape[0]
        positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
        q_nope, q_rope = mla._q(p, x, cfg, positions)       # (B,1,H,dn/dr)
        c_kv_new, k_rope_new = mla._latent(p, x, cfg, positions)
        ckv_store, kr_store = cache["c_kv"], cache["k_rope"]
        ckv_store[:, pos] = c_kv_new[:, 0].to(ckv_store.dtype)  # the cache may be narrower
        kr_store[:, pos] = k_rope_new[:, 0].to(kr_store.dtype)
        ckv = ckv_store.to(x.dtype)
        kr = kr_store.to(x.dtype)
        # absorb W_uk into the query: q_lat (B,1,H,rkv)
        q_lat = torch.einsum("bqhd,rhd->bqhr", q_nope, p["w_uk"])
        s_lat = torch.einsum("bqhr,bsr->bhqs", _f32(q_lat), _f32(ckv))
        s_rope = torch.einsum("bqhd,bsd->bhqs", _f32(q_rope), _f32(kr))
        dh = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
        s = (s_lat + s_rope) / torch.sqrt(torch.tensor(float(dh), dtype=torch.float32,
                                                       device=x.device))
        S = ckv.shape[1]
        valid = torch.arange(S, device=x.device)[None, None, None, :] < (pos + 1)
        s = torch.where(valid, s, NEG_INF)
        w = torch.softmax(s, dim=-1)
        ctx_lat = torch.einsum("bhqs,bsr->bqhr", _f32(w.to(ckv.dtype)), _f32(ckv))
        y = torch.einsum("bqhr,rhd->bqhd", ctx_lat.to(x.dtype), p["w_uv"])
        return y.reshape(B, 1, -1) @ p["wo"], cache
