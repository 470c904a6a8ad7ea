"""Shared model building blocks (counterpart of ``repro.models.common``):
norms, RoPE, activations, memory-efficient attention.  Plain functions on
tensors over explicit param dicts.

Every function computes the reference's arithmetic, f32 islands included:
``rms_norm`` and ``apply_rope`` compute in f32 and cast back, attention
scores and the ``p @ v`` product accumulate in f32 (the reference's
``preferred_element_type``: bf16 operands are upcast exactly before the
product), and masked scores take ``NEG_INF = -1e30``, not ``-inf``.  No
``scaled_dot_product_attention`` and no ``torch.compile``: the CPU and the
card run the same plain tensor code.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from ..dist import hints

__all__ = [
    "dense_init",
    "matmul",
    "rms_norm",
    "act_fn",
    "rope_sin_cos",
    "apply_rope",
    "chunked_attention",
    "decode_attention",
]

DEFAULT_INIT_STD = 0.02
NEG_INF = -1e30


def dense_init(generator: torch.Generator, shape, dtype=torch.float32,
               std: float = DEFAULT_INIT_STD) -> torch.Tensor:
    """Normal(0, std) weights drawn in f32 from ``generator``, then cast to
    ``dtype``, on the default device (the caller's ``with torch.device``).
    The scale is applied in place: the same bits as ``randn * std`` without
    a second copy of the leaf (deepseek-v3's expert tensor is 15 GB)."""
    return torch.randn(shape, generator=generator, dtype=torch.float32).mul_(std).to(dtype)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` under JAX's type promotion, where ``@`` refuses operands
    of two dtypes: both go to the wider one first (bf16 with f32 meet at
    f32, as a whisper encoder's f32 frames meet its bf16 weights)."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return a @ b


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return ((x32 * torch.rsqrt(var + eps)) * w.to(torch.float32)).to(dt)


def act_fn(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "silu":
        return F.silu(x)
    if name == "gelu":  # jax.nn.gelu's default is the tanh approximation
        return F.gelu(x, approximate="tanh")
    raise ValueError(name)


# --------------------------------------------------------------------------
# Rotary position embeddings (half-split layout, not interleaved pairs).
# --------------------------------------------------------------------------
def rope_sin_cos(positions: torch.Tensor, head_dim: int, theta: float):
    """positions (...,) -> sin/cos (..., head_dim/2), f32."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    freqs = 1.0 / (torch.tensor(theta, dtype=torch.float32, device=positions.device) ** exps)
    ang = positions.to(torch.float32)[..., None] * freqs  # (..., half)
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x (B, S, H, D); sin/cos (S, D/2) or (B, S, D/2), broadcast over heads."""
    dt = x.dtype
    x = x.to(torch.float32)
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    if sin.ndim == 2:  # (S, half) -> broadcast batch + heads
        sin, cos = sin[None, :, None, :], cos[None, :, None, :]
    else:  # (B, S, half)
        sin, cos = sin[:, :, None, :], cos[:, :, None, :]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(dt)


# --------------------------------------------------------------------------
# Memory-efficient (flash-style) attention in plain tensor code: KV chunks
# scanned with a running (max, denom, acc) triple, queries in chunks, never
# the full (S, S) score matrix.
# --------------------------------------------------------------------------
def chunked_attention(
    q: torch.Tensor,        # (B, Sq, H, Dh)
    k: torch.Tensor,        # (B, Sk, Hkv, Dh)
    v: torch.Tensor,        # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    q_offset: int = 0,
    kv_valid_len: Optional[int] = None,
) -> torch.Tensor:
    """Grouped-query flash-style attention.  Returns (B, Sq, H, Dv).

    Query head ``h`` attends with kv head ``h // (H // Hkv)``.  q_offset:
    position of q[0] within the kv sequence (for cached prefill);
    kv_valid_len: mask out kv positions >= this (ragged caches)."""
    if hints.on_mesh(q):  # each rank attends over its own rows and heads
        return hints.per_head(chunked_attention, q, k, v, causal=causal, q_chunk=q_chunk,
                              kv_chunk=kv_chunk, q_offset=q_offset,
                              kv_valid_len=kv_valid_len)
    B, Sq, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = H // Hkv
    dev = q.device
    scale = 1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32, device=dev))
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    if Sq % q_chunk:   # non-divisible (e.g. whisper's 1500 frames): one block
        q_chunk = Sq
    if Sk % kv_chunk:
        kv_chunk = Sk
    nq, nk = Sq // q_chunk, Sk // kv_chunk

    # fold head-groups: q (B, H, Sq, Dh) with H = Hkv * rep; f32 products
    qh = q.permute(0, 2, 1, 3).reshape(B, Hkv, rep, Sq, Dh).to(torch.float32)
    kh = k.permute(0, 2, 1, 3).to(torch.float32)  # (B, Hkv, Sk, Dh)
    vh = v.permute(0, 2, 1, 3)                    # (B, Hkv, Sk, Dv)
    Dv = vh.shape[-1]

    blocks = []
    for qi in range(nq):
        qc = qh[:, :, :, qi * q_chunk:(qi + 1) * q_chunk]
        q_pos = q_offset + qi * q_chunk + torch.arange(q_chunk, device=dev)
        m = torch.full((B, Hkv, rep, q_chunk), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((B, Hkv, rep, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hkv, rep, q_chunk, Dv), dtype=torch.float32, device=dev)
        for ki in range(nk):
            kc = kh[:, :, ki * kv_chunk:(ki + 1) * kv_chunk]
            vc = vh[:, :, ki * kv_chunk:(ki + 1) * kv_chunk]
            s = torch.einsum("bgrqd,bgkd->bgrqk", qc, kc) * scale
            k_pos = ki * kv_chunk + torch.arange(kv_chunk, device=dev)
            mask = torch.ones((q_chunk, kv_chunk), dtype=torch.bool, device=dev)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if kv_valid_len is not None:
                mask = mask & (k_pos[None, :] < kv_valid_len)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            pv = p.to(vc.dtype).to(torch.float32)
            acc = acc * corr[..., None] + torch.einsum(
                "bgrqk,bgkd->bgrqd", pv, vc.to(torch.float32))
            m = m_new
        blocks.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = blocks[0] if nq == 1 else torch.cat(blocks, dim=3)
    return out.reshape(B, H, Sq, Dv).permute(0, 2, 1, 3).to(q.dtype)


def decode_attention(
    q: torch.Tensor,          # (B, 1, H, Dh)
    k_cache: torch.Tensor,    # (B, S, Hkv, Dh)
    v_cache: torch.Tensor,    # (B, S, Hkv, Dv)
    pos: int,                 # number of valid cache entries
) -> torch.Tensor:
    """Single-token attention against a partly filled cache: rows at
    ``pos`` and beyond take no weight.  The caches are cast to q's dtype."""
    if hints.on_mesh(q):  # each rank attends over its own rows and heads
        return hints.per_head(decode_attention, q, k_cache, v_cache, pos)
    B, S, Hkv, Dh = k_cache.shape
    k_cache = k_cache.to(q.dtype)
    v_cache = v_cache.to(q.dtype)
    H = q.shape[2]
    rep = H // Hkv
    scale = 1.0 / torch.sqrt(torch.tensor(Dh, dtype=torch.float32, device=q.device))
    qh = q.reshape(B, Hkv, rep, Dh).to(torch.float32)
    s = torch.einsum("bgrd,bsgd->bgrs", qh, k_cache.to(torch.float32)) * scale
    valid = torch.arange(S, device=q.device)[None, None, None, :] < pos
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgrs,bsgd->bgrd", p.to(v_cache.dtype).to(torch.float32),
                       v_cache.to(torch.float32))
    return out.reshape(B, 1, H, -1).to(q.dtype)
