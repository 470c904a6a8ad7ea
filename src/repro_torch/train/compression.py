"""Gradient compression for the data-parallel all-reduce: int8 quantization
with error feedback (counterpart of ``repro.train.compression``).

  * ``quantize``/``dequantize`` — pure transforms.
  * ``ef_compress`` — error feedback: what a compressed all-reduce would
    deliver, and the quantization error carried to the next step.
  * ``compressed_psum`` — the collective on ``torch.distributed``: every
    rank quantizes against the largest scale of the axis (``pmax``), the
    int8 payloads are summed as int32 (``psum``) and dequantized to the
    mean.  It goes through the port's counted collectives.

Rounding is half to even (``torch.round``, as ``jnp.round``).  The
arithmetic is the reference's as its train step runs it, under ``jit``:
the scale is ``max|g| * f32(1/127)`` (XLA turns the division by the
constant 127 into that product, which rounds differently from a true
division for about 1 in 20 scales), and the residual ``corrected - q s``
is rounded once, as XLA's fused multiply-subtract rounds it.  The
reference called op by op divides and rounds twice.
"""
from __future__ import annotations

import torch

from ..dist import pmax, psum
from ._tree import tree_map

__all__ = ["quantize", "dequantize", "ef_compress", "compressed_psum", "ef_init"]

F32 = torch.float32
_INV_127 = 1.0 / 127.0  # multiplied into an f32 tensor: XLA's f32 reciprocal


def quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor symmetric int8: returns (q int8, scale f32 0-d)."""
    g32 = g.to(F32)
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) * _INV_127
    return _levels(g32, scale), scale


def _levels(g32: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype=F32) -> torch.Tensor:
    return (q.to(F32) * scale).to(dtype)


def ef_init(grads):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=F32, device=g.device), grads)


@torch.no_grad()
def ef_compress(grads, residual):
    """Error-feedback compression: (grads, residual) -> (decompressed grads,
    new residual).  The returned grads are exactly what a compressed
    all-reduce would deliver; the quantization error is carried, not lost.
    The residual's tensors are updated in place and returned (its leaves
    hold ``corrected - dequantized``)."""

    def one(g, e):
        corrected = e.add_(g.to(F32))  # g + e, in e's buffer
        q, s = quantize(corrected)
        # corrected - q s, rounded once: the f64 product and difference are
        # exact, as in the fused multiply-subtract XLA emits for it
        e.copy_(corrected.to(torch.float64) - q.to(torch.float64) * s.to(torch.float64))
        return dequantize(q, s, g.dtype)

    return tree_map(one, grads, residual), residual


@torch.no_grad()
def compressed_psum(grads, mesh, axis: str):
    """int8-payload gradient all-reduce over the ranks of ``axis`` of
    ``mesh``: quantize locally, sum int8 payloads as int32 across the axis,
    dequantize with the max scale, divide by the rank count.  Wire bytes:
    1/4 of an f32 psum (+ one scalar per tensor).  Every rank gets the same
    result; call it on every rank with the same tree structure."""

    def one(g):
        _, s = quantize(g)
        s_max = pmax(s, mesh, axis)
        # requantize against the shared scale so the int32 sum is coherent
        q_shared = _levels(g.to(F32), s_max)
        total = psum(q_shared.to(torch.int32), mesh, axis)
        n = psum(torch.ones((), dtype=F32, device=g.device), mesh, axis)
        return (total.to(F32) * s_max / n).to(g.dtype)

    return tree_map(one, grads)
