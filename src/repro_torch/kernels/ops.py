"""Public kernel wrappers: shape padding, dtype policy and dispatch.

Counterpart of ``repro.kernels.ops``.  Each op dispatches by the device of
its tensors, never by a ``try``: a CPU tensor runs the plain PyTorch
version from ``kernels.ref``; a CUDA tensor launches the hand-written
kernel (``kernels.pdx_scan``, ``kernels.batched_matmul``) or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .batched_matmul import batched_distance_quant_cuda
from .pdx_scan import pdx_prune_scan_multi_cuda

__all__ = ["pdx_prune_scan_multi_op", "batched_distance_quant_op"]


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _unpack_int4_levels(T: torch.Tensor, dim: int) -> torch.Tensor:
    """(..., Dp, V) packed bytes -> (..., dim, V) int8 quantization levels
    (computed in 8-bit integers: no wider copy of the store is made)."""
    axis = T.ndim - 2
    lo = (T & 0xF).to(torch.int8) - 8
    hi = (T >> 4).to(torch.int8) - 8
    shape = list(T.shape)
    shape[axis] *= 2
    return torch.stack([lo, hi], dim=axis + 1).reshape(shape).narrow(axis, 0, dim)


def pdx_prune_scan_multi_op(
    T: torch.Tensor,
    ids: torch.Tensor,
    q: torch.Tensor,
    thr,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    eps0: float = 2.1,
    d_tile: int = 64,
    packed: bool = False,
    dim: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Whole-store fused scan -> ((P, V) dists f32, (P, V) alive bool).

    ``T`` is a device mirror at any scan dtype (f32/bf16/int8/int4);
    ``scale``/``offset`` are the (D,) dequant vectors for quantized mirrors
    (None means plain float operands).  ``packed`` marks an int4 mirror,
    (P, ceil(dim/2), V) uint8 with logical dimensionality ``dim``.  PAD
    lanes (``ids < 0``) start dead.  Dists are meaningful where
    ``ids >= 0`` (the plain version leaves NaN in PAD lanes of f32/bf16
    mirrors, the kernel 0)."""
    D = dim if packed else T.shape[1]
    if _device_kind(T) == "cpu":
        dists, alive = ref.pdx_prune_scan_multi_ref(
            T, ids, q, thr, d_tile=min(d_tile, D), eps0=eps0,
            scale=scale, offset=offset, packed=packed, dim=dim,
        )
        return dists, alive != 0.0
    args, kwargs = _prep_multi(T, ids, q, thr, scale, offset, eps0, d_tile,
                               packed, dim)
    return pdx_prune_scan_multi_cuda(*args, **kwargs)


def _prep_multi(T, ids, q, thr, scale, offset, eps0: float, d_tile: int,
                packed: bool, dim):
    """``(args, kwargs)`` of ``pdx_prune_scan_multi_cuda``, padded by the
    rules of the reference's ``_prep_multi``: a packed int4 mirror keeps an
    even d-tile, and q/scale/offset are zero-padded to the stored (even)
    logical dimension count, so the pad nibble adds exactly 0."""
    D = dim if packed else T.shape[1]
    Dlog = 2 * T.shape[1] if packed else D
    dt = min(d_tile, Dlog)
    if packed:
        dt += dt % 2
    dev = T.device

    def vec(v, fill):
        if v is None:
            return torch.full((Dlog,), fill, dtype=torch.float32, device=dev)
        v = v.to(device=dev, dtype=torch.float32)
        return torch.nn.functional.pad(v, (0, Dlog - v.shape[0])).contiguous()

    thr_t = torch.as_tensor(thr, dtype=torch.float32).to(dev).reshape(1)
    args = (T.contiguous(), ids.to(torch.int32).contiguous(), vec(q, 0.0), thr_t,
            vec(scale, 1.0), vec(offset, 0.0))
    return args, dict(dim=D, d_tile=dt, eps0=eps0, quantized=scale is not None)


def batched_distance_quant_op(
    T: torch.Tensor,
    Q: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    metric: str = "l2",
    packed: bool = False,
    dim: Optional[int] = None,
) -> torch.Tensor:
    """Quantized-operand batch scan: (D, V) mirror tile, or a (P, D, V)
    stack, + (B, D) f32 queries -> (B, V), or (B, P*V) with column
    ``p*V + v``, f32 distances (l2 or ip).  ``packed`` takes int4 bytes
    ((..., ceil(dim/2), V) uint8), unpacked to int8 levels before the
    kernel."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"batched distance takes l2 or ip, got {metric!r}")
    if packed:
        T = _unpack_int4_levels(T, dim)
    stack = T if T.ndim == 3 else T[None]
    P, D, V = stack.shape
    if _device_kind(T) == "cpu":
        out = [ref.batched_distance_quant_ref(t, Q, scale, offset, metric) for t in stack]
        return torch.cat(out, dim=1)
    dev = T.device
    Q32 = Q.to(device=dev, dtype=torch.float32).contiguous()
    qn = torch.sum(Q32 * Q32, dim=1)
    quantized = scale is not None
    sc = scale.to(dev, torch.float32).contiguous() if quantized else torch.ones(
        (D,), dtype=torch.float32, device=dev)
    off = offset.to(dev, torch.float32).contiguous() if quantized else torch.zeros(
        (D,), dtype=torch.float32, device=dev)
    return batched_distance_quant_cuda(
        stack.contiguous(), Q32, qn, sc, off, metric=metric, quantized=quantized,
    )
