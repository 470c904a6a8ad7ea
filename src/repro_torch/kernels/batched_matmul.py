"""K2 and K7 — batched query-vs-tile distances, hand-written in CUDA for Hopper.

``batched_distance_quant_cuda`` binds ``csrc/batched_matmul.cu``
(replacing the TPU kernel
``repro.kernels.batched_matmul.batched_distance_quant_pallas``): one
launch computes ``||q||^2 - 2 q.x^ + ||x^||^2`` (or ``-q.x^``) for a query
batch against every tile of a stacked (P, D, V) mirror, dequantizing in
registers.  Callers go through ``kernels.ops.batched_distance_quant_op``,
which unpacks int4 and dispatches by device; this wrapper takes CUDA
tensors only and raises on anything else.  ``launches`` counts kernel
launches.

``batched_distance_cuda`` (K7, replacing
``repro.kernels.batched_matmul.batched_distance_pallas``) is the same
kernel over one f32 or bf16 (D, V) tile with the norms given: the caller
(``kernels.ops.batched_distance_op``) computes them outside the kernel, as
the reference's wrapper does.
"""
from __future__ import annotations

from typing import Optional

import torch

from ._build import bind, check_launch
from .pdx_scan import _check

__all__ = ["batched_distance_quant_cuda", "batched_distance_cuda", "MAX_PARTITIONS"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: partitions one launch takes (they ride on grid.z)
MAX_PARTITIONS = 65535


def batched_distance_quant_cuda(
    T: torch.Tensor,
    Q: torch.Tensor,
    qn: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    *,
    metric: str,
    quantized: bool,
) -> torch.Tensor:
    """(P, D, V) f32/bf16/int8 tiles, (B, D) f32 queries, (B,) f32 query
    norms, (D,) f32 scale/offset -> (B, P*V) f32, column ``p*V + v``."""
    if T.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported tile dtype {T.dtype}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"batched distance kernel takes l2 or ip, got {metric!r}")
    P, D, V = T.shape
    B = Q.shape[0]
    if P > MAX_PARTITIONS:
        raise ValueError(f"at most {MAX_PARTITIONS} partitions per launch, got {P}")
    _check(T, "T")
    _check(Q, "Q", torch.float32, (B, D))
    _check(qn, "qn", torch.float32, (B,))
    _check(scale, "scale", torch.float32, (D,))
    _check(offset, "offset", torch.float32, (D,))
    out = torch.empty((B, P * V), dtype=torch.float32, device=T.device)
    fn = bind("batched_matmul", "batched_distance_quant", "pipppppiiiiiip")
    rc = fn(
        T.data_ptr(), _DTYPE_CODES[T.dtype], Q.data_ptr(), qn.data_ptr(),
        scale.data_ptr(), offset.data_ptr(), out.data_ptr(), P, B, D, V,
        int(quantized), int(metric == "ip"),
        torch.cuda.current_stream(T.device).cuda_stream,
    )
    check_launch("batched_matmul", "batched_distance_quant", rc)
    batched_distance_quant_cuda.launches += 1
    return out


def batched_distance_cuda(
    T: torch.Tensor,
    Q: torch.Tensor,
    qn: Optional[torch.Tensor],
    xn: Optional[torch.Tensor],
    *,
    metric: str,
) -> torch.Tensor:
    """(D, V) f32/bf16 tile, (B, D) f32/bf16 queries, (B,) f32 ``||q||^2``,
    (V,) f32 ``||x||^2`` -> (B, V) f32: ``qn - 2 Q T + xn`` (l2) or
    ``-Q T`` (ip, which takes None for both norms)."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"batched distance kernel takes l2 or ip, got {metric!r}")
    _check(T, "T")
    _check(Q, "Q")
    for name, t in (("T", T), ("Q", Q)):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.ndim != 2:
            raise ValueError(f"{name} must be a 2-d f32 or bf16 tensor, got {t.dtype} "
                             f"{tuple(t.shape)}")
    D, V = T.shape
    B = Q.shape[0]
    if Q.shape[1] != D:
        raise ValueError(f"Q must have shape ({B}, {D}), got {tuple(Q.shape)}")
    if metric == "l2":
        _check(qn, "qn", torch.float32, (B,))
        _check(xn, "xn", torch.float32, (V,))
    else:
        qn = xn = None
    codes = {torch.float32: 0, torch.bfloat16: 1}
    out = torch.empty((B, V), dtype=torch.float32, device=T.device)
    fn = bind("batched_matmul", "batched_distance", "pipipppiiiip")
    rc = fn(T.data_ptr(), codes[T.dtype], Q.data_ptr(), codes[Q.dtype],
            None if qn is None else qn.data_ptr(), None if xn is None else xn.data_ptr(),
            out.data_ptr(), B, D, V, int(metric == "ip"),
            torch.cuda.current_stream(T.device).cuda_stream)
    check_launch("batched_matmul", "batched_distance", rc)
    batched_distance_cuda.launches += 1
    return out


batched_distance_quant_cuda.launches = 0
batched_distance_cuda.launches = 0
