"""K2 — batched query-vs-tile distances, hand-written in CUDA for Hopper.

``batched_distance_quant_cuda`` binds ``csrc/batched_matmul.cu``
(replacing the TPU kernel
``repro.kernels.batched_matmul.batched_distance_quant_pallas``): one
launch computes ``||q||^2 - 2 q.x^ + ||x^||^2`` (or ``-q.x^``) for a query
batch against every tile of a stacked (P, D, V) mirror, dequantizing in
registers.  Callers go through ``kernels.ops.batched_distance_quant_op``,
which unpacks int4 and dispatches by device; this wrapper takes CUDA
tensors only and raises on anything else.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import library
from .pdx_scan import _check

__all__ = ["batched_distance_quant_cuda", "MAX_PARTITIONS"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
#: partitions one launch takes (they ride on grid.z)
MAX_PARTITIONS = 65535


def _bind():
    lib = library("batched_matmul")
    fn = lib.batched_distance_quant
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, i, i, i, i, i, i, p]
        fn.restype = i
        lib.batched_matmul_error_string.argtypes = [i]
        lib.batched_matmul_error_string.restype = ctypes.c_char_p
    return lib, fn


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
    lib, fn = _bind()
    rc = fn(
        T.data_ptr(), _DTYPE_CODES[T.dtype], Q.data_ptr(), qn.data_ptr(),
        scale.data_ptr(), offset.data_ptr(), out.data_ptr(), P, B, D, V,
        int(quantized), int(metric == "ip"),
        torch.cuda.current_stream(T.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "batched_distance_quant launch failed: "
            + lib.batched_matmul_error_string(rc).decode()
        )
    batched_distance_quant_cuda.launches += 1
    return out


batched_distance_quant_cuda.launches = 0
