"""K2 and K7 — batched query-vs-tile distances, hand-written in CUDA for Hopper.

``batched_distance_quant_cuda`` binds ``csrc/batched_matmul.cu``
(replacing the TPU kernel
``repro.kernels.batched_matmul.batched_distance_quant_pallas``): one
launch computes ``||q||^2 - 2 q.x^ + ||x^||^2`` (or ``-q.x^``) for a query
batch against every tile of a stacked (P, D, V) mirror (f32, bf16, int8,
or int4 packed two dims a byte), the product on the tensor cores in an
exact bf16 split that the launch makes from the f32 queries into a
workspace (``_workspace``; plain versions of its split and scale fold:
``ref.split_bf16``, ``ref.fold_scale``).  Callers go through
``kernels.ops.batched_distance_quant_op``, which dispatches by device;
this wrapper takes CUDA tensors only and raises on anything else.
``launches`` counts calls that launch the kernel (the query split, then
the main kernel).

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

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}
#: partitions one launch takes
MAX_PARTITIONS = 65535


def _workspace(B: int, D: int, device) -> torch.Tensor:
    """The device memory a launch splits B queries of D dims into."""
    n = bind("batched_matmul", "batched_matmul_workspace_bytes", "ii")(B, D)
    if n < 0:
        raise ValueError(f"{B} queries of {D} dims are too many for one launch")
    return torch.empty(n, dtype=torch.uint8, device=device)


def _aligned(T: torch.Tensor, V: int) -> int:
    """1 when every 8-lane unit of a tile row can be read with one aligned
    vector load (16 bytes; 8 for int8), else 0 (scalar loads)."""
    step = 4 if T.dtype == torch.float32 else 8
    nbytes = 8 if T.element_size() == 1 else 16
    return int(V % step == 0 and T.data_ptr() % nbytes == 0)


def batched_distance_quant_cuda(
    T: torch.Tensor,
    Q: torch.Tensor,
    qn: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    *,
    metric: str,
    dim: Optional[int] = None,
) -> torch.Tensor:
    """(P, D, V) f32/bf16/int8 tiles, or int4 levels packed two dims a byte
    ((P, ceil(dim/2), V) uint8, ``dim`` dims), (B, D) f32 queries, (B,) f32
    query norms, and for a quantized mirror (int8, int4) its (D,) f32
    scale/offset -> (B, P*V) f32, column ``p*V + v``."""
    _check(T, "T")
    if T.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported tile dtype {T.dtype}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"batched distance kernel takes l2 or ip, got {metric!r}")
    P, D, V = T.shape
    quantized = scale is not None
    if T.dtype == torch.uint8:
        if dim is None or -(-dim // 2) != D or not quantized:
            raise ValueError(f"packed int4 tiles take dim with ceil(dim/2) = {D} rows and "
                             f"their scale, got dim={dim}")
        D = dim
    B = Q.shape[0]
    if P > MAX_PARTITIONS:
        raise ValueError(f"at most {MAX_PARTITIONS} partitions per launch, got {P}")
    _check(Q, "Q", torch.float32, (B, D))
    _check(qn, "qn", torch.float32, (B,))
    if quantized:
        _check(scale, "scale", torch.float32, (D,))
        _check(offset, "offset", torch.float32, (D,))
    out = torch.empty((B, P * V), dtype=torch.float32, device=T.device)
    work = _workspace(B, D, T.device)
    fn = bind("batched_matmul", "batched_distance_quant", "pi" + "p" * 6 + "i" * 6 + "p")
    rc = fn(
        T.data_ptr(), _DTYPE_CODES[T.dtype], Q.data_ptr(), qn.data_ptr(),
        scale.data_ptr() if quantized else None, offset.data_ptr() if quantized else None,
        work.data_ptr(), out.data_ptr(), P, B, D, V, int(metric == "ip"), _aligned(T, V),
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
    """(D, V) f32/bf16 tile, (B, D) f32 or bf16 queries (bf16 queries go
    in as one plane of their f32 values, f32 queries as three), (B,) f32
    ``||q||^2``, (V,) f32 ``||x||^2`` -> (B, V) f32: ``qn - 2 Q T + xn``
    (l2) or ``-Q T`` (ip, which takes None for both norms)."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"batched distance kernel takes l2 or ip, got {metric!r}")
    _check(T, "T")
    if T.dtype not in (torch.float32, torch.bfloat16) or T.ndim != 2:
        raise ValueError(f"T must be a 2-d f32 or bf16 tensor, got {T.dtype} {tuple(T.shape)}")
    D, V = T.shape
    B = Q.shape[0]
    if Q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"Q must be f32 or bf16, got {Q.dtype}")
    _check(Q, "Q", None, (B, D))
    if metric == "l2":
        _check(qn, "qn", torch.float32, (B,))
        _check(xn, "xn", torch.float32, (V,))
    else:
        qn = xn = None
    planes = 3 if Q.dtype == torch.float32 else 1
    Q = Q.to(torch.float32)
    out = torch.empty((B, V), dtype=torch.float32, device=T.device)
    work = _workspace(B, D, T.device)
    fn = bind("batched_matmul", "batched_distance", "pipi" + "p" * 4 + "i" * 5 + "p")
    rc = fn(T.data_ptr(), _DTYPE_CODES[T.dtype], Q.data_ptr(), planes,
            None if qn is None else qn.data_ptr(), None if xn is None else xn.data_ptr(),
            work.data_ptr(), out.data_ptr(), B, D, V, int(metric == "ip"), _aligned(T, V),
            torch.cuda.current_stream(T.device).cuda_stream)
    check_launch("batched_matmul", "batched_distance", rc)
    batched_distance_cuda.launches += 1
    return out


batched_distance_quant_cuda.launches = 0
batched_distance_cuda.launches = 0
