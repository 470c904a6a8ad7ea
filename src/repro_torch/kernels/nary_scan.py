"""K5 — the horizontal (N-ary) distance scan, hand-written in CUDA for Hopper.

``nary_distance_cuda`` binds ``csrc/nary_scan.cu`` (replacing the TPU
kernel ``repro.kernels.nary_scan.nary_distance_pallas``): the paper's
baseline layout, (N, D) rows against one query, each row's sum a
horizontal reduction over the threads that read it.  Callers go through
``kernels.ops.nary_distance_op``, which dispatches by device; this wrapper
takes CUDA tensors only and raises on anything else.  ``launches`` counts
kernel launches.
"""
from __future__ import annotations

import torch

from ._build import bind, check_launch
from .pdx_scan import METRIC_CODES, _check

__all__ = ["nary_distance_cuda"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def nary_distance_cuda(X: torch.Tensor, q: torch.Tensor, metric: str) -> torch.Tensor:
    """(N, D) f32/bf16 rows, (D,) f32 query -> (N,) f32 distances: l2,
    l1 or negated ip."""
    if metric not in METRIC_CODES:
        raise ValueError(f"metric must be one of {tuple(METRIC_CODES)}, got {metric!r}")
    _check(X, "X")
    if X.dtype not in _DTYPE_CODES or X.ndim != 2:
        raise ValueError(f"X must be (N, D) f32 or bf16 rows, got {X.dtype} {tuple(X.shape)}")
    N, D = X.shape
    _check(q, "q", torch.float32, (D,))
    out = torch.empty((N,), dtype=torch.float32, device=X.device)
    fn = bind("nary_scan", "nary_distance", "pippiiip")
    rc = fn(X.data_ptr(), _DTYPE_CODES[X.dtype], q.data_ptr(), out.data_ptr(), N, D,
            METRIC_CODES[metric], torch.cuda.current_stream(X.device).cuda_stream)
    check_launch("nary_scan", "nary_distance", rc)
    nary_distance_cuda.launches += 1
    return out


nary_distance_cuda.launches = 0
