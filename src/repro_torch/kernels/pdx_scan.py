"""K1 — the whole-store fused scan, hand-written in CUDA for Hopper.

``pdx_prune_scan_multi_cuda`` binds ``csrc/pdx_scan.cu`` (replacing the
TPU kernel ``repro.kernels.pdx_scan.pdx_prune_scan_multi_pallas``): one
launch scans every partition of a mirror with the ADSampling test fused
per d-tile.  Callers go through ``kernels.ops.pdx_prune_scan_multi_op``,
which pads operands and dispatches by device; this wrapper takes CUDA
tensors only and raises on anything else.  ``launches`` counts kernel
launches.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import library

__all__ = ["pdx_prune_scan_multi_cuda"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.uint8: 3}


def _bind():
    lib = library("pdx_scan")
    fn = lib.pdx_prune_scan_multi
    if fn.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, p, p, p, i, i, i, i, i,
                       ctypes.c_float, i, p]
        fn.restype = i
        lib.pdx_scan_error_string.argtypes = [i]
        lib.pdx_scan_error_string.restype = ctypes.c_char_p
    return lib, fn


def _check(t: torch.Tensor, name: str, dtype=None, shape=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pdx_prune_scan_multi_cuda(
    T: torch.Tensor,
    ids: torch.Tensor,
    q: torch.Tensor,
    thr: torch.Tensor,
    scale: torch.Tensor,
    offset: torch.Tensor,
    *,
    dim: int,
    d_tile: int,
    eps0: float,
    quantized: bool,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(P, Drows, V) mirror tiles (uint8 = packed int4), (P, V) int32 ids,
    (Dlog,) f32 q/scale/offset (Dlog = Drows, or 2*Drows when packed),
    (1,) f32 thr on the device -> (dists (P, V) f32, alive (P, V) bool).
    ``dim`` is the logical dimension count the test divides by."""
    if T.dtype not in _DTYPE_CODES:
        raise ValueError(f"unsupported mirror dtype {T.dtype}")
    packed = T.dtype == torch.uint8
    P, Drows, V = T.shape
    Dlog = 2 * Drows if packed else Drows
    if packed and d_tile % 2:
        raise ValueError(f"packed scan needs an even d_tile, got {d_tile}")
    if not (0 < dim <= Dlog and d_tile > 0):
        raise ValueError(f"bad dim={dim} / d_tile={d_tile} for {Dlog} stored dims")
    _check(T, "T")
    _check(ids, "ids", torch.int32, (P, V))
    for name, t in (("q", q), ("scale", scale), ("offset", offset)):
        _check(t, name, torch.float32, (Dlog,))
    _check(thr, "thr", torch.float32, (1,))
    dists = torch.empty((P, V), dtype=torch.float32, device=T.device)
    alive = torch.empty((P, V), dtype=torch.bool, device=T.device)
    lib, fn = _bind()
    rc = fn(
        T.data_ptr(), _DTYPE_CODES[T.dtype], ids.data_ptr(), q.data_ptr(),
        thr.data_ptr(), scale.data_ptr(), offset.data_ptr(), dists.data_ptr(),
        alive.data_ptr(), P, Drows, V, dim, d_tile, float(eps0),
        int(quantized or packed), torch.cuda.current_stream(T.device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(
            "pdx_prune_scan_multi launch failed: "
            + lib.pdx_scan_error_string(rc).decode()
        )
    pdx_prune_scan_multi_cuda.launches += 1
    return dists, alive


pdx_prune_scan_multi_cuda.launches = 0
