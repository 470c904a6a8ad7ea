"""Public kernel wrappers: shape padding, dtype policy and dispatch.

Counterpart of ``repro.kernels.ops``.  Each op dispatches by the device of
its tensors, never by a ``try``: a CPU tensor runs the plain PyTorch
version from ``kernels.ref``; a CUDA tensor launches the hand-written
kernel (``kernels.pdx_scan``, ``kernels.nary_scan``,
``kernels.batched_matmul``) or raises.

The reference zero-pads the operands of its plain scans
(``pdx_distance_op``, ``nary_distance_op``, ``batched_distance_op``,
``pdx_prune_scan_op``) to whole ``_pick`` tiles, since a Pallas block must
be whole, and marks padded lanes dead with ``ids = -1``.  Their kernels
here mask the ragged edge themselves, which gives the same values (a zero
dimension adds 0 to every metric, a lane past V does not exist, the test
still divides by the logical D), so these ops copy nothing.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import ref
from .batched_matmul import batched_distance_cuda, batched_distance_quant_cuda
from .nary_scan import nary_distance_cuda
from .pdx_scan import (
    METRIC_CODES,
    pdx_distance_cuda,
    pdx_prune_scan_cuda,
    pdx_prune_scan_multi_cuda,
    pdx_prune_scan_multi_prefetch_cuda,
)

__all__ = [
    "pdx_distance_op",
    "nary_distance_op",
    "batched_distance_op",
    "pdx_prune_scan_op",
    "pdx_prune_scan_multi_op",
    "pdx_prune_scan_multi_prefetch_op",
    "batched_distance_quant_op",
    "batched_cascade_stage_op",
]


def _device_kind(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {t.device}")
    return t.device.type


def _check_metric(metric: str, allowed=tuple(METRIC_CODES)) -> None:
    if metric not in allowed:
        raise ValueError(f"metric must be one of {allowed}, got {metric!r}")


def _f32_on(v, dev) -> torch.Tensor:
    return v.to(device=dev, dtype=torch.float32).contiguous()


def pdx_distance_op(T: torch.Tensor, q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """(D, V) f32/bf16 PDX tile, (D,) query -> (V,) f32 distances (l2, l1
    or negated ip), accumulated in f32."""
    _check_metric(metric)
    if _device_kind(T) == "cpu":
        return ref.pdx_distance_ref(T, q, metric)
    return pdx_distance_cuda(T.contiguous(), _f32_on(q, T.device), metric)


def nary_distance_op(X: torch.Tensor, q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """(N, D) f32/bf16 rows, (D,) query -> (N,) f32 distances (l2, l1 or
    negated ip), accumulated in f32."""
    _check_metric(metric)
    if _device_kind(X) == "cpu":
        return ref.nary_distance_ref(X, q, metric)
    return nary_distance_cuda(X.contiguous(), _f32_on(q, X.device), metric)


def batched_distance_op(T: torch.Tensor, Q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """(D, V) f32/bf16 tile, (B, D) queries -> (B, V) f32 distances, l2 or
    negated ip.  The norms are plain reductions outside the kernel, as the
    reference computes them outside its ``pallas_call``; each is one
    reduction in f32 over the operand as stored, so no f32 copy of T is
    made."""
    _check_metric(metric, ("l2", "ip"))
    if _device_kind(T) == "cpu":
        return ref.batched_distance_ref(T, Q, metric)
    T = T.contiguous()
    Q = Q.to(T.device).contiguous()
    qn = xn = None
    if metric == "l2":
        qn = squared_norms(Q, dim=1)
        xn = squared_norms(T, dim=0)
    return batched_distance_cuda(T, Q, qn, xn, metric=metric)


def squared_norms(A: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum of squares of ``A`` along ``dim`` in f32, without a temporary
    of ``A``'s size (the reduction upcasts bf16 as it reads)."""
    return torch.linalg.vector_norm(A, dim=dim, dtype=torch.float32).square()


def pdx_prune_scan_op(
    T: torch.Tensor,
    q: torch.Tensor,
    thr,
    ids: Optional[torch.Tensor] = None,
    eps0: float = 2.1,
    d_tile: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused PDXearch + ADSampling scan of one (D, V) partition ->
    (dists (V,) f32, alive (V,) bool).

    ``ids`` is the partition's (V,) id row: lanes with ``ids < 0`` (PAD
    columns) start dead and never surface; None means every lane is real.
    The test divides by the logical D; a pruned lane reports its partial
    distance."""
    D = T.shape[0]
    dt = min(d_tile, D)
    if _device_kind(T) == "cpu":
        dists, alive = ref.pdx_prune_scan_ref(T, q, thr, d_tile=dt, eps0=eps0, ids=ids)
        return dists, alive != 0.0
    dev = T.device
    thr_t = torch.as_tensor(thr, dtype=torch.float32).to(dev).reshape(1)
    ids_t = None if ids is None else ids.to(device=dev, dtype=torch.int32).contiguous()
    return pdx_prune_scan_cuda(T.contiguous(), ids_t, _f32_on(q, dev), thr_t, d_tile=dt,
                               eps0=eps0)


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


def pdx_prune_scan_multi_prefetch_op(
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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefetch-skip scan of the later cascade stages -> ((P, V) dists f32,
    (P, V) alive bool, (P,) streamed f32).

    ``pdx_prune_scan_multi_op``'s contract, where ``ids < 0`` also marks
    the lanes a previous stage killed; ``streamed`` counts the d-tiles each
    partition fetched (a partition that enters dead fetches none and
    reports dist 0, alive false).  The reference builds a (partition,
    d-tile) schedule for this on the TPU; on the card every block skips on
    its own, so the op only pads."""
    D = dim if packed else T.shape[1]
    if _device_kind(T) == "cpu":
        dists, alive, streamed = ref.pdx_prune_scan_multi_dskip_ref(
            T, ids, q, thr, d_tile=min(d_tile, D), eps0=eps0,
            scale=scale, offset=offset, packed=packed, dim=dim,
        )
        return dists, alive != 0.0, streamed
    args, kwargs = _prep_multi(T, ids, q, thr, scale, offset, eps0, d_tile,
                               packed, dim)
    return pdx_prune_scan_multi_prefetch_cuda(*args, **kwargs)


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
    ((..., ceil(dim/2), V) uint8): the plain version unpacks it to int8
    levels first, the kernel reads the packed bytes."""
    if metric not in ("l2", "ip"):
        raise ValueError(f"batched distance takes l2 or ip, got {metric!r}")
    if _device_kind(T) == "cpu":
        if packed:
            T = _unpack_int4_levels(T, dim)
        stack = T if T.ndim == 3 else T[None]
        out = [ref.batched_distance_quant_ref(t, Q, scale, offset, metric) for t in stack]
        return torch.cat(out, dim=1)
    stack = T if T.ndim == 3 else T[None]
    dev = T.device
    Q32 = Q.to(device=dev, dtype=torch.float32).contiguous()
    qn = torch.sum(Q32 * Q32, dim=1)
    sc = off = None
    if scale is not None:
        sc, off = _f32_on(scale, dev), _f32_on(offset, dev)
    return batched_distance_quant_cuda(
        stack.contiguous(), Q32, qn, sc, off, metric=metric, dim=dim if packed else None,
    )


def batched_cascade_stage_op(
    T: torch.Tensor,
    alive: torch.Tensor,
    Q: torch.Tensor,
    thr: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    eps0: float = 2.1,
    d_tile: int = 64,
    packed: bool = False,
    dim: Optional[int] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched cascade stage: (Dp, S) compacted survivor columns + (B, D)
    stage queries, (B, S) entry alive, (B,) thresholds -> ((B, S) dists f32,
    (B, S) alive bool).

    The d-tile walk of ``ref.batched_cascade_stage_ref``, where each d-tile
    runs ``batched_distance_quant_op`` (K2 on the card) over the whole
    batch.  ``packed`` int4 columns unpack to int8 levels once up front."""
    if packed:
        T = _unpack_int4_levels(T, dim)

    def k2_tile(t, q, s, o):
        return batched_distance_quant_op(t, q, s, o, "l2")

    acc, a = ref.batched_cascade_stage_ref(T, alive, Q, thr, scale, offset, eps0=eps0,
                                           d_tile=d_tile, distance=k2_tile)
    return acc, a != 0.0
