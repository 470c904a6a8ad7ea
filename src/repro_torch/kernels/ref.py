"""Plain PyTorch versions of the hand-written kernels, under the
reference's names (counterpart of ``repro.kernels.ref``).

Each ``*_ref`` repeats one kernel's contract (shapes, dtypes, accumulation
in f32) in eager torch.  The kernel wrappers in ``kernels.ops`` run these
for tensors on the CPU; the CUDA kernels are held against them on the
card (``chip_smoke.py``, ``tests/test_torch_kernels.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

__all__ = [
    "dequantize_ref",
    "batched_distance_ref",
    "batched_distance_quant_ref",
    "pdx_prune_scan_multi_ref",
    "ScanTrace",
]


def _unpack_int4_levels(T: torch.Tensor, dim_axis: int) -> torch.Tensor:
    """Packed int4 bytes -> int32 levels in [-8, 7], the packed axis
    doubled (low nibble = even dim, high nibble = odd dim, +8 bias)."""
    p = T.to(torch.int32)
    full = torch.stack([(p & 0xF) - 8, (p >> 4) - 8], dim=dim_axis + 1)
    shape = list(T.shape)
    shape[dim_axis] *= 2
    return full.reshape(shape)


def dequantize_ref(
    T: torch.Tensor,
    scale: Optional[torch.Tensor],
    offset: Optional[torch.Tensor],
    dim_axis: int = 0,
    packed: bool = False,
    dim: Optional[int] = None,
) -> torch.Tensor:
    """Mirror-dtype tile -> f32, applying the per-dimension affine
    ``x * scale + offset`` when scale/offset are given (int8/int4 mirrors;
    f32/bf16 pass None and just upcast).  ``dim_axis`` is the axis holding
    the D values (0 for a (D, V) tile, 1 for (P, D, V) stacks).  ``packed``
    unpacks an int4 two-per-byte tile first, sliced back to ``dim``."""
    if packed:
        T = _unpack_int4_levels(T, dim_axis)
        if dim is not None and dim != T.shape[dim_axis]:
            T = T.narrow(dim_axis, 0, dim)
    T32 = T.to(torch.float32)
    if scale is None:
        return T32
    shape = [1] * T32.ndim
    shape[dim_axis] = -1
    return T32 * scale.reshape(shape) + offset.reshape(shape)


def batched_distance_ref(T: torch.Tensor, Q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """(D, V), (B, D) -> (B, V); l2 or ip (matmul family)."""
    T32 = T.to(torch.float32)
    Q32 = Q.to(torch.float32)
    cross = Q32 @ T32
    if metric == "ip":
        return -cross
    qn = torch.sum(Q32 * Q32, dim=1, keepdim=True)
    xn = torch.sum(T32 * T32, dim=0, keepdim=True)
    return qn - 2.0 * cross + xn


def batched_distance_quant_ref(
    T: torch.Tensor,
    Q: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    metric: str = "l2",
) -> torch.Tensor:
    """Plain version of the quantized batch kernel: dequantize, then the
    exact ``batched_distance_ref`` arithmetic."""
    return batched_distance_ref(dequantize_ref(T, scale, offset), Q, metric)


class ScanTrace(NamedTuple):
    """What ``pdx_prune_scan_multi_ref(..., trace=True)`` also returns.

    ``margin`` (P, V): per lane, the least ``|acc * ratio / bound - 1|``
    over the d-tiles it entered alive — how close its keep test came to
    the bound (a kernel that sums in another order may decide a lane
    differently only where this is tiny).  ``lanes`` / ``parts``
    (n_tiles,): lanes and partitions alive entering each d-tile."""

    margin: torch.Tensor
    lanes: torch.Tensor
    parts: torch.Tensor


def pdx_prune_scan_multi_ref(
    T: torch.Tensor,
    ids: torch.Tensor,
    q: torch.Tensor,
    thr: torch.Tensor,
    *,
    d_tile: int,
    eps0: float,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    packed: bool = False,
    dim: Optional[int] = None,
    trace: bool = False,
):
    """Plain version of the whole-store fused scan.

    (P, D, V) mirror-dtype tiles, (P, V) ids -> (dists (P, V), alive (P, V)
    f32 mask).  Lanes with ``ids < 0`` start dead, operands dequantize
    before the L2 accumulation, and the ADSampling test runs once per
    d-tile: ``acc * (D / d_seen) <= thr * (1 + eps0 / sqrt(d_seen))**2``,
    all in f32.  ``packed`` takes an int4 mirror, (P, ceil(dim/2), V)
    uint8 with logical ``dim``.  ``trace=True`` adds a third result, the
    walk's ``ScanTrace``."""
    T32 = dequantize_ref(T, scale, offset, dim_axis=1, packed=packed, dim=dim)
    P, D, V = T32.shape
    q32 = torch.as_tensor(q, dtype=torch.float32, device=T32.device)
    thr = torch.as_tensor(thr, dtype=torch.float32, device=T32.device)
    acc = torch.zeros((P, V), dtype=torch.float32, device=T32.device)
    alive = (torch.as_tensor(ids, device=T32.device) >= 0).to(torch.float32)
    if trace:
        margin = torch.full((P, V), float("inf"), device=T32.device)
        lanes, parts = [], []
    d_seen = 0
    while d_seen < D:
        hi = min(d_seen + d_tile, D)
        if trace:
            lanes.append(torch.sum(alive))
            parts.append(torch.sum(torch.any(alive > 0, dim=1)))
        blk = T32[:, d_seen:hi, :] - q32[None, d_seen:hi, None]
        contrib = torch.sum(blk * blk, dim=1)
        acc = acc + contrib * alive
        d_seen = hi
        lhs = acc * _ratio(D, d_seen)
        bound = thr * _inflation(eps0, d_seen)
        if trace:
            margin = torch.where(alive > 0,
                                 torch.minimum(margin, (lhs / bound - 1).abs()), margin)
        alive = alive * (lhs <= bound).to(torch.float32)
    if not trace:
        return acc, alive
    return acc, alive, ScanTrace(margin, torch.stack(lanes), torch.stack(parts))


# The test's scalars, rounded as the reference rounds them: every operand
# an f32 and every operation a true f32 division, root or product (NumPy
# f32 scalars; a Python scalar divided by a torch tensor would go through
# ``reciprocal() * x``, which rounds differently and flips lanes at the
# bound).  The returned Python floats hold exact f32 values, so multiplying
# an f32 tensor by them is a plain f32 product.
def _ratio(dim: int, d_seen: int) -> float:
    """f32 ``dim / d_seen``."""
    return float(np.float32(dim) / np.float32(d_seen))


def _inflation(eps0: float, d_seen: int) -> float:
    """f32 ``(1 + eps0 / sqrt(d_seen))**2``, the squared-space factor."""
    s = np.float32(1.0) + np.float32(eps0) / np.sqrt(np.float32(d_seen))
    return float(s * s)
