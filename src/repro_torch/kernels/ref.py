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
    "pdx_distance_ref",
    "nary_distance_ref",
    "batched_distance_ref",
    "batched_distance_quant_ref",
    "pdx_prune_scan_ref",
    "pdx_prune_scan_multi_ref",
    "pdx_prune_scan_multi_dskip_ref",
    "batched_cascade_stage_ref",
    "split_bf16",
    "fold_scale",
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


def pdx_distance_ref(T: torch.Tensor, q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """(D, V), (D,) -> (V,) float32 accumulation regardless of input dtype."""
    T32 = T.to(torch.float32)
    q32 = q.to(torch.float32)
    if metric == "l2":
        d = T32 - q32[:, None]
        return torch.sum(d * d, dim=0)
    if metric == "l1":
        return torch.sum(torch.abs(T32 - q32[:, None]), dim=0)
    return -torch.sum(T32 * q32[:, None], dim=0)


def nary_distance_ref(X: torch.Tensor, q: torch.Tensor, metric: str = "l2") -> torch.Tensor:
    """(N, D), (D,) -> (N,)."""
    X32 = X.to(torch.float32)
    q32 = q.to(torch.float32)
    if metric == "l2":
        d = X32 - q32[None, :]
        return torch.sum(d * d, dim=1)
    if metric == "l1":
        return torch.sum(torch.abs(X32 - q32[None, :]), dim=1)
    return -torch.sum(X32 * q32[None, :], dim=1)


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


def split_bf16(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` -> (3, *x.shape) bf16 with ``x1 + x2 + x3 == x``
    exactly: each plane is the bf16 rounding of what the earlier ones left
    (an exact f32 difference), and three bf16 carry all 24 significant bits
    of an f32.  Plain version of the split the tensor-core K2/K7 make of
    the queries and of an f32 tile (``csrc/batched_matmul.cu:split``),
    bit for bit: products ``x_i * t`` with a bf16-exact ``t`` are exact in
    f32."""
    out = []
    r = x.to(torch.float32)
    for _ in range(3):
        h = r.to(torch.bfloat16)
        out.append(h)
        r = r - h.to(torch.float32)
    return torch.stack(out)


def fold_scale(Q: torch.Tensor, scale: torch.Tensor,
               offset: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, D) f32 queries and a mirror's (D,) dequant vectors -> ``(Q * scale,
    Q @ offset)``: ``q.x^ = (q * scale).x + q.offset`` for ``x^ = x * scale
    + offset``, so the product takes the stored levels as they are and the
    offset term is one f32 constant per query.  Plain version of K2's fold
    on a quantized mirror (the kernel sums ``Q @ offset`` in another
    order)."""
    Q = Q.to(torch.float32)
    s = scale.to(device=Q.device, dtype=torch.float32)
    o = offset.to(device=Q.device, dtype=torch.float32)
    return (Q * s[None, :]).contiguous(), torch.sum(Q * o[None, :], dim=1)


class ScanTrace(NamedTuple):
    """What ``pdx_prune_scan_multi_ref(..., trace=True)`` also returns.

    ``margin`` (P, V): per lane, the least ``|acc * ratio / bound - 1|``
    over the d-tiles it entered alive — how close its keep test came to
    the bound (a kernel that sums in another order may decide a lane
    differently only where this is tiny).  ``lanes`` / ``parts``
    (n_tiles,): lanes and partitions alive entering each d-tile.
    ``sectors`` (n_tiles,): the 32-byte sectors of a stored row (runs of
    ``32 // element size`` lanes from each partition's lane 0: 8 f32, 16
    bf16, 32 int8 or packed int4 lanes) that hold a lane alive entering
    each d-tile — what a kernel reading only live lanes still fetches
    (the partition scans' walk only)."""

    margin: torch.Tensor
    lanes: torch.Tensor
    parts: torch.Tensor
    sectors: Optional[torch.Tensor] = None


def pdx_prune_scan_ref(
    T: torch.Tensor,
    q: torch.Tensor,
    thr,
    *,
    d_tile: int,
    eps0: float,
    ids: Optional[torch.Tensor] = None,
    trace: bool = False,
):
    """Plain version of the fused PDXearch + ADSampling partition scan.

    (D, V) tile, (D,) query -> (dists (V,), alive (V,) f32 mask).  Walks
    d-tiles of ``d_tile`` dims; after each the ADSampling test runs at the
    dims seen so far, and a pruned lane's accumulator freezes at its partial
    distance.  ``ids`` is the partition's (V,) id row: lanes with
    ``ids < 0`` (PAD columns) start dead; None means every lane is real.
    The whole-store walk with one partition, so the test's scalars are true
    f32 operations.  ``trace=True`` adds the walk's ``ScanTrace``
    (``lanes``: lanes alive entering each d-tile)."""
    V = T.shape[1]
    if ids is None:
        ids = torch.zeros((V,), dtype=torch.int32, device=T.device)
    acc, alive, _, walk = _multi_walk(T[None], torch.as_tensor(ids)[None], q, thr, d_tile,
                                      eps0, None, None, False, None, trace)
    if trace:
        return acc[0], alive[0], walk._replace(margin=walk.margin[0])
    return acc[0], alive[0]


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
    acc, alive, _, walk = _multi_walk(T, ids, q, thr, d_tile, eps0, scale,
                                      offset, packed, dim, trace)
    return (acc, alive, walk) if trace else (acc, alive)


def pdx_prune_scan_multi_dskip_ref(
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
    """Plain version of the prefetch-skip scan of the later cascade stages:
    the dists and alive mask of ``pdx_prune_scan_multi_ref``, plus
    ``streamed`` (P,) f32, the d-tiles each partition fetches — a tile is
    fetched iff any lane of the partition is alive when it is reached, so an
    entry-dead partition fetches none.  ``trace=True`` adds the walk's
    ``ScanTrace`` as a fourth result."""
    acc, alive, streamed, walk = _multi_walk(T, ids, q, thr, d_tile, eps0, scale,
                                             offset, packed, dim, trace)
    return (acc, alive, streamed, walk) if trace else (acc, alive, streamed)


def batched_cascade_stage_ref(
    T: torch.Tensor,
    alive: torch.Tensor,
    Q: torch.Tensor,
    thr: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    offset: Optional[torch.Tensor] = None,
    *,
    eps0: float,
    d_tile: int,
    packed: bool = False,
    dim: Optional[int] = None,
    trace: bool = False,
    distance=None,
):
    """Plain version of the batched cascade stage: (D, S) compacted
    survivor columns at mirror dtype, (B, S) entry alive, (B, D) stage
    queries, (B,) thresholds -> (dists (B, S) f32, alive (B, S) f32 mask).

    Each d-tile adds ``distance(T tile, Q tile, scale tile, offset tile)``,
    a (B, S) L2 (``batched_distance_quant_ref`` unless given; the op passes
    K2), to the slots still alive; dead slots keep their partial sums and
    never revive, and after each tile the ADSampling test fires as in the
    per-query scan, ``acc * (D / d_seen) <= thr * (1 + eps0 /
    sqrt(d_seen))**2``, with the scalars rounded as f32 operations.
    ``trace=True`` adds a ``ScanTrace`` over (query, slot) pairs: ``lanes``
    counts the pairs and ``parts`` the slots any query keeps, alive
    entering each d-tile."""
    if packed:
        T = _unpack_int4_levels(T, 0).narrow(0, 0, dim)
    if distance is None:
        def distance(t, q, s, o):
            return batched_distance_quant_ref(t, q, s, o, "l2")
    D = T.shape[0]
    quantized = scale is not None
    a = torch.as_tensor(alive, device=T.device).to(torch.float32)
    acc = torch.zeros((Q.shape[0], T.shape[1]), dtype=torch.float32, device=T.device)
    thr_col = torch.as_tensor(thr, dtype=torch.float32, device=T.device).reshape(-1, 1)
    margin = torch.full_like(acc, float("inf")) if trace else None
    lanes, parts = [], []
    d_seen = 0
    while d_seen < D:
        hi = min(d_seen + d_tile, D)
        if trace:
            lanes.append(torch.sum(a))
            parts.append(torch.sum(torch.any(a > 0, dim=0)))
        contrib = distance(
            T[d_seen:hi], Q[:, d_seen:hi],
            scale[d_seen:hi] if quantized else None,
            offset[d_seen:hi] if quantized else None,
        )
        acc = acc + contrib * a
        d_seen = hi
        lhs = acc * _ratio(D, d_seen)
        bound = thr_col * _inflation(eps0, d_seen)
        if trace:
            margin = torch.where(a > 0, torch.minimum(margin, (lhs / bound - 1).abs()),
                                 margin)
        a = a * (lhs <= bound).to(torch.float32)
    if trace:
        return acc, a, ScanTrace(margin, torch.stack(lanes), torch.stack(parts))
    return acc, a


def _multi_walk(T, ids, q, thr, d_tile, eps0, scale, offset, packed, dim, trace):
    """The d-tile walk both scans share -> (acc, alive, streamed, trace)."""
    per_sector = 32 // T.element_size()
    T32 = dequantize_ref(T, scale, offset, dim_axis=1, packed=packed, dim=dim)
    P, D, V = T32.shape
    q32 = torch.as_tensor(q, dtype=torch.float32, device=T32.device)
    thr = torch.as_tensor(thr, dtype=torch.float32, device=T32.device)
    acc = torch.zeros((P, V), dtype=torch.float32, device=T32.device)
    alive = (torch.as_tensor(ids, device=T32.device) >= 0).to(torch.float32)
    streamed = torch.zeros((P,), dtype=torch.float32, device=T32.device)
    margin = torch.full((P, V), float("inf"), device=T32.device) if trace else None
    lanes, parts, sectors = [], [], []
    d_seen = 0
    while d_seen < D:
        hi = min(d_seen + d_tile, D)
        reached = torch.any(alive > 0, dim=1)
        streamed = streamed + reached.to(torch.float32)
        if trace:
            lanes.append(torch.sum(alive))
            parts.append(torch.sum(reached))
            sectors.append(_sectors(alive > 0, per_sector))
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
    walk = (ScanTrace(margin, torch.stack(lanes), torch.stack(parts), torch.stack(sectors))
            if trace else None)
    return acc, alive, streamed, walk


def _sectors(alive: torch.Tensor, per_sector: int) -> torch.Tensor:
    """Runs of ``per_sector`` lanes, from lane 0 of each row of the (P, V)
    bool ``alive`` (the last run may be short), holding a live lane."""
    P, V = alive.shape
    pad = torch.nn.functional.pad(alive.to(torch.float32), (0, -V % per_sector))
    return torch.sum(torch.any(pad.reshape(P, -1, per_sector) > 0, dim=2))


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
