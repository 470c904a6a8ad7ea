"""PDX (Partition Dimensions Across) layout — frozen part.

Counterpart of ``repro.core.layout`` (``PDXStore``, the store builders and
the quantized device mirrors; the mutable store and the tiered bucket
cache are not ported yet).  A PDX *partition* stores up to ``capacity``
vectors dimension-major as a ``(D, capacity)`` tile; a store stacks them
into ``(P, D, C)``.  Build-time code is NumPy, line for line the
reference's, and the finished arrays move to the store's device.

Device mirrors: the store keeps f32 masters and materializes a
reduced-precision copy per scan dtype on first use (the scan is bandwidth-
bound, so bytes per value are the lever):

  f32   4 B/value — the master tiles themselves.
  bf16  2 B/value — plain downcast (PAD_VALUE keeps its hugeness).
  int8  1 B/value — per-dimension affine ``q = clip(round((x - offset_d) /
        scale_d), -127, 127)`` with ``offset_d = dim_means[d]`` and
        ``scale_d`` sized to the *observed* max deviation of dimension d over
        live slots (a k·sigma range clips heavy tails hard enough to corrupt
        candidate selection).  ``torch.round`` rounds half to even, as
        ``jnp.round`` does.  PAD columns quantize to garbage; every consumer
        masks lanes with ``ids < 0``.
  int4  0.5 B/value — the same affine at 15 levels (clip to ±7), packed two
        per byte along D: byte ``d`` holds dimension ``2d`` in its low
        nibble and ``2d + 1`` in its high nibble, biased by +8;
        ``data.shape[1]`` is ceil(D/2), so consumers take D from
        ``mirror.dim``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..obs import metrics as _metrics
from .device import resolve_device

__all__ = [
    "PDXPartition",
    "PDXStore",
    "DeviceMirror",
    "SCAN_DTYPES",
    "PAD_VALUE",
    "device_mirror",
    "unpack_int4",
    "build_flat_store",
    "build_bucketed_store",
    "pdx_to_nary",
]

# Sentinel padding value: a coordinate far from any real data so padded slots
# can never enter a top-k result (distances are monotone increasing in L2/L1).
PAD_VALUE = np.float32(3.0e18)

SCAN_DTYPES = ("f32", "bf16", "int8", "int4")
_BYTES_PER_VALUE = {"f32": 4, "bf16": 2, "int8": 1, "int4": 0.5}

# Mirrors quantize this many f32 values per step, so the temporaries of a
# whole-store quantization stay a bounded slice of device memory.
_QUANT_CHUNK_VALUES = 1 << 28


@dataclasses.dataclass(frozen=True)
class DeviceMirror:
    """One device-resident copy of a store's tiles at a scan dtype.

    ``data`` is (P, D, C) in the mirror dtype — (P, ceil(D/2), C) uint8 for
    the packed "int4" mirror, whose logical D is ``dim``; ``scale``/
    ``offset`` are the (D,) f32 dequantization vectors (ones/zeros for f32
    and bf16)."""

    dtype: str
    data: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor
    tiles_version: int
    dim: int = 0

    @property
    def bytes_per_value(self) -> float:
        return _BYTES_PER_VALUE[self.dtype]

    @property
    def packed(self) -> bool:
        return self.dtype == "int4"

    @property
    def quantized(self) -> bool:
        return self.dtype in ("int8", "int4")


def _observed_scale(data, ids, means, levels: int) -> torch.Tensor:
    """Per-dim scale from the max |x - mean| over live slots."""
    live = (ids >= 0)[:, None, :]
    absmax = torch.zeros_like(means)
    step = _chunk_parts(data)
    for lo in range(0, data.shape[0], step):
        dev = torch.abs(data[lo:lo + step] - means[None, :, None])
        dev = torch.where(live[lo:lo + step], dev, 0.0)
        absmax = torch.maximum(absmax, torch.amax(dev, dim=(0, 2)))
    # divide by a full tensor: a scalar divisor becomes a product with its
    # reciprocal on CUDA, which rounds differently from the reference
    return torch.clamp(absmax, min=1e-6) / torch.full_like(absmax, levels)


def _chunk_parts(data) -> int:
    return max(1, _QUANT_CHUNK_VALUES // (data.shape[1] * data.shape[2]))


def _levels(data, scale, offset, lo, hi, clip: int) -> torch.Tensor:
    q = torch.round((data[lo:hi] - offset[None, :, None]) / scale[None, :, None])
    return torch.clamp(q, -clip, clip)


def _quantize_int8(data, ids, means):
    scale = _observed_scale(data, ids, means, 127.0)
    offset = means
    out = torch.empty(data.shape, dtype=torch.int8, device=data.device)
    step = _chunk_parts(data)
    for lo in range(0, data.shape[0], step):
        out[lo:lo + step] = _levels(data, scale, offset, lo, lo + step, 127).to(torch.int8)
    return out, scale, offset


def _quantize_int4(data, ids, means):
    """Same observed-range affine as int8 at 15 levels, packed 2-per-byte
    along D (low nibble = even dim, high nibble = odd dim, +8 bias).  Odd D
    pads one zero-level nibble (byte value 8 in the high half)."""
    scale = _observed_scale(data, ids, means, 7.0)
    offset = means
    P, D, C = data.shape
    out = torch.empty((P, (D + 1) // 2, C), dtype=torch.uint8, device=data.device)
    step = _chunk_parts(data)
    for lo in range(0, P, step):
        q = _levels(data, scale, offset, lo, lo + step, 7).to(torch.int32)
        if D % 2:
            q = torch.nn.functional.pad(q, (0, 0, 0, 1))
        qb = (q + 8).to(torch.uint8)
        out[lo:lo + step] = qb[:, 0::2, :] | (qb[:, 1::2, :] << 4)
    return out, scale, offset


def unpack_int4(packed: torch.Tensor, dim_axis: int = 0,
                dim: Optional[int] = None) -> torch.Tensor:
    """Packed int4 tile -> int8 quantization levels in [-7, 7], the packed
    axis doubled and sliced back to ``dim`` when given (odd logical D)."""
    p = packed.to(torch.int32)
    full = torch.stack([(p & 0xF) - 8, (p >> 4) - 8], dim=dim_axis + 1)
    shape = list(packed.shape)
    shape[dim_axis] *= 2
    full = full.reshape(shape)
    if dim is not None and dim != shape[dim_axis]:
        full = full.narrow(dim_axis, 0, dim)
    return full.to(torch.int8)


def device_mirror(store, dtype: str = "f32") -> DeviceMirror:
    """The store's device mirror at ``dtype``, cached per
    ``(dtype, tiles_version)`` on the store (frozen stores are version 0
    forever and keep hitting one entry per dtype)."""
    if dtype not in SCAN_DTYPES:
        raise ValueError(f"scan dtype must be one of {SCAN_DTYPES}, got {dtype!r}")
    version = getattr(store, "tiles_version", 0)
    cache = store._mirror_cache
    key = (dtype, version)
    mirror = cache.get(key)
    _metrics.counter(
        "repro_cache_events_total", cache="mirror",
        event="hit" if mirror is not None else "miss",
    )
    if mirror is None:
        _metrics.counter("repro_mirror_builds_total", dtype=dtype)
        data = store.data
        D = data.shape[1]
        ones = torch.ones((D,), dtype=torch.float32, device=data.device)
        zeros = torch.zeros((D,), dtype=torch.float32, device=data.device)
        if dtype == "f32":
            mdata, scale, offset = data, ones, zeros
        elif dtype == "bf16":
            mdata, scale, offset = data.to(torch.bfloat16), ones, zeros
        elif dtype == "int8":
            mdata, scale, offset = _quantize_int8(data, store.ids, store.dim_means)
        else:
            mdata, scale, offset = _quantize_int4(data, store.ids, store.dim_means)
        mirror = DeviceMirror(
            dtype=dtype, data=mdata, scale=scale, offset=offset,
            tiles_version=version, dim=D,
        )
        for stale in [kk for kk in cache if kk[1] != version]:
            del cache[stale]
        cache[key] = mirror
    return mirror


@dataclasses.dataclass
class PDXPartition:
    """One PDX partition: ``data[d, i]`` = dimension ``d`` of vector ``i``."""

    data: torch.Tensor     # (D, capacity) float
    ids: torch.Tensor      # (capacity,) int32 original row ids, -1 for padding
    count: int

    @property
    def dim(self) -> int:
        return self.data.shape[0]

    @property
    def capacity(self) -> int:
        return self.data.shape[1]


@dataclasses.dataclass
class PDXStore:
    """A collection of equal-capacity PDX partitions, batched into tensors
    on one device.

    ``data``   (P, D, C)  dimension-major f32 tiles
    ``ids``    (P, C)     original row ids (-1 padding), int32
    ``counts`` (P,)       valid vectors per partition, int32
    ``dim_means`` (D,)    collection-wide per-dimension means
    ``dim_vars``  (D,)    per-dimension variances
    """

    data: torch.Tensor
    ids: torch.Tensor
    counts: torch.Tensor
    dim_means: torch.Tensor
    dim_vars: torch.Tensor
    _mirror_cache: dict = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def num_partitions(self) -> int:
        return self.data.shape[0]

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    @property
    def capacity(self) -> int:
        return self.data.shape[2]

    @property
    def num_vectors(self) -> int:
        return int(self.counts.sum())

    def partition(self, p: int) -> PDXPartition:
        return PDXPartition(
            data=self.data[p], ids=self.ids[p], count=int(self.counts[p])
        )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pack_groups(
    X: np.ndarray,
    groups: Sequence[np.ndarray],
    capacity: int,
    row_ids: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pack row-id groups into (P, D, C) dimension-major tiles.

    Empty groups emit NO partition (an empty IVF bucket must cost zero scan
    work).  ``row_ids`` maps a row index to its stored id (default: the row
    index itself)."""
    n, d = X.shape
    sizes = [len(rows) for rows in groups]
    P = sum(_round_up(s, capacity) // capacity for s in sizes)
    if P == 0:  # fully empty collection: one all-pad placeholder
        return (
            np.full((1, d, capacity), PAD_VALUE, dtype=X.dtype),
            np.full((1, capacity), -1, dtype=np.int32),
            np.zeros((1,), dtype=np.int32),
        )
    data = np.full((P, d, capacity), PAD_VALUE, dtype=X.dtype)
    ids = np.full((P, capacity), -1, dtype=np.int32)
    counts = np.zeros((P,), dtype=np.int32)
    p = 0
    for rows in groups:
        rows = np.asarray(rows, dtype=np.int64)
        for lo in range(0, len(rows), capacity):
            chunk = rows[lo: lo + capacity]
            data[p, :, : len(chunk)] = X[chunk].T
            ids[p, : len(chunk)] = chunk if row_ids is None else row_ids[chunk]
            counts[p] = len(chunk)
            p += 1
    return data, ids, counts


def _store_from_packed(
    X: np.ndarray, data: np.ndarray, ids: np.ndarray, counts: np.ndarray,
    device,
) -> PDXStore:
    device = resolve_device(device)
    return PDXStore(
        data=torch.from_numpy(data).to(device),
        ids=torch.from_numpy(ids).to(device),
        counts=torch.from_numpy(counts).to(device),
        dim_means=torch.from_numpy(X.mean(axis=0)).to(device),
        dim_vars=torch.from_numpy(X.var(axis=0)).to(device),
    )


def build_flat_store(X: np.ndarray, capacity: int = 1024, *, device=None) -> PDXStore:
    """Exact-search store: horizontal slabs of ``capacity`` vectors, on
    ``device`` (None: the CUDA card, raising without one)."""
    X = np.asarray(X, dtype=np.float32)
    n = X.shape[0]
    groups = [np.arange(lo, min(lo + capacity, n)) for lo in range(0, n, capacity)]
    return _store_from_packed(X, *_pack_groups(X, groups, capacity), device)


def build_bucketed_store(
    X: np.ndarray, assignments: np.ndarray, num_buckets: int, capacity: int,
    *, device=None,
) -> tuple[PDXStore, np.ndarray, np.ndarray]:
    """IVF-style store: one group per bucket, split into capacity-sized tiles,
    on ``device`` (None: the CUDA card, raising without one).

    Returns (store, part_offsets, part_counts_per_bucket): partitions
    ``part_offsets[b] : part_offsets[b] + nparts[b]`` belong to bucket ``b``
    (bucket-contiguous, the paper's Figure 2)."""
    X = np.asarray(X, dtype=np.float32)
    assignments = np.asarray(assignments)
    order = np.argsort(assignments, kind="stable")
    bounds = np.searchsorted(assignments[order], np.arange(num_buckets + 1))
    groups = [order[bounds[b]:bounds[b + 1]] for b in range(num_buckets)]
    nparts = np.asarray(
        [_round_up(len(rows), capacity) // capacity for rows in groups],
        dtype=np.int64,
    )
    data, ids, counts = _pack_groups(X, groups, capacity)
    offsets = np.concatenate([[0], np.cumsum(nparts)[:-1]])
    return _store_from_packed(X, data, ids, counts, device), offsets, nparts


def pdx_to_nary(store) -> np.ndarray:
    """Inverse transposition (round-trip oracle for tests): row ``r`` of the
    output is the live vector with the ``r``-th smallest id."""
    data = store.data.cpu().numpy()
    ids = store.ids.cpu().numpy()
    live = ids >= 0
    flat_ids = ids[live]
    flat_vecs = np.swapaxes(data, 1, 2)[live]
    order = np.argsort(flat_ids, kind="stable")
    return np.ascontiguousarray(flat_vecs[order])
