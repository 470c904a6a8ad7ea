"""PDX (Partition Dimensions Across) layout.

Counterpart of ``repro.core.layout`` (``PDXStore``, ``MutablePDXStore``,
the store builders, the quantized device mirrors and the tiered
``BucketCache``).  A PDX *partition* stores up to ``capacity``
vectors dimension-major as a ``(D, capacity)`` tile; a store stacks them
into ``(P, D, C)``.  Build-time code is NumPy, line for line the
reference's, and the finished arrays move to the store's device.

* ``PDXStore`` — the frozen build artifact (a dataclass of tensors).
* ``MutablePDXStore`` — the versioned, mutable serving store: NumPy master
  tiles on the host, a horizontal write-head that absorbs inserts,
  tombstoning deletes that poison a slot to ``PAD_VALUE``, free-slot reuse
  and ``repack``; its tensors are uploaded to its device once per
  ``tiles_version``.
* ``BucketCache`` — a fixed pool of tile slots on the device holding the
  quantized extents of recently routed IVF buckets, fed from the host
  masters (tiered serving beyond device memory).

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

Projection mirrors (``projection_mirror``) hold the tiles projected onto
the collection's top PCA components, at any of those dtypes: the first
stage of a multi-resolution cascade.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import functools
import os
import threading
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..obs import metrics as _metrics
from ..obs import setups as _setups
from .device import resolve_device
from .pruners import pca_components

__all__ = [
    "PDXPartition",
    "PDXStore",
    "MutablePDXStore",
    "BucketCache",
    "DeviceMirror",
    "ProjectionMirror",
    "SCAN_DTYPES",
    "PAD_VALUE",
    "device_mirror",
    "projection_mirror",
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
    # the reference's jitted ``/ levels`` is strength-reduced by XLA to a
    # product with the f32 reciprocal, which rounds differently from a true
    # division in some dimensions; a product with a full tensor of that
    # reciprocal rounds the same on the CPU and on CUDA
    return torch.clamp(absmax, min=1e-6) * torch.full_like(
        absmax, float(np.float32(1.0 / levels)))


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
        _setups.note("device_mirror")
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


@dataclasses.dataclass(frozen=True)
class ProjectionMirror(DeviceMirror):
    """A skinny learned-projection copy of the tiles (LeanVec-style).

    ``data`` is (P, rank, C) in the mirror dtype — packed (P, ceil(rank/2),
    C) uint8 for int4 — holding the tiles projected onto the top-``rank``
    PCA components of the collection.  The components are orthonormal, so
    the projected squared L2 distance lower-bounds the full one for every
    query, and a plain ``proj_dist <= thr`` keep test is exact-safe under
    any pruner.  Same consumer contract as ``DeviceMirror``; ``dim`` is the
    logical projected dimensionality (= rank), ``scale``/``offset`` are
    (rank,)."""

    components: Optional[torch.Tensor] = None  # (D, rank) f32: q_proj = q @ C

    @property
    def rank(self) -> int:
        return self.dim


# PCA of the projection mirror is fitted on the first rows in id order.
_PCA_SAMPLE_ROWS = 65536


def _nary_head(store, n: int) -> np.ndarray:
    """The first ``n`` rows of ``pdx_to_nary(store)``, gathered without
    materializing the rest (the same values, so a PCA fitted on them equals
    one fitted on the reference's sample): on the store's device for a
    frozen store, from the host masters and the write-head for a mutable
    one."""
    if isinstance(store, MutablePDXStore):
        ids = store._ids.reshape(-1)
        live = np.flatnonzero(ids >= 0)
        hids, hvecs = store.head_live()
        sel = np.argsort(np.concatenate([ids[live], hids]), kind="stable")[:n]
        sealed = sel < len(live)
        pos = live[sel[sealed]]
        out = np.empty((len(sel), store.dim), np.float32)
        out[sealed] = store._data[pos // store.capacity, :, pos % store.capacity]
        out[~sealed] = hvecs[sel[~sealed] - len(live)]
        return out
    ids = store.ids.cpu().numpy().reshape(-1)
    live = np.flatnonzero(ids >= 0)
    pos = live[np.argsort(ids[live], kind="stable")[:n]]
    C = store.capacity
    p = torch.from_numpy(pos // C).to(store.device)
    c = torch.from_numpy(pos % C).to(store.device)
    return np.ascontiguousarray(store.data[p, :, c].cpu().numpy())


def projection_mirror(store, rank: int, dtype: str = "f32") -> ProjectionMirror:
    """The store's rank-``rank`` PCA projection mirror, cached per
    ``(rank, dtype, tiles_version)`` on the store; the PCA components are
    shared across rank and dtype variants of one version (fitting dominates
    the build).  Quantized dtypes use the ``device_mirror`` affine recipe
    centred on the projected collection means."""
    if dtype not in SCAN_DTYPES:
        raise ValueError(f"scan dtype must be one of {SCAN_DTYPES}, got {dtype!r}")
    D = store.dim
    if not 1 <= rank <= D:
        raise ValueError(f"projection rank must be in [1, {D}], got {rank}")
    version = getattr(store, "tiles_version", 0)
    cache = store._proj_cache
    key = (rank, dtype, version)
    mirror = cache.get(key)
    _metrics.counter(
        "repro_cache_events_total", cache="proj_mirror",
        event="hit" if mirror is not None else "miss",
    )
    if mirror is None:
        _metrics.counter("repro_mirror_builds_total", dtype=f"proj:{dtype}")
        _setups.note("projection_mirror")
        comps = cache.get(("comps", version))
        if comps is None:
            _setups.note("pca_fit")
            sample = _nary_head(store, _PCA_SAMPLE_ROWS)
            if len(sample) < 2:  # degenerate: identity "projection"
                comps = np.eye(D, dtype=np.float32)
            else:
                comps, _ = pca_components(sample)
            cache[("comps", version)] = comps
        Cj = torch.from_numpy(np.ascontiguousarray(comps[:, :rank])).to(store.device)
        proj = torch.einsum("dr,pdc->prc", Cj, store.data)
        means = Cj.T @ store.dim_means
        ones = torch.ones((rank,), dtype=torch.float32, device=store.device)
        zeros = torch.zeros((rank,), dtype=torch.float32, device=store.device)
        if dtype == "f32":
            mdata, scale, offset = proj, ones, zeros
        elif dtype == "bf16":
            mdata, scale, offset = proj.to(torch.bfloat16), ones, zeros
        elif dtype == "int8":
            mdata, scale, offset = _quantize_int8(proj, store.ids, means)
        else:
            mdata, scale, offset = _quantize_int4(proj, store.ids, means)
        mirror = ProjectionMirror(
            dtype=dtype, data=mdata, scale=scale, offset=offset,
            components=Cj, tiles_version=version, dim=rank,
        )
        for stale in [kk for kk in cache if kk[-1] != version]:
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
    _proj_cache: dict = dataclasses.field(
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
    output is the live vector with the ``r``-th smallest id.  Live slots may
    sit anywhere in a tile and ids may be sparse (a mutable store's
    tombstones and deleted ids); a ``MutablePDXStore``'s unflushed
    write-head rows are included, and its host masters are read directly
    (no upload)."""
    if isinstance(store, MutablePDXStore):
        data, ids = store._data, store._ids
    else:
        data, ids = store.data.cpu().numpy(), store.ids.cpu().numpy()
    live = ids >= 0
    all_ids = [ids[live]]
    all_vecs = [np.swapaxes(data, 1, 2)[live]]
    if hasattr(store, "head_live"):
        hids, hvecs = store.head_live()
        all_ids.append(hids)
        all_vecs.append(hvecs)
    flat_ids = np.concatenate(all_ids)
    flat_vecs = np.concatenate(all_vecs) if flat_ids.size else np.zeros(
        (0, store.dim), dtype=data.dtype
    )
    order = np.argsort(flat_ids, kind="stable")
    return np.ascontiguousarray(flat_vecs[order])


# ==========================================================================
# Tiered bucket cache — the working set beyond device memory.
#
# ``device_mirror`` materializes the WHOLE store at the scan dtype, which
# caps collection size at device memory.  ``BucketCache`` keeps the f32
# masters authoritative in host RAM and manages a fixed pool of tile-sized
# device slots as a bucket-granular cache: routing tells it which IVF
# buckets a batch will scan (``ensure``), cold buckets are LRU-evicted, and
# the requested buckets' tile extents are quantized host-side and uploaded.
# Quantization parameters are computed ONCE per store generation over all
# live masters with the reference's NumPy arithmetic (``_host_quant_params``),
# so a cached bucket's tiles never depend on what else is resident:
# eviction/readmission can never change a candidate set.  ``generation``
# tags every entry with the store's ``tiles_version``; any sealed-tile
# mutation invalidates the whole pool exactly like the mirror cache.
#
# The reference updates its pool functionally (``pool.at[slots].set``), so a
# scan in flight keeps the tiles it captured.  Here the pool is updated in
# place, and stream order gives the same guarantee: on a CUDA store the
# staged tiles land in buffers of their own (host-quantized into reused
# pinned buffers, copied on the cache's side stream, an event recorded),
# and ``wait`` makes the compute stream wait on that event before it writes
# the slots with ``index_copy_`` on the compute stream itself — after every
# scan enqueued before it.  The side stream never writes the pool.
# ==========================================================================
_POOL_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
                "int8": torch.int8, "int4": torch.uint8}


def _quantize_extent_int8(x, scale, offset):
    """(m, D, C) f32 tile extent -> int8 levels at the GIVEN per-dim affine
    (the cache's per-generation params): the sub/div/round/clip sequence
    of ``BucketCache._host_quantize``, so the two are equal bit for bit."""
    q = torch.round((x - offset[None, :, None]) / scale[None, :, None])
    return torch.clamp(q, -127, 127).to(torch.int8)


def _quantize_extent_int4(x, scale, offset):
    q = torch.clamp(
        torch.round((x - offset[None, :, None]) / scale[None, :, None]), -7, 7
    ).to(torch.int32)
    if q.shape[1] % 2:
        q = torch.nn.functional.pad(q, (0, 0, 0, 1))
    qb = (q + 8).to(torch.uint8)
    return qb[:, 0::2, :] | (qb[:, 1::2, :] << 4)


def _locked(fn):
    """Serialize a ``BucketCache`` entry point on the instance RLock."""
    @functools.wraps(fn)
    def inner(self, *args, **kwargs):
        with self._lock:
            return fn(self, *args, **kwargs)
    return inner


# Single shared staging worker for async uploads: ``issue`` hands it the
# f32 extent, it quantizes and starts the device transfer off the query
# thread (NumPy ufuncs release the GIL, so staging overlaps the scan the
# query thread is driving).  One worker keeps upload ordering FIFO and
# matches the depth-1 ticket discipline.
_stager: Optional[concurrent.futures.ThreadPoolExecutor] = None
_stager_lock = threading.Lock()


def _stage_pool() -> concurrent.futures.ThreadPoolExecutor:
    global _stager
    if _stager is None:
        with _stager_lock:
            if _stager is None:
                _stager = concurrent.futures.ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="bucket-cache-stager"
                )
    return _stager


class _UploadTicket:
    """In-flight async upload batch from ``BucketCache.issue``: the
    admission stats, the staged extents (a Future from the staging worker
    per missed extent, or an already staged ``_Staged``), the issue
    timestamp, and the request (for a stale-generation redo).
    ``BucketCache.wait`` installs it into the pool.  At most one ticket is
    pending: ``issue`` drains any outstanding ticket first."""

    __slots__ = (
        "stats", "pending", "buckets", "parts", "t_issue", "generation",
        "done",
    )

    def __init__(self, stats, pending, buckets, parts, t_issue, generation):
        self.stats = stats
        self.pending = pending    # [Future | _Staged]
        self.buckets = buckets
        self.parts = parts
        self.t_issue = t_issue
        self.generation = generation
        self.done = False


class _Staged:
    """One extent on its way into the pool: the tile, its ids and its slot
    numbers as device tensors, the event that marks their copies landed on
    the side stream (None off CUDA), and the pinned buffers to give back
    once it has."""

    __slots__ = ("tile", "ids", "slots", "event", "bufs")

    def __init__(self, tile, ids, slots, event=None, bufs=()):
        self.tile, self.ids, self.slots = tile, ids, slots
        self.event, self.bufs = event, bufs


class _PinnedStaging:
    """Reused page-locked host buffers for a cache's uploads, one free list
    per (dtype, power-of-two size): a buffer is taken for one extent and
    given back once the copy that read it has landed, so pinned memory is
    allocated per size class, not per extent."""

    def __init__(self):
        self._free: dict = collections.defaultdict(list)
        self._lock = threading.Lock()

    def put(self, src: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(pinned view holding a copy of ``src``, its buffer)."""
        n = src.numel()
        key = (src.dtype, 1 << max(n - 1, 0).bit_length())
        with self._lock:
            free = self._free[key]
            buf = free.pop() if free else None
        if buf is None:
            buf = torch.empty(key[1], dtype=src.dtype, pin_memory=True)
        view = buf[:n].view(src.shape)
        view.copy_(src)
        return view, buf

    def give(self, bufs) -> None:
        with self._lock:
            for buf in bufs:
                self._free[(buf.dtype, buf.numel())].append(buf)


def _host_masters(store) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host (data, ids, means) of the store's sealed tiles: a
    ``MutablePDXStore``'s NumPy masters, or, for a frozen store, one host
    copy per ``tiles_version``, kept on the store and shared by every
    ``BucketCache`` and the tiered re-rank (a CUDA store would otherwise
    copy itself to the host at every upload)."""
    data = getattr(store, "_data", None)
    if data is not None:
        return data, store._ids, store._dim_means
    ver = getattr(store, "tiles_version", 0)
    cached = getattr(store, "_host_masters_cache", None)
    if cached is None or cached[0] != ver:
        _setups.note("host_masters")
        cached = (ver, store.data.cpu().numpy(), store.ids.cpu().numpy(),
                  store.dim_means.cpu().numpy().astype(np.float32))
        store._host_masters_cache = cached
    return cached[1], cached[2], cached[3]


def _host_quant_params(
    data: np.ndarray, ids: np.ndarray, means: np.ndarray, dtype: str
) -> tuple[np.ndarray, np.ndarray]:
    """Per-dimension (scale, offset) over the live host masters, float32
    arithmetic, the reference's line for line: offset = dim means, scale =
    live-masked absmax times the f32 reciprocal of 127 (int8) or 7
    (int4)."""
    D = data.shape[1]
    if dtype in ("f32", "bf16"):
        return np.ones((D,), np.float32), np.zeros((D,), np.float32)
    means = np.asarray(means, np.float32)
    live = (ids >= 0)[:, None, :]
    # in slices of partitions (a maximum is exact in any grouping), so the
    # temporaries stay a bounded slice of the host masters
    absmax = np.zeros((D,), np.float32)
    step = max(1, _QUANT_CHUNK_VALUES // (4 * D * data.shape[2]))
    for lo in range(0, data.shape[0], step):
        dev = np.subtract(data[lo:lo + step], means[None, :, None], dtype=np.float32)
        np.abs(dev, out=dev)
        absmax = np.maximum(absmax, np.max(
            dev, axis=(0, 2), where=live[lo:lo + step], initial=np.float32(0.0)))
    # the reference multiplies by the f32 reciprocal (XLA strength-reduces
    # its quantizers' ``/ denom``); so does this, to hold its scales
    rdenom = np.float32(1.0 / (127.0 if dtype == "int8" else 7.0))
    scale = np.maximum(absmax, np.float32(1e-6)) * rdenom
    return scale.astype(np.float32), means


def _store_quant_params(store, dtype: str) -> tuple[np.ndarray, np.ndarray]:
    """``_host_quant_params`` of the store's host masters at ``dtype``, kept
    on the store per ``tiles_version``: every cache of one store and dtype
    shares one pass over the masters."""
    ver = getattr(store, "tiles_version", 0)
    cache = store.__dict__.setdefault("_quant_params_cache", {})
    hit = cache.get(dtype)
    if hit is None or hit[0] != ver:
        _setups.note("quant_params")
        data, ids, means = _host_masters(store)
        hit = cache[dtype] = (ver, *_host_quant_params(data, ids, means, dtype))
    return hit[1], hit[2]


class BucketCache:
    """Fixed slot-pool device cache of bucket tile extents (see the block
    comment above).

    ``capacity_slots`` tiles are allocated once per generation on the
    store's device; each resident IVF bucket owns a run of slots inside the
    pool (any slot order — the scan masks by ``slot_bucket``, it never
    assumes pool adjacency).  ``n_regions`` > 1 splits the pool into equal
    contiguous regions with independent free lists and LRU chains.

    Staging, by the store's device: on CUDA the staging worker
    host-quantizes (only the quantized bytes cross the bus); on the CPU it
    does so where a second core exists (``os.cpu_count() > 1``), and
    otherwise issue quantizes on the device (``stage_on_host = False``).
    ``sync_uploads = True`` restores the blocking path: the f32 extent
    crosses, quantizes on the device, and ``issue`` waits for it.  All
    three give the same pool bit for bit."""

    def __init__(
        self,
        store,
        *,
        capacity_slots: int,
        dtype: str = "int8",
        n_regions: int = 1,
        bucket_region: Optional[np.ndarray] = None,
        part_offsets: Optional[np.ndarray] = None,
        part_counts: Optional[np.ndarray] = None,
    ):
        if dtype not in SCAN_DTYPES:
            raise ValueError(
                f"scan dtype must be one of {SCAN_DTYPES}, got {dtype!r}"
            )
        if capacity_slots < 1:
            raise ValueError(f"capacity_slots must be >= 1, got {capacity_slots}")
        if n_regions < 1:
            raise ValueError(f"n_regions must be >= 1, got {n_regions}")
        self.store = store
        self.dtype = dtype
        self.device = store.device
        self.n_regions = int(n_regions)
        self.region_slots = max(capacity_slots // self.n_regions, 1)
        self.capacity_slots = self.region_slots * self.n_regions
        if bucket_region is None:
            self._bucket_region = None  # every bucket -> region 0
        else:
            self._bucket_region = np.asarray(bucket_region, np.int64)
        # frozen stores carry no bucket structure of their own; the builder
        # (IVF) passes the extent table explicitly.
        self._static_extent = None
        if part_offsets is not None:
            self._static_extent = (
                np.asarray(part_offsets, np.int64),
                np.asarray(part_counts, np.int64),
            )
        self.generation = -1
        # True restores the blocking upload path (f32 over the bus,
        # quantized on the device, ``issue`` waits for it)
        self.sync_uploads = False
        self.stage_on_host = (
            self.device.type == "cuda" or (os.cpu_count() or 1) > 1
        )
        self._side = (torch.cuda.Stream(device=self.device)
                      if self.device.type == "cuda" else None)
        self._pinned = _PinnedStaging()
        # populated by _revalidate (needs store geometry):
        self._pool = None            # (S, D', C) device, pool dtype
        self._ids_dev = None         # (S, C) int32 device
        self._slot_bucket = None     # (S,) int64 host, -1 = free/invalid
        self._slot_bucket_dev = None
        self._slot_ids = None        # (S, C) int32 host mirror of _ids_dev
        self._scale = None           # (D,) f32 device
        self._offset = None
        self._scale_np = None
        self._offset_np = None
        self._resident: list = []    # per region: OrderedDict key -> slots
        self._free: list = []        # per region: list of free slot indices
        self._inflight: Optional[_UploadTicket] = None  # depth-1 pipeline
        # every public entry point takes this; reentrant because ensure
        # nests issue+wait and a stale-generation wait re-enters ensure
        self._lock = threading.RLock()

    # ------------------------------------------------------------ geometry
    @property
    def dim(self) -> int:
        return self.store.dim

    @property
    def packed(self) -> bool:
        return self.dtype == "int4"

    @property
    def quantized(self) -> bool:
        return self.dtype in ("int8", "int4")

    @property
    def bytes_per_value(self) -> float:
        return _BYTES_PER_VALUE[self.dtype]

    @property
    def resident_slots(self) -> int:
        return self.capacity_slots - sum(len(f) for f in self._free)

    def resident_buckets(self) -> list[int]:
        return [k if isinstance(k, int) else k[0]
                for reg in self._resident for k in reg]

    def _region_of(self, b: int) -> int:
        if self._bucket_region is None:
            return 0
        return int(self._bucket_region[b])

    def _masters(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Host-side (data, ids, means) — host RAM is the authoritative
        tier (``_host_masters``)."""
        return _host_masters(self.store)

    def _bucket_extent(self) -> tuple[np.ndarray, np.ndarray]:
        """Current (part_offsets, part_counts) — re-read per call for
        mutable stores: repack moves bucket -> partition ownership."""
        if getattr(self.store, "num_buckets", None) is not None:
            return (
                np.asarray(self.store.part_offsets, np.int64),
                np.asarray(self.store.part_counts, np.int64),
            )
        if self._static_extent is None:
            raise ValueError(
                "store has no bucket structure; pass part_offsets/"
                "part_counts to BucketCache"
            )
        return self._static_extent

    # -------------------------------------------------------- invalidation
    def _revalidate(self) -> None:
        gen = getattr(self.store, "tiles_version", 0)
        if gen == self.generation:
            return
        if self.generation >= 0 and _metrics.enabled():
            _metrics.counter(
                "repro_tiered_cache_events_total", event="invalidate"
            )
        _setups.note("bucket_pool")
        data, ids, means = self._masters()
        P, D, C = data.shape
        Dp = (D + 1) // 2 if self.packed else D
        S = self.capacity_slots
        dev = self.device
        self._pool = None  # the old generation goes before the new one comes
        self._pool = torch.zeros((S, Dp, C), dtype=_POOL_DTYPES[self.dtype],
                                 device=dev)
        self._ids_dev = torch.full((S, C), -1, dtype=torch.int32, device=dev)
        self._slot_ids = np.full((S, C), -1, np.int32)
        self._slot_bucket = np.full((S,), -1, np.int64)
        self._slot_bucket_dev = torch.tensor(self._slot_bucket, device=dev)
        sc, off = _store_quant_params(self.store, self.dtype)
        self._scale_np, self._offset_np = sc, off
        self._scale = torch.tensor(sc, device=dev)
        self._offset = torch.tensor(off, device=dev)
        if self._side is not None:
            # the side stream's device quantize reads scale/offset
            torch.cuda.current_stream(dev).synchronize()
        self._resident = [
            collections.OrderedDict() for _ in range(self.n_regions)
        ]
        self._free = [
            list(range(r * self.region_slots, (r + 1) * self.region_slots))
            for r in range(self.n_regions)
        ]
        self.generation = gen

    # ------------------------------------------------------------- staging
    def _host_quantize(self, x: np.ndarray, scale=None, offset=None) -> torch.Tensor:
        """(m, D, C) f32 host extent -> pool-dtype CPU tensor.  NumPy
        arithmetic, the reference's line for line (sub/div/rint/clip are
        exactly rounded IEEE ops, equal to ``_device_quantize``'s bit for
        bit), so only 1-2 bytes per dimension cross the bus.
        ``scale``/``offset`` pin the quant params when the staging worker
        runs after the issue that captured them."""
        sc = self._scale_np if scale is None else scale
        off = self._offset_np if offset is None else offset
        if self.dtype == "int8":
            q = np.subtract(x, off[None, :, None], dtype=np.float32)
            np.divide(q, sc[None, :, None], out=q)
            np.rint(q, out=q)
            np.clip(q, -127, 127, out=q)
            return torch.from_numpy(q.astype(np.int8))
        if self.dtype == "int4":
            q = np.subtract(x, off[None, :, None], dtype=np.float32)
            np.divide(q, sc[None, :, None], out=q)
            np.rint(q, out=q)
            np.clip(q, -7, 7, out=q)
            q = q.astype(np.int32)
            if q.shape[1] % 2:
                q = np.pad(q, ((0, 0), (0, 1), (0, 0)))
            qb = (q + 8).astype(np.uint8)
            return torch.from_numpy(qb[:, 0::2, :] | (qb[:, 1::2, :] << 4))
        x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
        # f32 -> bf16 rounds to nearest even, as the reference's cast does
        return x.to(torch.bfloat16) if self.dtype == "bf16" else x

    def _device_quantize(self, ext: torch.Tensor) -> torch.Tensor:
        """Pool-dtype tile from an f32 extent on the device — the torch
        twins of ``_host_quantize`` (equal bit for bit)."""
        if self.dtype == "int8":
            return _quantize_extent_int8(ext, self._scale, self._offset)
        if self.dtype == "int4":
            return _quantize_extent_int4(ext, self._scale, self._offset)
        if self.dtype == "bf16":
            return ext.to(torch.bfloat16)
        return ext

    def _stage(self, slots: np.ndarray, ext: np.ndarray, ext_ids: np.ndarray,
               scale, offset, host_quant: bool) -> _Staged:
        """One extent's tile (host- or device-quantized), ids and slot
        numbers as tensors on the store's device.  On CUDA the copies run
        on the cache's side stream from reused pinned buffers and an event
        marks them landed; this may run on the staging worker, which sets
        the device and the side stream itself."""
        payload = (self._host_quantize(ext, scale, offset) if host_quant
                   else torch.from_numpy(ext))
        ids_t = torch.from_numpy(ext_ids)
        slots_t = torch.from_numpy(slots)
        if self._side is None:
            tile = payload if host_quant else self._device_quantize(payload)
            return _Staged(tile, ids_t, slots_t)
        with torch.cuda.device(self.device), torch.cuda.stream(self._side):
            moved, bufs = [], []
            for src in (payload, ids_t, slots_t):
                view, buf = self._pinned.put(src)
                moved.append(view.to(self.device, non_blocking=True))
                bufs.append(buf)
            tile, ids_d, slots_d = moved
            if not host_quant:
                tile = self._device_quantize(tile)
            event = torch.cuda.Event()
            event.record(self._side)
        return _Staged(tile, ids_d, slots_d, event, bufs)

    @staticmethod
    def _sub_extent(off, cnt, part):
        """Row window of sub-extent ``part = (part_i, n_parts)`` of a
        bucket extent — ceil-divided so every part fits a region."""
        if part is None:
            return off, cnt
        pi, n_parts = part
        per = -(-cnt // n_parts)
        return off + pi * per, max(min(per, cnt - pi * per), 0)

    # ------------------------------------------------------------- serving
    @_locked
    def resident_ok(self, buckets, parts: Optional[dict] = None) -> bool:
        """True when every (sub-)extent of the request is still resident —
        the run loop's guard against a concurrent batch's ``issue`` having
        evicted tiles between this pass's prefetch and its scan."""
        if getattr(self.store, "tiles_version", 0) != self.generation:
            return False
        _, cnts = self._bucket_extent()
        for b in np.asarray(buckets, np.int64).reshape(-1):
            b = int(b)
            if b < 0 or b >= len(cnts) or int(cnts[b]) == 0:
                continue
            part = (parts or {}).get(b)
            key = b if part is None else (b,) + tuple(part)
            if key not in self._resident[self._region_of(b)]:
                return False
        return True

    @_locked
    def issue(self, buckets, parts: Optional[dict] = None) -> _UploadTicket:
        """Asynchronous half of ``ensure``: run the LRU admission
        bookkeeping and hand every missing extent to the staging worker,
        which quantizes it and starts its copy to the device — returning a
        ticket whose ``wait`` installs the copies into the pool.  Staging
        and copies overlap whatever the query thread and device are
        executing (the previous step's scan in the tiered loop).  Depth-1:
        issuing while another ticket is in flight waits that one first.

        ``parts`` maps bucket -> ``(part_index, n_parts)`` to admit one
        region-sized sub-extent of a bucket too large for its region; the
        tiered executor scans each sub-extent in its own pass and merges
        top-k, so a single query whose routed demand exceeds the slot pool
        succeeds instead of raising."""
        if self._inflight is not None:
            self.wait(self._inflight)
        self._revalidate()
        offs, cnts = self._bucket_extent()
        data, ids, _ = self._masters()
        hits = misses = evicted = uploaded = 0
        pending: list = []
        seen = set()
        for b in np.asarray(buckets, np.int64).reshape(-1):
            b = int(b)
            part = (parts or {}).get(b)
            key = b if part is None else (b,) + tuple(part)
            if b < 0 or key in seen:
                continue
            seen.add(key)
            cnt = int(cnts[b]) if b < len(cnts) else 0
            off, cnt = self._sub_extent(int(offs[b]) if cnt else 0, cnt, part)
            if cnt == 0:
                continue
            r = self._region_of(b)
            res = self._resident[r]
            if key in res:
                hits += 1
                res.move_to_end(key)
                continue
            misses += 1
            if cnt > self.region_slots:
                raise ValueError(
                    f"bucket {b} spans {cnt} tiles > region capacity "
                    f"{self.region_slots}; split it via parts= or raise "
                    "hbm_slots"
                )
            while len(self._free[r]) < cnt:
                # Evict the coldest entry NOT requested by this batch —
                # everything in ``seen`` is pinned for the upcoming scan.
                victim = next((o for o in res if o not in seen), None)
                if victim is None:
                    raise ValueError(
                        f"batch demands more tiles than region {r} holds "
                        f"({self.region_slots} slots); raise hbm_slots or "
                        "split the batch"
                    )
                old_slots = res.pop(victim)
                self._free[r].extend(old_slots.tolist())
                self._slot_bucket[old_slots] = -1
                evicted += 1
            slots = np.asarray(
                [self._free[r].pop() for _ in range(cnt)], np.int64
            )
            ext_ids = np.ascontiguousarray(ids[off : off + cnt], np.int32)
            ext = np.ascontiguousarray(data[off : off + cnt], np.float32)
            if self.sync_uploads:
                # the blocking path: the full-width f32 extent crosses the
                # bus, quantizes on the device, and the host stalls until
                # it lands — the same tiles, 2-8x the bytes, no overlap
                staged = self._stage(slots, ext, ext_ids, None, None, False)
                if staged.event is not None:
                    staged.event.synchronize()
                pending.append(staged)
            elif self.stage_on_host:
                # quantize + copy on the staging worker: the NumPy pass runs
                # off the query thread, and only quantized bytes cross
                pending.append(_stage_pool().submit(
                    self._stage, slots, ext, ext_ids, self._scale_np,
                    self._offset_np, True,
                ))
            else:
                # one core: the device quantizes, dispatched asynchronously
                pending.append(self._stage(slots, ext, ext_ids, None, None, False))
            res[key] = slots
            self._slot_ids[slots] = ext_ids
            self._slot_bucket[slots] = b
            uploaded += cnt
            if _metrics.enabled():
                # bytes that cross: the quantized staging bytes on the
                # host-staged path, the f32 extent otherwise
                staged_host = not self.sync_uploads and self.stage_on_host
                _metrics.counter(
                    "repro_tiered_prefetch_bytes_total",
                    float(cnt * self.dim * data.shape[2])
                    * (self.bytes_per_value if staged_host else 4.0),
                    dtype=self.dtype,
                )
        ticket = _UploadTicket(
            stats={"hits": hits, "misses": misses,
                   "evicted": evicted, "uploaded_slots": uploaded},
            pending=pending, buckets=np.asarray(buckets, np.int64),
            parts=parts, t_issue=time.perf_counter(),
            generation=self.generation,
        )
        self._inflight = ticket
        return ticket

    @_locked
    def wait(self, ticket: Optional[_UploadTicket]) -> dict:
        """Blocking half of ``ensure``: install the ticket's staged extents
        into the pool (on CUDA the compute stream waits on each extent's
        event, then ``index_copy_`` writes its slots in stream order after
        every scan already enqueued), block until the copies land, and
        meter how long the host actually waited against the whole
        issue->complete window (``repro_cache_upload_wait_us`` /
        ``..._overlap_ratio``)."""
        if ticket is None:
            return {"hits": 0, "misses": 0, "evicted": 0,
                    "uploaded_slots": 0}
        if ticket.done:
            return ticket.stats
        ticket.done = True
        if self._inflight is ticket:
            self._inflight = None
        if getattr(self.store, "tiles_version", 0) != ticket.generation:
            # the store mutated mid-flight: the pool is (about to be)
            # rebuilt; drop the stale copies and re-admit synchronously
            for st in ticket.pending:
                st = st.result() if isinstance(st, concurrent.futures.Future) else st
                if st.event is not None:
                    st.event.synchronize()
                self._pinned.give(st.bufs)
            return self.ensure(ticket.buckets, parts=ticket.parts)
        t0 = time.perf_counter()
        if ticket.pending:
            resolved = []
            cur = (torch.cuda.current_stream(self.device)
                   if self._side is not None else None)
            for st in ticket.pending:
                if isinstance(st, concurrent.futures.Future):
                    st = st.result()
                if st.event is not None:
                    cur.wait_event(st.event)
                    for t in (st.tile, st.ids, st.slots):
                        t.record_stream(cur)
                self._pool.index_copy_(0, st.slots, st.tile)
                self._ids_dev.index_copy_(0, st.slots, st.ids)
                resolved.append(st)
            for st in resolved:
                if st.event is not None:
                    st.event.synchronize()
                    self._pinned.give(st.bufs)
            done = time.perf_counter()
            from ..obs.meters import cache_upload_wait

            cache_upload_wait(
                (done - t0) * 1e6, (done - ticket.t_issue) * 1e6
            )
        stats = ticket.stats
        if stats["evicted"] or stats["uploaded_slots"]:
            self._slot_bucket_dev = torch.tensor(self._slot_bucket,
                                                 device=self.device)
        if _metrics.enabled():
            for key, event in (("hits", "hit"), ("misses", "miss"),
                               ("evicted", "evict")):
                if stats[key]:
                    _metrics.counter(
                        "repro_tiered_cache_events_total",
                        float(stats[key]), event=event,
                    )
            _metrics.gauge(
                "repro_tiered_cache_resident_slots",
                float(self.resident_slots),
            )
        return stats

    @_locked
    def ensure(self, buckets, parts: Optional[dict] = None) -> dict:
        """Admit every requested bucket (the routed set of the NEXT batch),
        evicting cold LRU entries per region as needed.  Returns
        ``{"hits", "misses", "evicted", "uploaded_slots"}``: the
        synchronous composition of ``issue`` + ``wait``.

        Raises ValueError only when one bucket alone exceeds a region AND
        no ``parts`` sub-extent split was requested (the tiered executor
        always splits, so oversized routed demand succeeds there)."""
        return self.wait(self.issue(buckets, parts=parts))

    @_locked
    def arrays(self):
        """The device-side cache state for a scan: ``(pool, slot_ids,
        slot_bucket, scale, offset)``.  An in-flight upload ticket is
        installed first, so it reflects everything admitted so far.  The
        pool and ids are updated in place by later ``wait`` calls, in
        stream order after any scan enqueued before them; ``slot_bucket``
        is replaced, never written."""
        if self._inflight is not None:
            self.wait(self._inflight)
        self._revalidate()
        return (
            self._pool, self._ids_dev, self._slot_bucket_dev,
            self._scale, self._offset,
        )

    @_locked
    def snapshot(self) -> tuple:
        """Atomic ``(arrays(), slot_ids copy)`` pair — the run loop's scan
        inputs and its id-resolution table must come from the same instant
        or a concurrent ``issue`` could remap ids between the two reads."""
        return self.arrays(), np.array(self.slot_ids_host(), copy=True)

    @_locked
    def slot_ids_host(self) -> np.ndarray:
        """(S, C) host copy of the pool's vector ids (candidate positions
        from a pool scan resolve to global ids through this)."""
        if self._inflight is not None:
            self.wait(self._inflight)
        self._revalidate()
        return self._slot_ids


# ==========================================================================
# Mutable PDX — the versioned serving store.
# ==========================================================================
class MutablePDXStore:
    """Versioned, mutable PDX store: sealed tiles + write-head + tombstones.

    Presents the same read interface as ``PDXStore`` (``data``/``ids``/
    ``counts`` tensors on ``device``, ``dim``/``capacity``/
    ``num_partitions``), so every executor consumes it unchanged; mutation
    happens on NumPy master copies on the host, and the device tensors are
    uploaded once per ``tiles_version`` (``_sync_device``), at the first
    read after a sealed mutation.

    Mutation model
      * ``insert(V)`` appends rows to a small horizontal *write-head*
        ``(head_capacity, D)`` buffer.  Write-head rows are scanned exactly
        (unpruned) by every executor — ``core.plan.execute`` merges them
        into each top-k — until a flush drains them into sealed tiles.
      * ``delete(ids)`` tombstones: the slot's id becomes -1 (which is also
        the free-slot bitmap bit) and its column is poisoned to
        ``PAD_VALUE`` so no metric can ever rank it into a top-k.
      * ``flush()`` drains live write-head rows into free sealed slots
        (bucket-local for bucketed stores, preserving the bucket-contiguous
        layout); when free slots run out it falls back to ``repack()``.
      * ``repack()`` rebuilds lane-aligned tiles from scratch out of the
        surviving rows (bucket-contiguous for IVF).  Partition count shrinks
        back to the minimum, tombstone holes disappear, and pruner metadata
        (``dim_means``/``dim_vars``) is refreshed from running moments.

    ``version`` increases on every mutating call; plan traces record it.
    ``tiles_version`` increases only when the *sealed* tiles change (sealed
    delete, flush, repack): the device upload and the device and
    projection mirrors key on it, so a head-only insert never re-uploads
    the store.  An upload drops the mirrors of older versions, so the card
    never holds two generations of them.

    Pruner metadata is maintained incrementally: running per-dimension
    sum / sum-of-squares are updated O(D) per inserted/deleted row, and the
    public ``dim_means``/``dim_vars`` snapshot is refreshed on repack or
    whenever the fraction of mutations since the last refresh exceeds
    ``meta_staleness`` — never on every insert.
    """

    def __init__(
        self,
        data: np.ndarray,
        ids: np.ndarray,
        counts: np.ndarray,
        dim_means: np.ndarray,
        dim_vars: np.ndarray,
        *,
        head_capacity: int = 256,
        num_buckets: Optional[int] = None,
        part_bucket: Optional[np.ndarray] = None,
        meta_staleness: float = 0.25,
        device=None,
    ):
        self.device = resolve_device(device)
        # the mutable masters: writable copies
        self._data = np.array(data, dtype=np.float32, copy=True, order="C")
        self._ids = np.array(ids, dtype=np.int32, copy=True, order="C")
        self._counts = np.asarray(counts, np.int32).copy()
        # the per-partition free-slot bitmap IS `self._ids < 0`: a slot is
        # reusable iff its id is the -1 sentinel (see _plan_free_slot_fill)
        self._dim_means = np.asarray(dim_means, np.float32).copy()
        self._dim_vars = np.asarray(dim_vars, np.float32).copy()
        self.meta_staleness = float(meta_staleness)
        # version: every mutation (plan traces record it).  tiles_version:
        # only mutations that touch the SEALED tiles (sealed delete, flush,
        # repack) — head-only inserts leave it alone.
        self.version = 0
        self.tiles_version = 0

        P, D, C = self._data.shape
        if head_capacity < 1:
            raise ValueError(
                f"head_capacity must be >= 1, got {head_capacity}"
            )
        self.head_capacity = int(head_capacity)
        self._head_data = np.full(
            (self.head_capacity, D), PAD_VALUE, dtype=np.float32
        )
        self._head_ids = np.full((self.head_capacity,), -1, dtype=np.int32)
        self._head_assign = np.full((self.head_capacity,), -1, dtype=np.int32)
        self._head_n = 0  # append pointer (holes stay until flush)

        # bucket structure (IVF): which bucket owns each sealed partition
        self.num_buckets = num_buckets
        if num_buckets is not None:
            if part_bucket is None:
                raise ValueError("bucketed store needs part_bucket")
            self._part_bucket = np.asarray(part_bucket, np.int64).copy()
        else:
            self._part_bucket = np.full((P,), -1, dtype=np.int64)

        # id -> location map ('s', p, c) sealed | ('h', j) write-head
        self._id_loc = self._build_id_loc()
        self._next_id = 1 + max(self._id_loc, default=-1)

        # running per-dimension moments over live rows (float64 for drift)
        live = self._ids >= 0
        live_vecs = np.swapaxes(self._data, 1, 2)[live].astype(np.float64)
        self._sum = live_vecs.sum(axis=0)
        self._sumsq = (live_vecs**2).sum(axis=0)
        self._n_live = int(live.sum())
        self._mutations_since_meta = 0

        self._dev: Optional[tuple] = None
        self._dev_version = -1
        self._mirror_cache: dict = {}
        self._proj_cache: dict = {}
        # mutation oplog (delta-replay for background maintenance): None =
        # not recording; a list accumulates ("insert"|"delete", ...) entries
        # between oplog_start() and oplog_take().
        self._oplog: Optional[list] = None
        self._oplog_limit = 8192

    # -------------------------------------------------- mutation oplog
    def oplog_start(self, limit: int = 8192) -> None:
        """Begin recording mutations (insert/delete) applied to THIS store.

        A maintenance pass calls this right after cloning: mutations that
        land while the clone repacks are replayed onto the clone before
        ``adopt``.  Bounded by ``limit`` rows — past that, replay costs
        about as much as a fresh clone, so the log overflows and
        ``oplog_take`` reports it."""
        self._oplog = []
        self._oplog_limit = int(limit)
        self._oplog_rows = 0

    def oplog_take(self) -> Optional[list]:
        """Stop recording and return the recorded ops in application order,
        or None if the log overflowed ``limit`` rows (caller should discard
        its clone).  Entries are ``("insert", V, assignments, ids)`` /
        ``("delete", ids)`` with defensively copied arrays."""
        ops, self._oplog = self._oplog, None
        if ops is not None and self._oplog_rows > self._oplog_limit:
            return None
        return ops

    def _oplog_record(self, entry: tuple, rows: int) -> None:
        if self._oplog is None:
            return
        self._oplog_rows += rows
        if self._oplog_rows <= self._oplog_limit:
            self._oplog.append(entry)

    def replay(self, ops: list) -> int:
        """Apply an ``oplog_take`` list to this store (the maintenance
        clone); returns rows replayed.  Replayed inserts must reproduce the
        recorded ids — guaranteed because ``clone()`` copies ``_next_id``
        and id assignment is sequential — and a mismatch raises, because a
        store with diverged ids must never be adopted."""
        rows = 0
        for op in ops:
            if op[0] == "insert":
                _, V, assignments, ids = op
                got = self.insert(V, assignments)
                if not np.array_equal(got, ids):
                    raise ValueError(
                        "oplog replay id divergence: "
                        f"expected {ids[:4]}..., got {got[:4]}..."
                    )
                rows += len(ids)
            else:
                rows += self.delete(op[1])
        return rows

    def _build_id_loc(self) -> dict[int, tuple]:
        """Vectorized sealed-slot scan (a Python loop over P*C slots would
        dominate repack latency at 100k+ vectors)."""
        ps, cs = np.nonzero(self._ids >= 0)
        return {
            i: ("s", p, c)
            for i, p, c in zip(
                self._ids[ps, cs].tolist(), ps.tolist(), cs.tolist()
            )
        }

    # ----------------------------------------------------------- constructors
    @classmethod
    def from_store(
        cls,
        store: PDXStore,
        *,
        head_capacity: int = 256,
        num_buckets: Optional[int] = None,
        part_counts: Optional[np.ndarray] = None,
        meta_staleness: float = 0.25,
    ) -> "MutablePDXStore":
        """Unseal a frozen ``PDXStore`` on the frozen store's device.  For a
        bucketed (IVF) store pass its per-bucket ``part_counts`` so repack
        keeps bucket contiguity (the layout is bucket-contiguous, so counts
        fully determine ownership).  The masters are copied to the host and
        the frozen store's mirrors are dropped, so the card does not hold
        two generations of them."""
        part_bucket = None
        if num_buckets is not None:
            nparts = np.asarray(part_counts, np.int64)
            part_bucket = np.repeat(np.arange(num_buckets), nparts)
            if len(part_bucket) < store.num_partitions:  # pad placeholders
                part_bucket = np.concatenate([
                    part_bucket,
                    np.full(
                        store.num_partitions - len(part_bucket), -1, np.int64
                    ),
                ])
        out = cls(
            store.data.cpu().numpy(), store.ids.cpu().numpy(),
            store.counts.cpu().numpy(), store.dim_means.cpu().numpy(),
            store.dim_vars.cpu().numpy(),
            head_capacity=head_capacity, num_buckets=num_buckets,
            part_bucket=part_bucket, meta_staleness=meta_staleness,
            device=store.device,
        )
        store._mirror_cache.clear()
        store._proj_cache.clear()
        return out

    def _bump(self, tiles: bool = False):
        self.version += 1
        if tiles:
            self.tiles_version += 1

    # ------------------------------------------------------ PDXStore interface
    def _sync_device(self):
        if self._dev_version != self.tiles_version:
            _metrics.counter("repro_store_device_uploads_total")
            _setups.note("device_upload")
            version = self.tiles_version
            # drop the older generation before uploading the new one
            self._dev = None
            for cache in (self._mirror_cache, self._proj_cache):
                for stale in [kk for kk in cache if kk[-1] != version]:
                    del cache[stale]
            self._dev = (
                torch.tensor(self._data, device=self.device),
                torch.tensor(self._ids, device=self.device),
                torch.tensor(self._counts, device=self.device),
            )
            self._dev_version = version

    def _obs_mutation(self, op: str, rows: int) -> None:
        """Record one mutation event plus the store-health gauges (live
        rows, write-head fill, metadata staleness).  One enabled() check
        when observability is off."""
        if not _metrics.enabled():
            return
        _metrics.counter("repro_store_mutations_total", op=op)
        _metrics.counter("repro_store_rows_mutated_total", float(rows), op=op)
        _metrics.gauge("repro_store_live_vectors", float(self._n_live))
        _metrics.gauge(
            "repro_store_head_fill",
            self.head_count / max(self.head_capacity, 1),
        )
        _metrics.gauge(
            "repro_store_meta_staleness",
            self._mutations_since_meta / max(self._n_live, 1),
        )

    @property
    def data(self) -> torch.Tensor:
        self._sync_device()
        return self._dev[0]

    @property
    def ids(self) -> torch.Tensor:
        self._sync_device()
        return self._dev[1]

    @property
    def counts(self) -> torch.Tensor:
        self._sync_device()
        return self._dev[2]

    @property
    def dim_means(self) -> torch.Tensor:
        return torch.from_numpy(self._dim_means).to(self.device)

    @property
    def dim_vars(self) -> torch.Tensor:
        return torch.from_numpy(self._dim_vars).to(self.device)

    @property
    def num_partitions(self) -> int:
        return self._data.shape[0]

    @property
    def dim(self) -> int:
        return self._data.shape[1]

    @property
    def capacity(self) -> int:
        return self._data.shape[2]

    @property
    def num_vectors(self) -> int:
        """Live vectors: sealed non-tombstoned slots + unflushed head rows."""
        return int(self._counts.sum()) + int((self._head_ids >= 0).sum())

    def partition(self, p: int) -> PDXPartition:
        return PDXPartition(
            data=self.data[p], ids=self.ids[p], count=int(self._counts[p])
        )

    # -------------------------------------------------------- bucket structure
    @property
    def part_offsets(self) -> np.ndarray:
        """(K,) first partition id of each bucket (bucket-contiguous layout)."""
        nparts = self.part_counts
        return np.concatenate([[0], np.cumsum(nparts)[:-1]]).astype(np.int64)

    @property
    def part_counts(self) -> np.ndarray:
        """(K,) partitions per bucket; 0 for empty buckets."""
        if self.num_buckets is None:
            raise ValueError("flat store has no bucket structure")
        return np.bincount(
            self._part_bucket[self._part_bucket >= 0],
            minlength=self.num_buckets,
        ).astype(np.int64)

    # -------------------------------------------------------------- write-head
    @property
    def head_count(self) -> int:
        return int((self._head_ids >= 0).sum())

    def head_live(self) -> tuple[np.ndarray, np.ndarray]:
        """Live write-head rows -> ((m,) ids, (m, D) vectors).  These must be
        merged *exactly* (no pruning) into every executor's top-k."""
        mask = self._head_ids >= 0
        return self._head_ids[mask].copy(), self._head_data[mask].copy()

    def head_snapshot(self) -> tuple[np.ndarray, np.ndarray]:
        """The FULL write-head buffer -> ((head_capacity,) ids,
        (head_capacity, D) vectors), dead slots included (id -1, data
        ``PAD_VALUE``).  Unlike ``head_live`` the shapes never change with
        the fill level."""
        return self._head_ids.copy(), self._head_data.copy()

    # --------------------------------------------------------------- mutation
    def insert(
        self, V: np.ndarray, assignments: Optional[np.ndarray] = None
    ) -> np.ndarray:
        """Absorb rows into the write-head; returns their new global ids.

        ``assignments`` — per-row IVF bucket (centroid assignment done at
        insert time by the index); required for bucketed stores.  A full
        write-head flushes itself (free-slot fill, falling back to repack).
        """
        V = np.atleast_2d(np.ascontiguousarray(np.asarray(V, np.float32)))
        if V.shape[1] != self.dim:
            raise ValueError(f"expected (N, {self.dim}) rows, got {V.shape}")
        if self.num_buckets is not None:
            if assignments is None:
                raise ValueError("bucketed store insert needs assignments")
            assignments = np.asarray(assignments, np.int32)
            if assignments.shape != (len(V),):
                raise ValueError("one bucket assignment per inserted row")
        new_ids = np.arange(
            self._next_id, self._next_id + len(V), dtype=np.int32
        )
        self._next_id += len(V)
        pos = 0  # chunked copies: bulk-load cost is slice assignments, not rows
        while pos < len(V):
            if self._head_n == self.head_capacity:
                self.flush()
            j0, take = self._head_n, min(
                self.head_capacity - self._head_n, len(V) - pos
            )
            self._head_data[j0 : j0 + take] = V[pos : pos + take]
            self._head_ids[j0 : j0 + take] = new_ids[pos : pos + take]
            if assignments is not None:
                self._head_assign[j0 : j0 + take] = assignments[pos : pos + take]
            self._id_loc.update(
                (i, ("h", j0 + off))
                for off, i in enumerate(new_ids[pos : pos + take].tolist())
            )
            self._head_n += take
            pos += take
        self._sum += V.astype(np.float64).sum(axis=0)
        self._sumsq += (V.astype(np.float64) ** 2).sum(axis=0)
        self._n_live += len(V)
        self._mutations_since_meta += len(V)
        self._maybe_refresh_meta()
        self._oplog_record(
            (
                "insert", V.copy(),
                None if assignments is None else assignments.copy(),
                new_ids.copy(),
            ),
            len(V),
        )
        self._bump()  # head-only: sealed tiles untouched (unless flush ran)
        self._obs_mutation("insert", len(V))
        return new_ids

    def delete(self, ids) -> int:
        """Tombstone rows by id; returns how many were live.  Sealed slots
        are poisoned to ``PAD_VALUE`` and their free-bitmap bit set.

        Batched: the id array is resolved to (partition, column) coordinates
        up front, then every slot is poisoned in one fancy-indexed pass and
        the running moments are updated with one reduction."""
        sealed_p, sealed_c, head_j = [], [], []
        for i in np.atleast_1d(np.asarray(ids, np.int64)):
            loc = self._id_loc.pop(int(i), None)  # also dedups repeated ids
            if loc is None:
                continue
            if loc[0] == "s":
                sealed_p.append(loc[1])
                sealed_c.append(loc[2])
            else:
                head_j.append(loc[1])
        removed = len(sealed_p) + len(head_j)
        if not removed:
            return 0
        if sealed_p:
            ps = np.asarray(sealed_p, np.int64)
            cs = np.asarray(sealed_c, np.int64)
            vecs = self._data[ps, :, cs].astype(np.float64)  # (m, D)
            self._sum -= vecs.sum(axis=0)
            self._sumsq -= (vecs**2).sum(axis=0)
            self._data[ps, :, cs] = PAD_VALUE
            self._ids[ps, cs] = -1
            np.subtract.at(self._counts, ps, 1)
        if head_j:
            js = np.asarray(head_j, np.int64)
            vecs = self._head_data[js].astype(np.float64)
            self._sum -= vecs.sum(axis=0)
            self._sumsq -= (vecs**2).sum(axis=0)
            self._head_data[js] = PAD_VALUE
            self._head_ids[js] = -1
        self._n_live -= removed
        self._mutations_since_meta += removed
        self._maybe_refresh_meta()
        self._oplog_record(
            ("delete", np.atleast_1d(np.asarray(ids, np.int64)).copy()),
            removed,
        )
        self._bump(tiles=bool(sealed_p))
        self._obs_mutation("delete", removed)
        return removed

    def flush(self) -> None:
        """Drain live write-head rows into free sealed slots (reusing the
        free-slot bitmap; bucket-local for bucketed stores).  Falls back to a
        full ``repack()`` when free slots run out."""
        rows = np.nonzero(self._head_ids >= 0)[0]
        if len(rows) == 0:
            self._reset_head()  # only tombstoned head rows, if any: a no-op
            return
        placements = self._plan_free_slot_fill(rows)
        if placements is None:
            self.repack()
            return
        for j, (p, c) in zip(rows, placements):
            i = int(self._head_ids[j])
            self._data[p, :, c] = self._head_data[j]
            self._ids[p, c] = i
            self._counts[p] += 1
            self._id_loc[i] = ("s", p, int(c))
        self._reset_head()
        self._bump(tiles=True)
        self._obs_mutation("flush", len(rows))

    def _plan_free_slot_fill(self, rows) -> Optional[list]:
        """(p, c) free slot per head row, or None if any row has no slot.
        Free slots are enumerated once per bucket, not once per row."""
        free = self._ids < 0  # the free-slot bitmap
        if self.num_buckets is None:
            free_p, free_c = np.nonzero(free)
            if len(free_p) < len(rows):
                return None
            return list(zip(free_p[: len(rows)], free_c[: len(rows)]))
        placements: dict[int, tuple] = {}
        for b in np.unique(self._head_assign[rows]):
            mine = rows[self._head_assign[rows] == b]
            free_p, free_c = np.nonzero(free & (self._part_bucket == b)[:, None])
            if len(free_p) < len(mine):
                return None
            for j, p, c in zip(mine, free_p, free_c):
                placements[int(j)] = (p, c)
        return [placements[int(j)] for j in rows]

    def _reset_head(self):
        self._head_data[:] = PAD_VALUE
        self._head_ids[:] = -1
        self._head_assign[:] = -1
        self._head_n = 0

    def repack(self) -> None:
        """Drain tombstones and the write-head back into minimal lane-aligned
        tiles (bucket-contiguous for IVF), then refresh pruner metadata."""
        C = self.capacity
        live = self._ids >= 0
        hmask = self._head_ids >= 0
        all_ids = np.concatenate([self._ids[live], self._head_ids[hmask]])
        all_vecs = np.concatenate(
            [np.swapaxes(self._data, 1, 2)[live], self._head_data[hmask]]
        )
        all_bucket = np.concatenate([
            np.repeat(self._part_bucket, C).reshape(self._ids.shape)[live],
            self._head_assign[hmask].astype(np.int64),
        ])
        order = np.argsort(all_ids, kind="stable")  # deterministic layout
        all_ids, all_vecs, all_bucket = (
            all_ids[order], all_vecs[order], all_bucket[order],
        )

        if self.num_buckets is None:
            buckets = [-1]
            groups = [np.arange(len(all_ids))]
        else:
            buckets = list(range(self.num_buckets))
            groups = [np.nonzero(all_bucket == b)[0] for b in buckets]
        self._data, self._ids, self._counts = _pack_groups(
            all_vecs, groups, C, row_ids=all_ids
        )
        nparts = [-(-len(g) // C) for g in groups]
        if sum(nparts) == 0:  # nothing survived: the all-pad placeholder tile
            self._part_bucket = np.asarray([-1], dtype=np.int64)
        else:
            self._part_bucket = np.repeat(buckets, nparts).astype(np.int64)
        self._id_loc = self._build_id_loc()
        self._reset_head()
        self._refresh_meta()
        self._bump(tiles=True)
        self._obs_mutation("repack", len(all_ids))

    def replace_live_vectors(self, X: np.ndarray) -> None:
        """Overwrite every live sealed vector, row ``r`` of ``X`` replacing
        the vector with the ``r``-th smallest id (the ``pdx_to_nary``
        order).  Ids, bucket assignments, and tile geometry are untouched —
        the store-level primitive for re-projecting a collection in place
        (BSA's recalibration on compact).  Requires a drained write-head."""
        if self.head_count:
            raise ValueError(
                "replace_live_vectors needs a drained write-head; "
                "flush() or repack() first"
            )
        X = np.asarray(X, np.float32)
        ps, cs = np.nonzero(self._ids >= 0)
        if len(ps) != len(X):
            raise ValueError(
                f"{len(X)} replacement rows for {len(ps)} live vectors"
            )
        order = np.argsort(self._ids[ps, cs], kind="stable")
        self._data[ps[order], :, cs[order]] = X
        self._sum = X.astype(np.float64).sum(axis=0)
        self._sumsq = (X.astype(np.float64) ** 2).sum(axis=0)
        self._refresh_meta()
        self._bump(tiles=True)

    # ------------------------------------------------- incremental metadata
    def _maybe_refresh_meta(self):
        if self._mutations_since_meta > self.meta_staleness * max(
            self._n_live, 1
        ):
            self._refresh_meta()

    def _refresh_meta(self):
        """Snapshot dim_means/dim_vars (BOND / BSA block metadata) from the
        running moments — O(D), independent of collection size."""
        n = max(self._n_live, 1)
        mean = self._sum / n
        self._dim_means = mean.astype(np.float32)
        self._dim_vars = np.maximum(self._sumsq / n - mean**2, 0.0).astype(
            np.float32
        )
        self._mutations_since_meta = 0

    # ------------------------------------------- background maintenance
    @property
    def fragmentation(self) -> float:
        """Fraction of sealed slots that are pad/tombstone holes — a
        maintenance pass's repack trigger."""
        P, _, C = self._data.shape
        return 1.0 - float(self._counts.sum()) / float(P * C)

    def clone(self) -> "MutablePDXStore":
        """Deep, independent copy of all host-side state (device tensors and
        mirrors excluded — the clone uploads lazily on first read).  A
        maintenance pass clones, repacks the clone off the serving path, and
        swaps it back in with ``adopt``."""
        other = MutablePDXStore.__new__(MutablePDXStore)
        other.device = self.device
        other._data = self._data.copy()
        other._ids = self._ids.copy()
        other._counts = self._counts.copy()
        other._dim_means = self._dim_means.copy()
        other._dim_vars = self._dim_vars.copy()
        other.meta_staleness = self.meta_staleness
        other.version = self.version
        other.tiles_version = self.tiles_version
        other.head_capacity = self.head_capacity
        other._head_data = self._head_data.copy()
        other._head_ids = self._head_ids.copy()
        other._head_assign = self._head_assign.copy()
        other._head_n = self._head_n
        other.num_buckets = self.num_buckets
        other._part_bucket = self._part_bucket.copy()
        other._id_loc = dict(self._id_loc)
        other._next_id = self._next_id
        other._sum = self._sum.copy()
        other._sumsq = self._sumsq.copy()
        other._n_live = self._n_live
        other._mutations_since_meta = self._mutations_since_meta
        other._dev = None
        other._dev_version = -1
        other._mirror_cache = {}
        other._proj_cache = {}
        other._oplog = None  # clones never inherit an active recording
        other._oplog_limit = self._oplog_limit
        return other

    def adopt(self, other: "MutablePDXStore", *, expect_version: int) -> bool:
        """Version-fenced swap: take ``other``'s state iff this store is
        still at ``expect_version`` (no mutation landed since ``other`` was
        cloned from it).  Returns False — and changes nothing — when the
        fence fails.  On success the device tensors are dropped (the
        adopted tiles upload lazily) and both versions bump past every
        prior value, so every version-keyed cache invalidates."""
        if self.version != expect_version:
            return False
        for attr in (
            "_data", "_ids", "_counts", "_dim_means", "_dim_vars",
            "_head_data", "_head_ids", "_head_assign", "_head_n",
            "_part_bucket", "_id_loc", "_next_id",
            "_sum", "_sumsq", "_n_live", "_mutations_since_meta",
        ):
            setattr(self, attr, getattr(other, attr))
        self._dev = None
        self._dev_version = -1
        self._bump(tiles=True)
        self._obs_mutation("adopt", self._n_live)
        return True
