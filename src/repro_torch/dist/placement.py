"""Placement — how PDX tiles map onto the ranks of a mesh axis.

Counterpart of ``repro.dist.placement``.  A ``Placement`` owns the
arranged-and-padded tile tensors plus the metadata the executors need:

* ``replicated`` — every rank holds every tile (the dimension-sharded
  executor shards the *D* axis inside the tile instead).
* ``block``      — partitions stripe contiguously over the mesh axis,
  padded with empty tiles (all ``PAD_VALUE``, ids -1) to divisibility.
  When no padding is needed the store's own tensors are used, uncopied.
* ``bucket``     — bucket-owned sharding for IVF stores: a greedy
  size-balanced assignment gives each IVF bucket one owner rank, and each
  rank's slice lists its buckets ascending with their partitions
  contiguous (the layout of the bucket-routed search,
  ``repro_torch.dist.routing``).

The tensors stay where the store keeps them; ``local(rank)`` is a rank's
(P'/n, D, C) slice, which an executor moves to its mesh device.  All
builders end with ``check()``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.layout import PAD_VALUE

__all__ = ["Placement", "assign_buckets"]


def assign_buckets(bucket_parts: np.ndarray, n_shards: int) -> np.ndarray:
    """Greedy size-balanced bucket -> shard assignment: buckets largest
    first (by partition count) onto the least-loaded shard, ties on the
    lower bucket / shard id, so every rank derives the same map and
    ``max_load - min_load`` never exceeds the largest bucket (LPT)."""
    bucket_parts = np.asarray(bucket_parts, np.int64)
    order = np.argsort(-bucket_parts, kind="stable")  # largest first, id ties
    shard_of = np.empty(len(bucket_parts), np.int64)
    load = np.zeros(n_shards, np.int64)
    for b in order:
        s = int(np.argmin(load))  # argmin takes the lowest index on ties
        shard_of[b] = s
        load[s] += bucket_parts[b]
    return shard_of


def _gather_slots(t: torch.Tensor, perm: np.ndarray, fill) -> torch.Tensor:
    """``t`` permuted along dim 0 by ``perm``, slots of -1 filled with
    ``fill``."""
    safe = torch.from_numpy(np.maximum(perm, 0)).to(t.device)
    out = t[safe]
    pad = torch.from_numpy(perm < 0).to(t.device)
    return torch.where(pad.reshape((-1,) + (1,) * (t.dim() - 1)),
                       torch.full((), fill, dtype=t.dtype, device=t.device), out)


@dataclasses.dataclass(frozen=True)
class Placement:
    """One arranged mapping of a store's tiles onto ``n_shards`` ranks.

    ``data``/``ids`` are the tiles as the executors consume them: for
    ``block``/``bucket`` rank ``s`` owns the contiguous slots ``[s *
    parts_per_shard, (s + 1) * parts_per_shard)``; for ``replicated`` they
    are the source tensors.  ``part_perm[i]`` is the source partition in
    slot ``i`` (-1 for a pad tile); ``slot_bucket``/``bucket_shard``/
    ``bucket_parts`` carry the bucket structure of a ``bucket`` placement.
    """

    kind: str                    # "replicated" | "block" | "bucket"
    axis: str                    # mesh axis the tiles map onto
    n_shards: int
    data: torch.Tensor           # (P', D, C)
    ids: torch.Tensor            # (P', C)
    part_perm: np.ndarray        # (P',) source partition per slot, -1 = pad
    bucket_shard: Optional[np.ndarray] = None   # (K,) owner shard per bucket
    slot_bucket: Optional[np.ndarray] = None    # (P',) bucket per slot, -1 pad
    bucket_parts: Optional[np.ndarray] = None   # (K,) partitions per bucket
    # arranged mirror tiles per mirror dtype (the placement is itself cached
    # per tiles_version, so an entry never outlives its tiles)
    _mirrors: dict = dataclasses.field(
        default_factory=dict, compare=False, repr=False
    )

    @property
    def num_slots(self) -> int:
        return int(self.data.shape[0])

    @property
    def parts_per_shard(self) -> int:
        return self.num_slots // self.n_shards if self.kind != "replicated" \
            else self.num_slots

    # ------------------------------------------------------------- builders
    @classmethod
    def replicated(cls, data, ids, n_shards: int, axis: str = "model") -> "Placement":
        """Tiles present on every rank."""
        pl = cls(kind="replicated", axis=axis, n_shards=n_shards, data=data,
                 ids=ids, part_perm=np.arange(data.shape[0], dtype=np.int64))
        pl.check()
        return pl

    @classmethod
    def block(cls, data, ids, n_shards: int, axis: str = "data") -> "Placement":
        """Contiguous partition striping, padded to divisibility with empty
        tiles; a divisible store keeps its own tensors (no copy)."""
        n_parts = data.shape[0]
        rem = (-n_parts) % n_shards
        perm = np.concatenate(
            [np.arange(n_parts, dtype=np.int64), np.full(rem, -1, np.int64)]
        )
        if rem:
            data = torch.cat([data, torch.full((rem,) + tuple(data.shape[1:]),
                                               PAD_VALUE, dtype=data.dtype,
                                               device=data.device)])
            ids = torch.cat([ids, torch.full((rem,) + tuple(ids.shape[1:]), -1,
                                             dtype=ids.dtype, device=ids.device)])
        pl = cls(kind="block", axis=axis, n_shards=n_shards, data=data,
                 ids=ids, part_perm=perm)
        pl.check()
        return pl

    @classmethod
    def bucket(cls, data, ids, part_bucket: np.ndarray, num_buckets: int,
               n_shards: int, axis: str = "data") -> "Placement":
        """Bucket-owned sharding: ``part_bucket[p]`` is the IVF bucket of
        source partition ``p`` (-1 marks all-pad placeholder tiles, which
        are dropped).  Each bucket lands wholly on one rank, each rank's
        slice lists its buckets ascending with their partitions
        contiguous, and every rank is padded to the widest rank's count."""
        part_bucket = np.asarray(part_bucket, np.int64)
        if len(part_bucket) != data.shape[0]:
            raise ValueError(
                f"part_bucket covers {len(part_bucket)} partitions, store has "
                f"{data.shape[0]}"
            )
        bucket_parts = np.bincount(
            part_bucket[part_bucket >= 0], minlength=num_buckets
        ).astype(np.int64)
        bucket_shard = assign_buckets(bucket_parts, n_shards)

        shard_slots: list[list[int]] = [[] for _ in range(n_shards)]
        for b in range(num_buckets):  # ascending bucket id within each shard
            (parts,) = np.nonzero(part_bucket == b)
            shard_slots[int(bucket_shard[b])].extend(parts.tolist())
        width = max(1, max(len(sl) for sl in shard_slots))
        perm = np.full(n_shards * width, -1, np.int64)
        for s, sl in enumerate(shard_slots):
            perm[s * width: s * width + len(sl)] = sl

        pl = cls(
            kind="bucket", axis=axis, n_shards=n_shards,
            data=_gather_slots(data, perm, PAD_VALUE),
            ids=_gather_slots(ids, perm, -1), part_perm=perm,
            bucket_shard=bucket_shard,
            slot_bucket=np.where(perm < 0, -1, part_bucket[np.maximum(perm, 0)]),
            bucket_parts=bucket_parts,
        )
        pl.check()
        return pl

    # ---------------------------------------------------------- rank slices
    def slots(self, rank: int) -> slice:
        """The slots rank ``rank`` owns (all of them when replicated)."""
        if self.kind == "replicated":
            return slice(0, self.num_slots)
        w = self.parts_per_shard
        return slice(rank * w, (rank + 1) * w)

    def local(self, rank: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Rank ``rank``'s (P'/n, D, C) tiles and (P'/n, C) ids (views)."""
        sl = self.slots(rank)
        return self.data[sl], self.ids[sl]

    # --------------------------------------------------------- mirror tiles
    def arrange(self, tiles: torch.Tensor, pad_value=0) -> torch.Tensor:
        """This placement's slot permutation and padding applied to any
        (P, D, C) tile stack, e.g. a reduced-precision device mirror; pad
        slots hold ``pad_value`` (their ids are -1, which every quantized
        consumer masks on)."""
        if self.kind == "replicated":
            return tiles
        perm = self.part_perm
        if len(perm) == tiles.shape[0] and (perm == np.arange(len(perm))).all():
            return tiles  # already-divisible block placement: untouched
        return _gather_slots(tiles, perm, pad_value)

    def arranged_mirror(self, mirror) -> torch.Tensor:
        """``arrange(mirror.data)``, cached per mirror dtype and version."""
        got = self._mirrors.get(mirror.dtype)
        if got is None or got[0] != mirror.tiles_version:
            got = (mirror.tiles_version, self.arrange(mirror.data))
            self._mirrors[mirror.dtype] = got
        return got[1]

    # ------------------------------------------------------------ invariants
    def check(self) -> None:
        """Structural invariants; raises ValueError on the first violation."""
        if self.kind not in ("replicated", "block", "bucket"):
            raise ValueError(f"unknown placement kind {self.kind!r}")
        if self.data.shape[0] != self.ids.shape[0] or \
                self.data.shape[0] != len(self.part_perm):
            raise ValueError("data/ids/part_perm slot counts disagree")
        real = self.part_perm[self.part_perm >= 0]
        if len(np.unique(real)) != len(real):
            raise ValueError("a source partition is placed more than once")
        if self.kind == "replicated":
            return
        if self.num_slots % self.n_shards:
            raise ValueError(
                f"{self.num_slots} slots not divisible over "
                f"{self.n_shards} shards"
            )
        if self.kind == "bucket":
            if self.bucket_shard is None or self.slot_bucket is None:
                raise ValueError("bucket placement missing bucket metadata")
            width = self.parts_per_shard
            owner_of_slot = np.arange(self.num_slots) // width
            live = self.slot_bucket >= 0
            if not (self.bucket_shard[self.slot_bucket[live]]
                    == owner_of_slot[live]).all():
                raise ValueError("a bucket's partitions span shard slices")
            load = np.bincount(
                self.bucket_shard, weights=self.bucket_parts,
                minlength=self.n_shards,
            )
            bound = max(int(self.bucket_parts.max(initial=0)), 1)
            if load.max() - load.min() > bound:
                raise ValueError(
                    f"greedy balance violated: loads {load} vs max bucket "
                    f"{bound}"
                )
