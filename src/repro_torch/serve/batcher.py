"""Continuous-batching primitives for the online vector-serving tier.

The pieces ``repro_torch.serve.vector.VectorServer`` is assembled from, kept
engine-free so they are testable without building a store:

``AdmissionQueue``
    A bounded, condition-variable FIFO of ``QueryItem``s.  ``put`` never
    blocks — a full queue REJECTS (the server maps that to
    ``ServerOverloaded``), which is the backpressure contract: latency is
    bounded by queue depth, never by an unbounded buffer.  ``drain``
    blocks for the first item, then coalesces up to ``max_batch`` items
    that share the first item's frozen ``SearchSpec`` (specs are hashable
    and equality-comparable, so "same compiled configuration" is one
    ``==``), waiting up to a flush window for stragglers.  Items whose
    deadline has already passed are filtered out and returned separately,
    so an expired query never occupies a batch slot.

``shape_bucket`` / ``pad_batch``
    The pow2 compiled-shape discipline: a coalesced batch of ``n`` queries
    is padded up to the next power of two (the same demand-octave trick
    ``dist.routing.plan_routing`` applies to send budgets), so a drifting
    arrival rate cycles through at most ``log2(max_batch) + 1`` distinct
    executor shapes instead of minting one per batch size.  Padding
    repeats the last real query — padded lanes cost the same arithmetic as
    real ones and are sliced off before futures complete, so no sentinel
    value can perturb the scan.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

__all__ = [
    "ServeError",
    "ServerOverloaded",
    "ServerClosed",
    "DeadlineExceeded",
    "QueryItem",
    "AdmissionQueue",
    "shape_bucket",
    "pad_batch",
]


class ServeError(RuntimeError):
    """Base class of the serving tier's control-flow errors."""


class ServerOverloaded(ServeError):
    """The admission queue is full: the request is rejected at submit time
    (bounded queue = bounded latency; shedding happens before this)."""


class ServerClosed(ServeError):
    """The server is shut down (or shutting down without drain)."""


class DeadlineExceeded(ServeError):
    """The query's deadline passed before its result was produced."""


@dataclasses.dataclass
class QueryItem:
    """One enqueued query: payload + future + timing envelope.

    ``deadline`` is an absolute ``time.perf_counter`` instant (``None`` =
    no deadline); ``t_enqueue`` anchors the queue-wait span and latency
    metrics."""

    query: np.ndarray              # (D,) float32
    spec: object                   # frozen SearchSpec (hashable, ==-able)
    future: Future
    t_enqueue: float
    deadline: Optional[float] = None

    def expired(self, now: float) -> bool:
        return self.deadline is not None and now > self.deadline


def shape_bucket(n: int, max_batch: int) -> int:
    """Pow2 compiled-shape bucket for a batch of ``n`` queries, clamped to
    ``max_batch`` — the serving tier's demand octaves."""
    if n < 1:
        raise ValueError(f"batch size must be >= 1, got {n}")
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


def pad_batch(Q: np.ndarray, bucket: int) -> np.ndarray:
    """Pad (n, D) up to (bucket, D) by repeating the last row.  Repeating a
    real query keeps padded lanes numerically ordinary (no inf/sentinel
    entering the scan); their results are discarded by the caller."""
    n = len(Q)
    if n == bucket:
        return Q
    if n > bucket:
        raise ValueError(f"batch of {n} does not fit bucket {bucket}")
    return np.concatenate([Q, np.repeat(Q[-1:], bucket - n, axis=0)], axis=0)


class AdmissionQueue:
    """Bounded FIFO of ``QueryItem``s with coalescing drain.

    Thread-safe; many producers (caller threads) and one consumer (the
    batcher thread).  ``close()`` wakes every waiter; after close, ``put``
    raises ``ServerClosed`` and ``drain`` keeps returning queued items
    until the queue is empty (the drain-on-shutdown contract)."""

    def __init__(self, maxsize: int):
        if maxsize < 1:
            raise ValueError(f"maxsize must be >= 1, got {maxsize}")
        self.maxsize = int(maxsize)
        self._q: "collections.deque[QueryItem]" = collections.deque()
        self._cond = threading.Condition()
        self._closed = False

    def __len__(self) -> int:
        with self._cond:
            return len(self._q)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def put(self, item: QueryItem) -> bool:
        """Enqueue; returns False (rejecting) when full — never blocks."""
        with self._cond:
            if self._closed:
                raise ServerClosed("admission queue is closed")
            if len(self._q) >= self.maxsize:
                return False
            self._q.append(item)
            self._cond.notify()
            return True

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    def clear(self) -> list:
        """Remove and return every queued item (no-drain shutdown)."""
        with self._cond:
            items = list(self._q)
            self._q.clear()
            return items

    def drain(
        self,
        max_batch: int,
        window_s: float = 0.0,
        timeout_s: Optional[float] = None,
    ) -> tuple[list, list]:
        """Block until at least one item arrives (or ``timeout_s`` elapses /
        the queue closes empty), then coalesce up to ``max_batch`` items
        sharing the FIRST item's spec, waiting up to ``window_s`` for
        stragglers once something is pending.  Returns ``(batch, expired)``
        — ``expired`` items' deadlines passed while queued; items with a
        different spec stay queued (front, original order) for the next
        drain.  ``([], [])`` signals timeout or closed-and-empty."""
        with self._cond:
            deadline = (
                None if timeout_s is None
                else time.perf_counter() + timeout_s
            )
            while not self._q:
                if self._closed:
                    return [], []
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.perf_counter()
                    if remaining <= 0:
                        return [], []
                    self._cond.wait(remaining)
            if window_s > 0 and not self._closed:
                t_end = time.perf_counter() + window_s
                while len(self._q) < max_batch and not self._closed:
                    remaining = t_end - time.perf_counter()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
            now = time.perf_counter()
            batch: list = []
            expired: list = []
            keep: list = []
            spec = None
            while self._q:
                item = self._q.popleft()
                if item.expired(now):
                    expired.append(item)
                    continue
                if spec is None:
                    spec = item.spec
                if item.spec == spec and len(batch) < max_batch:
                    batch.append(item)
                else:
                    keep.append(item)
            self._q.extendleft(reversed(keep))
            return batch, expired
