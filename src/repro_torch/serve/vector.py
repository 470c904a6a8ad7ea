"""Async online serving tier for vector search: continuous batching with
pow2 batch-shape buckets, deadline/backpressure, overlapped host planning,
and off-path store maintenance.

Counterpart of ``repro.serve.vector``.  ``VectorServer`` wraps a
``VectorSearchEngine`` with three threads:

batcher
    Drains the ``AdmissionQueue`` (``repro_torch.serve.batcher``),
    coalescing same-spec queries into a batch, pads it to a pow2 shape
    bucket (``core.plan.pow2_bucket``, so a drifting arrival rate cycles
    through at most ``log2(max_batch) + 1`` batch shapes), runs the HOST
    half of the search (``plan_search`` + ``prepare_execute`` under the
    store lock), and hands the prepared batch to the executor through a
    depth-1 queue.  That queue IS the double buffer: while the executor
    runs batch N's device work, the batcher is already planning batch N+1
    — for ``tiered-scan`` that includes routing and issuing N+1's cache
    uploads, for the other executors planning and padding.

executor
    The sole store mutator.  Pops prepared batches (runs them with no lock
    held — nothing else may mutate), mutations (``insert``/``delete``
    applied under the store lock), and maintenance swaps.  Records the
    cross-thread query trace: ``start_query``/``use``/``finish_query`` plus
    ``span_at`` for the queue wait and the batcher-side plan time.

maintenance (optional)
    Periodically clones the store under the lock, runs
    ``MutablePDXStore.repack()`` on the clone OFF the serving path, and
    posts a version-fenced swap.  Mutations that land while the clone
    repacks are recorded in the store's oplog and replayed onto the clone
    before adoption, so under continuous traffic the repack is adopted
    instead of discarded; an overflowed oplog or replay id divergence
    discards it.  After a swap a BOND pruner is rebuilt on the engine's
    device; BSA recalibration stays with the synchronous
    ``engine.compact()``.

Both the batcher and the executor enqueue their device work on the
thread's current stream, torch's default stream, so the order in which
they enqueue is the order the card runs it in (the tiered pool's in-place
uploads rely on it, ``core.plan._run_tiered_device``).

Backpressure and deadlines: the admission queue is bounded — a full queue
rejects at ``submit`` with ``ServerOverloaded``.  Before that, overload
*sheds*: when the queue is deeper than ``shed_depth`` the batcher drops
the batch's ``nprobe`` to ``shed_nprobe`` (IVF engines).  Each query may
carry a deadline, checked while queued and after execution.  A failure in
a server thread reaches the futures of the batch it was serving; one in
maintenance (clone, repack, swap) is kept and raised by ``close()``.

No set-ups after warmup: ``warmup()`` pushes one synthetic batch per shape
bucket through the full prepare/run path (``core.plan.warm_shapes``) and
snapshots the set-up count (``obs.setups``: kernel libraries loaded,
mirrors built, tiered caches, host masters and quant params made — the
port's counterpart of the reference's XLA compile count);
``jit_compiles_since_warmup`` then shows whether the steady state built
anything.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

from ..core.layout import MutablePDXStore
from ..core.plan import plan_search, pow2_bucket, prepare_execute, warm_shapes
from ..obs import metrics as _metrics
from ..obs import setups as _setups
from ..obs import trace as _trace
from .batcher import (
    AdmissionQueue,
    DeadlineExceeded,
    QueryItem,
    ServerClosed,
    ServerOverloaded,
    pad_batch,
)

__all__ = ["VectorServer", "jit_compile_count"]


def jit_compile_count() -> int:
    """Set-ups counted process-wide (``obs.setups.count``): the state a
    first search builds — a kernel library loaded, a device or projection
    mirror built, a mutable store's tiles uploaded, a tiered cache or its
    pool, host masters, quant params or sorted host rows made.  The
    reference's name, which counts XLA compiles; the port compiles nothing
    per shape."""
    return _setups.count()


# ------------------------------------------------------------- work items
class _Shutdown:
    pass


_SHUTDOWN = _Shutdown()


class _Batch:
    __slots__ = (
        "items", "prepared", "bucket", "Qpad", "spec",
        "store_version", "t_plan0", "t_plan1", "shed",
    )

    def __init__(self, items, prepared, bucket, Qpad, spec, store_version,
                 t_plan0, t_plan1, shed):
        self.items = items
        self.prepared = prepared
        self.bucket = bucket
        self.Qpad = Qpad
        self.spec = spec
        self.store_version = store_version
        self.t_plan0 = t_plan0
        self.t_plan1 = t_plan1
        self.shed = shed


class _Mutation:
    __slots__ = ("kind", "payload", "future")

    def __init__(self, kind, payload, future):
        self.kind = kind          # "insert" | "delete"
        self.payload = payload
        self.future = future


class _Swap:
    __slots__ = ("clone", "expect_version")

    def __init__(self, clone, expect_version):
        self.clone = clone
        self.expect_version = expect_version


class VectorServer:
    """Continuous-batching front end over a ``VectorSearchEngine``.

    ``submit`` is async (returns a ``concurrent.futures.Future`` resolving
    to ``(ids, dists)``), ``search`` is its blocking wrapper; ``insert`` /
    ``delete`` return futures too and are serialized through the executor
    thread so the store has exactly one mutator.  Use as a context manager
    or call ``close()`` — ``drain=True`` (default) completes every queued
    query before the threads exit.

    The server serves on ``engine.device``, as the reference does: the
    engine's builders already make the caller ask for the CPU, so nothing
    runs there unasked.

    An engine whose mesh spans more than one rank is refused: the mesh
    executors are SPMD (every rank must search the same batches), and the
    admission batcher cannot promise that the ranks form the same batches,
    so the first collective would hang.  A world of one serves.
    """

    def __init__(
        self,
        engine,
        *,
        spec=None,
        max_batch: int = 64,
        queue_depth: int = 256,
        flush_interval_s: float = 0.002,
        default_timeout_s: Optional[float] = None,
        shed_depth: Optional[int] = None,
        shed_nprobe: int = 4,
        maintenance_interval_s: Optional[float] = None,
        head_fill_threshold: float = 0.75,
        fragmentation_threshold: float = 0.25,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        mesh = getattr(engine, "mesh", None)
        if mesh is not None and mesh.size() > 1:
            raise ValueError(
                f"VectorServer cannot serve an engine whose mesh spans "
                f"{mesh.size()} ranks: the mesh executors need every rank to "
                "search the same batches, which the admission batcher cannot "
                "promise (the first collective would hang); serve one rank's "
                "engine without a mesh, or a world of one"
            )
        self.engine = engine
        self.device = engine.device
        self.spec = spec if spec is not None else engine.spec
        self.max_batch = int(max_batch)
        self.flush_interval_s = float(flush_interval_s)
        self.default_timeout_s = default_timeout_s
        self.shed_depth = shed_depth
        self.shed_nprobe = int(shed_nprobe)
        self.maintenance_interval_s = maintenance_interval_s
        self.head_fill_threshold = float(head_fill_threshold)
        self.fragmentation_threshold = float(fragmentation_threshold)
        #: the first failure of the maintenance path (clone, repack, swap),
        #: raised by ``close()``
        self.maintenance_error: Optional[BaseException] = None

        self._queue = AdmissionQueue(queue_depth)
        self._work: "queue.Queue" = queue.Queue(maxsize=1)
        self._store_lock = threading.RLock()
        self._stop = threading.Event()
        self._closed = False
        self._close_lock = threading.Lock()
        self._warm_compiles: Optional[int] = None

        self._batcher = threading.Thread(
            target=self._batcher_loop, name="serve-batcher", daemon=True
        )
        self._executor = threading.Thread(
            target=self._executor_loop, name="serve-executor", daemon=True
        )
        self._batcher.start()
        self._executor.start()
        self._maintenance = None
        if maintenance_interval_s is not None:
            self._maintenance = threading.Thread(
                target=self._maintenance_loop, name="serve-maintenance",
                daemon=True,
            )
            self._maintenance.start()

    # ------------------------------------------------------------- public API
    def submit(
        self,
        q: np.ndarray,
        spec=None,
        *,
        timeout_s: Optional[float] = None,
    ) -> Future:
        """Enqueue one (D,) query; the future resolves to ``(ids, dists)``
        (each ``(k,)``).  Raises ``ServerOverloaded`` when the admission
        queue is full and ``ServerClosed`` after ``close()``."""
        q = np.ascontiguousarray(np.asarray(q, np.float32))
        if q.ndim != 1:
            raise ValueError(f"submit takes one (D,) query, got {q.shape}")
        timeout_s = timeout_s if timeout_s is not None else self.default_timeout_s
        now = time.perf_counter()
        item = QueryItem(
            query=q,
            spec=spec if spec is not None else self.spec,
            future=Future(),
            t_enqueue=now,
            deadline=None if timeout_s is None else now + timeout_s,
        )
        if not self._queue.put(item):
            if _metrics.enabled():
                _metrics.counter("repro_serve_rejected_total")
            raise ServerOverloaded(
                f"admission queue full ({self._queue.maxsize})"
            )
        if _metrics.enabled():
            _metrics.gauge(
                "repro_serve_queue_depth", float(len(self._queue))
            )
        return item.future

    def search(self, q, spec=None, *, timeout_s=None):
        """Blocking ``submit``: returns ``(ids, dists)`` or raises the
        query's error (``DeadlineExceeded``, ``ServerClosed``, …)."""
        return self.submit(q, spec, timeout_s=timeout_s).result()

    def insert(self, X: np.ndarray) -> Future:
        """Async insert; resolves to the new ids.  Serialized through the
        executor thread between batches."""
        fut = Future()
        self._put_work(_Mutation("insert", np.asarray(X, np.float32), fut))
        return fut

    def delete(self, ids) -> Future:
        """Async delete; resolves to the number of rows tombstoned."""
        fut = Future()
        self._put_work(_Mutation("delete", ids, fut))
        return fut

    def queue_depth(self) -> int:
        return len(self._queue)

    def metrics(self) -> dict:
        return self.engine.metrics()

    def warmup(self, buckets=None, specs=None) -> dict:
        """Warm every shape bucket (and the shed-nprobe variants, if
        shedding is configured), then snapshot the set-up count for
        ``jit_compiles_since_warmup``.  ``specs`` adds extra SearchSpecs to
        warm beyond the server default — e.g. a cascade spec (whose stage
        mirrors are all built) or a tiered spec clients are known to send.
        Returns {bucket: executor} of the last spec warmed."""
        if buckets is None:
            buckets = []
            b = 1
            while b <= self.max_batch:
                buckets.append(b)
                b *= 2
        all_specs = [self.spec] + list(specs or ())
        if self.shed_depth is not None and self.engine.ivf is not None:
            all_specs.append(self.spec.replace(nprobe=self.shed_nprobe))
        out = {}
        with self._store_lock:
            for sp in all_specs:
                out = warm_shapes(
                    sp, self.engine.store, self.engine.pruner, buckets,
                    ivf=self.engine.ivf, mesh=self.engine.mesh,
                )
        self._warm_compiles = jit_compile_count()
        return out

    def jit_compiles_since_warmup(self) -> int:
        """Set-ups counted after ``warmup()`` (the zero-after-warmup gate;
        see ``jit_compile_count`` for what counts); raises if warmup was
        never run."""
        if self._warm_compiles is None:
            raise RuntimeError("call warmup() first")
        return jit_compile_count() - self._warm_compiles

    def close(self, drain: bool = True, timeout_s: float = 30.0) -> None:
        """Shut down.  ``drain=True`` lets queued queries complete first;
        ``drain=False`` fails them with ``ServerClosed``.  Raises the
        maintenance path's failure, if it had one."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        if not drain:
            for item in self._queue.clear():
                if not item.future.done():
                    item.future.set_exception(
                        ServerClosed("server closed without drain")
                    )
        self._stop.set()
        self._queue.close()  # wakes the batcher; it drains then forwards
        self._batcher.join(timeout=timeout_s)
        self._executor.join(timeout=timeout_s)
        if self._maintenance is not None:
            self._maintenance.join(timeout=timeout_s)
        if self.maintenance_error is not None:
            raise RuntimeError("server maintenance failed") from self.maintenance_error

    def __enter__(self) -> "VectorServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False

    # -------------------------------------------------------------- internals
    def _put_work(self, item) -> None:
        if self._closed and not isinstance(item, (_Batch, _Shutdown)):
            raise ServerClosed("server is closed")
        self._work.put(item)

    def _fail_expired(self, expired) -> None:
        for item in expired:
            if _metrics.enabled():
                _metrics.counter(
                    "repro_serve_deadline_expired_total", where="queue"
                )
            if not item.future.done():
                item.future.set_exception(
                    DeadlineExceeded("deadline passed while queued")
                )

    @staticmethod
    def _fail(items, error: BaseException) -> None:
        for item in items:
            if not item.future.done():
                item.future.set_exception(error)

    def _bind_device(self) -> None:
        """Make the engine's card current in this server thread, so its
        first CUDA call finds a context (each thread starts without one)."""
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def _batcher_loop(self) -> None:
        self._bind_device()
        while True:
            batch, expired = self._queue.drain(
                self.max_batch,
                window_s=self.flush_interval_s,
                timeout_s=0.05,
            )
            self._fail_expired(expired)
            if not batch:
                if self._queue.closed and not len(self._queue):
                    self._work.put(_SHUTDOWN)
                    return
                continue

            spec = batch[0].spec
            shed = False
            if (
                self.shed_depth is not None
                and self.engine.ivf is not None
                and len(self._queue) >= self.shed_depth
                and spec.nprobe > self.shed_nprobe
            ):
                spec = spec.replace(nprobe=self.shed_nprobe)
                shed = True
                if _metrics.enabled():
                    _metrics.counter(
                        "repro_serve_shed_total", action="nprobe"
                    )

            Q = np.stack([item.query for item in batch])
            bucket = pow2_bucket(len(batch), cap=self.max_batch)
            Qpad = pad_batch(Q, bucket)

            # host half under the store lock: plan + prepare see a consistent
            # store; the device half runs on the executor thread, which is
            # also the only mutator — prepare(N+1) overlaps run(N).
            t_plan0 = time.perf_counter()
            try:
                with self._store_lock:
                    version = getattr(self.engine.store, "version", None)
                    prepared = self._prepare(Qpad, bucket, spec)
            except BaseException as e:  # surface on the batch's futures
                self._fail(batch, e)
                continue
            t_plan1 = time.perf_counter()
            self._work.put(_Batch(
                batch, prepared, bucket, Qpad, spec, version,
                t_plan0, t_plan1, shed,
            ))
            if _metrics.enabled():
                _metrics.gauge(
                    "repro_serve_queue_depth", float(len(self._queue))
                )
                _metrics.observe(
                    "repro_serve_batch_fill", len(batch) / bucket,
                    bucket=bucket,
                )

    def _prepare(self, Qpad, bucket, spec):
        eng = self.engine
        plan = plan_search(
            spec, eng.store, bucket, pruner=eng.pruner, ivf=eng.ivf,
            mesh=eng.mesh,
        )
        return prepare_execute(
            plan, spec, eng.store, eng.pruner,
            torch.as_tensor(Qpad).to(eng.device), ivf=eng.ivf, mesh=eng.mesh,
        )

    def _executor_loop(self) -> None:
        self._bind_device()
        while True:
            work = self._work.get()
            if isinstance(work, _Shutdown):
                return
            if isinstance(work, _Mutation):
                self._apply_mutation(work)
                continue
            if isinstance(work, _Swap):
                try:
                    self._apply_swap(work)
                except BaseException as e:
                    if self.maintenance_error is None:
                        self.maintenance_error = e
                continue
            self._run_batch(work)

    def _apply_mutation(self, m: _Mutation) -> None:
        try:
            with self._store_lock:
                if m.kind == "insert":
                    out = self.engine.insert(m.payload)
                else:
                    out = self.engine.delete(m.payload)
            m.future.set_result(out)
        except BaseException as e:  # surface on the caller's future
            m.future.set_exception(e)

    def _apply_swap(self, s: _Swap) -> None:
        replayed = 0
        with self._store_lock:
            store = self.engine.store
            ok = False
            if isinstance(store, MutablePDXStore):
                # delta-replay: mutations that landed while the clone was
                # repacking were recorded on the serving store; replaying
                # them onto the repacked clone makes adoption succeed under
                # continuous traffic instead of discarding the repack work.
                # ops is None when the log overflowed (or recording never
                # started) — then only the plain version fence can save us.
                ops = store.oplog_take()
                if store.version == s.expect_version:
                    ok = store.adopt(s.clone, expect_version=s.expect_version)
                elif ops is not None:
                    try:
                        replayed = s.clone.replay(ops)
                        # we hold the lock on the sole mutator thread, so
                        # the version cannot move between replay and adopt
                        ok = store.adopt(
                            s.clone, expect_version=store.version
                        )
                    except ValueError:
                        ok = False  # id divergence: never adopt
            if ok:
                self.engine._sync_ivf()
                if self.engine.pruner.name == "bond":
                    from ..core.pruners import make_bond

                    self.engine.pruner = make_bond(
                        store._dim_means, zone_size=self.engine.zone_size,
                        device=self.engine.device,
                    )
                # BSA recalibration rewrites live vectors (not just
                # metadata) — that stays with synchronous engine.compact().
        if _metrics.enabled():
            _metrics.counter(
                "repro_serve_maintenance_total",
                event="swap" if ok else "discard",
            )
            if replayed:
                _metrics.counter(
                    "repro_serve_replayed_rows_total", float(replayed)
                )

    def _run_batch(self, b: _Batch) -> None:
        t_run = time.perf_counter()
        tr = None
        try:
            # a mutation or swap may have landed between prepare and now
            # (FIFO only orders the queue, not prepare time) — the prepared
            # host state would be stale, so re-prepare against the store.
            version = getattr(self.engine.store, "version", None)
            if version != b.store_version:
                with self._store_lock:
                    b.prepared = self._prepare(b.Qpad, b.bucket, b.spec)
            tr = _trace.start_query(
                n_queries=len(b.items), k=b.spec.k, bucket=b.bucket,
                executor=b.prepared.plan.executor, served=True,
            )
            with _trace.use(tr):
                t_enq = min(item.t_enqueue for item in b.items)
                _trace.span_at("queue", t_enq, t_run, depth_at_drain=len(b.items))
                _trace.span_at("plan", b.t_plan0, b.t_plan1)
                ids, dists = b.prepared.run()
        except BaseException as e:
            _trace.finish_query(tr)
            self._fail(b.items, e)
            return
        _trace.finish_query(tr)

        t_done = time.perf_counter()
        en = _metrics.enabled()
        if en:
            _metrics.counter(
                "repro_serve_batches_total", bucket=b.bucket,
                executor=b.prepared.plan.executor, shed=b.shed,
            )
            _metrics.counter(
                "repro_serve_queries_total", float(len(b.items))
            )
        for i, item in enumerate(b.items):
            if en:
                _metrics.observe(
                    "repro_serve_queue_wait_seconds", t_run - item.t_enqueue
                )
                _metrics.observe(
                    "repro_serve_latency_seconds", t_done - item.t_enqueue
                )
            if item.future.done():
                continue
            if item.deadline is not None and t_done > item.deadline:
                if en:
                    _metrics.counter(
                        "repro_serve_deadline_expired_total", where="result"
                    )
                item.future.set_exception(
                    DeadlineExceeded("deadline passed during execution")
                )
            else:
                item.future.set_result((ids[i].copy(), dists[i].copy()))

    def _maintenance_loop(self) -> None:
        self._bind_device()
        while not self._stop.wait(self.maintenance_interval_s):
            store = self.engine.store
            if not isinstance(store, MutablePDXStore):
                continue
            head_fill = store.head_count / max(store.head_capacity, 1)
            if (
                head_fill < self.head_fill_threshold
                and store.fragmentation <= self.fragmentation_threshold
            ):
                continue
            try:
                with self._store_lock:
                    base = store.version
                    clone = store.clone()
                    store.oplog_start()  # record deltas landing during repack
                clone.repack()  # the expensive part: no lock, off the path
            except BaseException as e:
                with self._store_lock:
                    store.oplog_take()
                self.maintenance_error = e
                return
            try:
                self._work.put(_Swap(clone, base), timeout=1.0)
            except queue.Full:
                with self._store_lock:
                    store.oplog_take()  # stop recording; clone is dropped
