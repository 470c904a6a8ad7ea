"""Per-query span tracer with a bounded ring buffer and Perfetto export.

One ``QueryTrace`` is recorded per ``VectorSearchEngine.search`` call (the
span taxonomy is documented in the package docstring: plan → route → scan →
rerank → merge under a ``query`` root).  Spans are wall-clock intervals
(``time.perf_counter``); because every executor materializes host arrays
before returning, a span closing after the executor body has already paid
the device fence — ``fence(x)`` is the explicit ``torch.cuda.synchronize``
helper for call sites that hold device values open across a span edge.

Disabled mode (``obs.metrics.enabled() == False``) is a strict no-op: the
module-level ``query``/``span`` helpers return shared null context
managers, allocate nothing, touch no thread-local state, and never force a
device sync.

Threading model
---------------
The *current* trace is thread-local: concurrent searches on different
threads each record into their own ``QueryTrace`` and all finished traces
land in the one shared, lock-guarded ring — ``engine.metrics()`` /
``dump_trace()`` aggregate across every thread.  For serving loops where a
query's lifecycle crosses threads (enqueued on a caller thread, executed on
a worker), the context-manager API splits into explicit halves:

    trace = tracer.start_query(bucket=8)      # any thread, no binding
    with tracer.use(trace):                   # bind on the worker thread
        tracer.span_at("queue", t_enq, t_run) # record the already-elapsed wait
        ... spans recorded by the engine land on `trace` ...
    tracer.finish_query(trace)                # any thread -> shared ring

``finish_query`` unbinds the trace only from threads where it is current
(via ``use``), so finishing on thread B never leaves thread A's
thread-local pointing at a dead trace.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import threading
import time
from typing import Optional

from . import metrics as _metrics

__all__ = [
    "Span",
    "QueryTrace",
    "Tracer",
    "get_tracer",
    "query",
    "span",
    "span_at",
    "start_query",
    "finish_query",
    "use",
    "fence",
    "current_trace",
]


@dataclasses.dataclass
class Span:
    """One traced phase: a closed wall-clock interval plus attributes."""

    name: str
    t0: float
    t1: float
    depth: int
    attrs: dict

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0


@dataclasses.dataclass
class QueryTrace:
    """All spans of one search call, in completion order."""

    trace_id: int
    t0: float
    t1: float = 0.0
    attrs: dict = dataclasses.field(default_factory=dict)
    spans: list = dataclasses.field(default_factory=list)

    @property
    def duration_s(self) -> float:
        return self.t1 - self.t0

    def span_names(self) -> tuple:
        return tuple(s.name for s in self.spans)

    def find(self, name: str) -> Optional[Span]:
        for s in self.spans:
            if s.name == name:
                return s
        return None


class _NullCtx:
    """Shared no-op context manager — the disabled-mode fast path."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_CTX = _NullCtx()


class _SpanCtx:
    __slots__ = ("_tracer", "_trace", "name", "attrs", "_t0", "_depth")

    def __init__(self, tracer: "Tracer", trace: QueryTrace, name: str,
                 attrs: dict):
        self._tracer = tracer
        self._trace = trace
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        tl = self._tracer._tl
        self._depth = getattr(tl, "depth", 0)
        tl.depth = self._depth + 1
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._tracer._tl.depth = self._depth
        self._trace.spans.append(Span(
            name=self.name, t0=self._t0, t1=t1, depth=self._depth,
            attrs=self.attrs,
        ))
        return False


class _QueryCtx:
    __slots__ = ("_tracer", "attrs", "_trace")

    def __init__(self, tracer: "Tracer", attrs: dict):
        self._tracer = tracer
        self.attrs = attrs

    def __enter__(self) -> QueryTrace:
        self._trace = self._tracer._start(self.attrs)
        return self._trace

    def __exit__(self, *exc):
        self._tracer._finish(self._trace)
        return False


class _UseCtx:
    """Binds an explicitly started trace as the calling thread's current
    trace for the duration of the block, restoring the previous binding on
    exit — a worker thread in a pool never inherits a stale current trace
    from an earlier query it executed."""

    __slots__ = ("_tracer", "_trace", "_prev", "_prev_depth")

    def __init__(self, tracer: "Tracer", trace: QueryTrace):
        self._tracer = tracer
        self._trace = trace

    def __enter__(self) -> QueryTrace:
        tl = self._tracer._tl
        self._prev = getattr(tl, "current", None)
        self._prev_depth = getattr(tl, "depth", 0)
        tl.current = self._trace
        tl.depth = 0
        return self._trace

    def __exit__(self, *exc):
        tl = self._tracer._tl
        tl.current = self._prev
        tl.depth = self._prev_depth
        return False


class Tracer:
    """Span recorder: per-thread current trace, bounded ring of finished
    traces, Chrome/Perfetto JSON export."""

    def __init__(self, capacity: int = 256):
        self.capacity = int(capacity)
        self._ring: "collections.deque[QueryTrace]" = collections.deque(
            maxlen=self.capacity
        )
        self._tl = threading.local()
        self._lock = threading.Lock()
        self._next_id = 0

    # ------------------------------------------------------------- recording
    def query(self, **attrs):
        """Context manager opening a new ``QueryTrace`` (the root span).
        Yields the trace when enabled, ``None`` (a shared null context)
        otherwise; nested traces are not supported — a nested call records
        nothing and leaves the outer trace current."""
        if not _metrics.enabled() or getattr(self._tl, "current", None):
            return _NULL_CTX
        return _QueryCtx(self, attrs)

    def span(self, name: str, **attrs):
        """Context manager recording one span on the current trace; a shared
        no-op when disabled or outside a ``query`` context."""
        trace = getattr(self._tl, "current", None)
        if trace is None or not _metrics.enabled():
            return _NULL_CTX
        return _SpanCtx(self, trace, name, attrs)

    def span_at(self, name: str, t0: float, t1: float, **attrs) -> None:
        """Record an already-elapsed interval as a span on the current trace
        (e.g. the queue wait a batcher measured before the worker thread
        bound the trace).  No-op when disabled or outside a trace."""
        trace = getattr(self._tl, "current", None)
        if trace is None or not _metrics.enabled():
            return
        trace.spans.append(Span(
            name=name, t0=float(t0), t1=float(t1),
            depth=getattr(self._tl, "depth", 0), attrs=attrs,
        ))

    # -------------------------------------------- cross-thread serving API
    def start_query(self, **attrs) -> Optional[QueryTrace]:
        """Allocate an open ``QueryTrace`` WITHOUT binding it to the calling
        thread — the first half of the cross-thread lifecycle (a serving
        loop starts the trace where the batch is formed and binds it on the
        worker that executes it, via ``use``).  Returns ``None`` when
        observability is disabled; every other API accepts that ``None``."""
        if not _metrics.enabled():
            return None
        with self._lock:
            tid = self._next_id
            self._next_id += 1
        return QueryTrace(trace_id=tid, t0=time.perf_counter(), attrs=attrs)

    def use(self, trace: Optional[QueryTrace]):
        """Context manager binding ``trace`` as the calling thread's current
        trace: ``span``/``span_at`` (and everything the engine records under
        an existing trace) land on it.  A shared no-op for ``trace=None``."""
        if trace is None:
            return _NULL_CTX
        return _UseCtx(self, trace)

    def finish_query(self, trace: Optional[QueryTrace]) -> None:
        """Close an explicitly started trace and append it to the shared
        ring.  Callable from any thread: the trace is unbound only where it
        is actually current, so finishing on a worker thread never leaves
        the starting thread's thread-local pointing at a dead trace."""
        if trace is None:
            return
        self._finish(trace)

    def _start(self, attrs: dict) -> QueryTrace:
        with self._lock:
            tid = self._next_id
            self._next_id += 1
        trace = QueryTrace(trace_id=tid, t0=time.perf_counter(), attrs=attrs)
        self._tl.current = trace
        self._tl.depth = 0
        return trace

    def _finish(self, trace: QueryTrace) -> None:
        trace.t1 = time.perf_counter()
        # unbind only if current HERE: a trace finished on thread B must not
        # clobber thread A's binding (the pre-serving code unconditionally
        # cleared the finisher's slot, which dangled cross-thread traces)
        if getattr(self._tl, "current", None) is trace:
            self._tl.current = None
        with self._lock:
            self._ring.append(trace)

    # --------------------------------------------------------------- reading
    def traces(self) -> list:
        with self._lock:
            return list(self._ring)

    def last(self) -> Optional[QueryTrace]:
        with self._lock:
            return self._ring[-1] if self._ring else None

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def export_chrome(self, path: Optional[str] = None) -> dict:
        """The ring as Chrome trace-event JSON (complete ``"X"`` events;
        loads in chrome://tracing and ui.perfetto.dev).  Each trace renders
        as one ``tid`` row: the ``query`` root plus its phase spans."""
        events = []
        for tr in self.traces():
            base = {"pid": 0, "tid": tr.trace_id, "ph": "X"}
            events.append({
                **base, "name": "query",
                "ts": tr.t0 * 1e6, "dur": max(tr.t1 - tr.t0, 0.0) * 1e6,
                "args": {k: str(v) for k, v in tr.attrs.items()},
            })
            for s in tr.spans:
                events.append({
                    **base, "name": s.name,
                    "ts": s.t0 * 1e6, "dur": max(s.t1 - s.t0, 0.0) * 1e6,
                    "args": {k: str(v) for k, v in s.attrs.items()},
                })
        doc = {"traceEvents": events, "displayTimeUnit": "ms"}
        if path is not None:
            with open(path, "w") as f:
                json.dump(doc, f, indent=2)
        return doc


_TRACER = Tracer()


def get_tracer() -> Tracer:
    return _TRACER


def query(**attrs):
    return _TRACER.query(**attrs)


def span(name: str, **attrs):
    return _TRACER.span(name, **attrs)


def span_at(name: str, t0: float, t1: float, **attrs) -> None:
    _TRACER.span_at(name, t0, t1, **attrs)


def start_query(**attrs) -> Optional[QueryTrace]:
    return _TRACER.start_query(**attrs)


def use(trace: Optional[QueryTrace]):
    return _TRACER.use(trace)


def finish_query(trace: Optional[QueryTrace]) -> None:
    _TRACER.finish_query(trace)


def current_trace() -> Optional[QueryTrace]:
    return getattr(_TRACER._tl, "current", None)


def fence(x):
    """``torch.cuda.synchronize()`` when a trace is live and any tensor
    among ``x``'s leaves (a tensor, or a tuple/list/dataclass of them) lies
    on a CUDA device, so the enclosing span's wall time includes device
    completion; identity (and zero extra syncs) otherwise."""
    if _metrics.enabled() and current_trace() is not None:
        if any(getattr(t, "is_cuda", False) for t in _leaves(x)):
            import torch

            torch.cuda.synchronize()
    return x


def _leaves(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from _leaves(v)
    elif hasattr(x, "__dataclass_fields__"):
        for name in x.__dataclass_fields__:
            yield from _leaves(getattr(x, name))
    else:
        yield x
