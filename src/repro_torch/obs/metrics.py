"""Process-wide metrics registry: labeled counters, gauges, and
log2-bucketed histograms.

Design constraints (the reason this is not a third-party client):

* **Zero cost when disabled.**  Every instrumentation site in the search
  stack calls ``metrics.enabled()`` first; the module-level convenience
  helpers (``counter``/``gauge``/``observe``) also guard themselves, so a
  disabled process never takes the lock, never allocates a label tuple,
  and never mutates the registry.
* **Thread-safe.**  A single ``threading.Lock`` guards all mutation —
  serving code mutates from request threads while a scraper snapshots.
* **Deterministic snapshots.**  ``snapshot()`` sorts metric names, label
  sets, and histogram buckets, so two registries fed the same event
  sequence serialize to byte-identical JSON (tested).
* **Bounded label cardinality.**  Each metric keeps at most
  ``max_series_per_metric`` distinct label sets; overflow events collapse
  into a reserved ``other="true"`` series and are counted in
  ``dropped_series`` — a buggy label (e.g. a raw id) can never grow the
  registry without bound.

Histograms are log2-bucketed: bucket ``i`` holds values in
``(2**(i-1), 2**i]`` (the upper edge is the Prometheus ``le`` label), with
dedicated underflow (``value <= 0``) and ``+Inf`` handling — one octave per
bucket, which is exactly the "demand octave" resolution the routing
telemetry wants.
"""
from __future__ import annotations

import json
import math
import os
import threading
from typing import Optional

__all__ = [
    "MetricsRegistry",
    "enabled",
    "set_enabled",
    "get_registry",
    "counter",
    "gauge",
    "observe",
]

# ---------------------------------------------------------------- enable flag
_ENABLED = os.environ.get("REPRO_OBS", "").lower() in ("1", "true", "on")


def enabled() -> bool:
    """Is observability on?  Instrumentation sites check this first; when
    False they must do no work beyond the check itself."""
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


# ------------------------------------------------------------------ registry
_OVERFLOW_KEY = (("other", "true"),)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in key)


class _Hist:
    __slots__ = ("count", "sum", "buckets")

    def __init__(self):
        self.count = 0
        self.sum = 0.0
        self.buckets: dict[Optional[int], int] = {}  # None = underflow (<= 0)

    def observe(self, value: float) -> None:
        self.count += 1
        self.sum += value
        idx = bucket_index(value)
        self.buckets[idx] = self.buckets.get(idx, 0) + 1


def bucket_index(value: float) -> Optional[int]:
    """Log2 bucket of ``value``: the smallest ``i`` with ``value <= 2**i``
    (``None`` for the underflow bucket ``value <= 0``)."""
    if value <= 0:
        return None
    return max(int(math.ceil(math.log2(value) - 1e-12)), -64)


def bucket_edge(idx: Optional[int]) -> float:
    """Upper (``le``) edge of a bucket index; the underflow edge is 0."""
    return 0.0 if idx is None else float(2.0 ** idx)


class MetricsRegistry:
    """Thread-safe registry of labeled counters, gauges, and histograms."""

    def __init__(self, max_series_per_metric: int = 64):
        self._lock = threading.Lock()
        self.max_series_per_metric = int(max_series_per_metric)
        self._counters: dict[str, dict[tuple, float]] = {}
        self._gauges: dict[str, dict[tuple, float]] = {}
        self._hists: dict[str, dict[tuple, _Hist]] = {}
        self.dropped_series = 0

    # ------------------------------------------------------------- recording
    def _series_key(self, family: dict, name: str, labels: dict) -> tuple:
        series = family.setdefault(name, {})
        key = _label_key(labels)
        if key not in series and len(series) >= self.max_series_per_metric:
            self.dropped_series += 1
            return _OVERFLOW_KEY
        return key

    def counter(self, name: str, value: float = 1.0, **labels) -> None:
        with self._lock:
            key = self._series_key(self._counters, name, labels)
            series = self._counters[name]
            series[key] = series.get(key, 0.0) + float(value)

    def gauge(self, name: str, value: float, **labels) -> None:
        with self._lock:
            key = self._series_key(self._gauges, name, labels)
            self._gauges[name][key] = float(value)

    def observe(self, name: str, value: float, **labels) -> None:
        with self._lock:
            key = self._series_key(self._hists, name, labels)
            series = self._hists[name]
            h = series.get(key)
            if h is None:
                h = series[key] = _Hist()
            h.observe(float(value))

    # --------------------------------------------------------------- reading
    def get(self, name: str, **labels) -> float:
        """Current value of a counter or gauge series (0.0 if absent)."""
        key = _label_key(labels)
        with self._lock:
            if name in self._counters:
                return self._counters[name].get(key, 0.0)
            if name in self._gauges:
                return self._gauges[name].get(key, 0.0)
        return 0.0

    def sum(self, name: str, **labels) -> float:
        """Sum of every counter series of ``name`` whose labels include the
        given ones — e.g. total bytes across components."""
        want = set(_label_key(labels))
        with self._lock:
            series = self._counters.get(name, {})
            return float(
                sum(v for k, v in series.items() if want <= set(k))
            )

    def snapshot(self) -> dict:
        """Deterministic plain-dict snapshot (sorted names, labels, buckets);
        ``json.dumps(snapshot, sort_keys=True)`` is byte-stable across
        registries fed the same events."""
        with self._lock:
            out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
            for name in sorted(self._counters):
                out["counters"][name] = {
                    _label_str(k): v
                    for k, v in sorted(self._counters[name].items())
                }
            for name in sorted(self._gauges):
                out["gauges"][name] = {
                    _label_str(k): v
                    for k, v in sorted(self._gauges[name].items())
                }
            for name in sorted(self._hists):
                out["histograms"][name] = {}
                for k, h in sorted(self._hists[name].items()):
                    buckets = {
                        f"le_{bucket_edge(i)!r}": c
                        for i, c in sorted(
                            h.buckets.items(),
                            key=lambda kv: (kv[0] is not None, kv[0] or 0),
                        )
                    }
                    out["histograms"][name][_label_str(k)] = {
                        "count": h.count, "sum": h.sum, "buckets": buckets,
                    }
            out["dropped_series"] = self.dropped_series
            return out

    def dump_json(self, path: Optional[str] = None) -> str:
        text = json.dumps(self.snapshot(), sort_keys=True, indent=2)
        if path is not None:
            with open(path, "w") as f:
                f.write(text + "\n")
        return text

    def prometheus_text(self) -> str:
        """Prometheus text exposition (counters/gauges verbatim, histograms
        with cumulative ``_bucket{le=...}``/``_sum``/``_count`` series)."""
        def fmt_labels(key: tuple, extra: str = "") -> str:
            parts = [f'{k}="{v}"' for k, v in key]
            if extra:
                parts.append(extra)
            return "{" + ",".join(parts) + "}" if parts else ""

        lines: list[str] = []
        with self._lock:
            for name in sorted(self._counters):
                lines.append(f"# TYPE {name} counter")
                for k, v in sorted(self._counters[name].items()):
                    lines.append(f"{name}{fmt_labels(k)} {v:g}")
            for name in sorted(self._gauges):
                lines.append(f"# TYPE {name} gauge")
                for k, v in sorted(self._gauges[name].items()):
                    lines.append(f"{name}{fmt_labels(k)} {v:g}")
            for name in sorted(self._hists):
                lines.append(f"# TYPE {name} histogram")
                for k, h in sorted(self._hists[name].items()):
                    cum = 0
                    for i, c in sorted(
                        h.buckets.items(),
                        key=lambda kv: (kv[0] is not None, kv[0] or 0),
                    ):
                        cum += c
                        le = 'le="%g"' % bucket_edge(i)
                        lines.append(f"{name}_bucket{fmt_labels(k, le)} {cum}")
                    inf = 'le="+Inf"'
                    lines.append(
                        f"{name}_bucket{fmt_labels(k, inf)} {h.count}"
                    )
                    lines.append(f"{name}_sum{fmt_labels(k)} {h.sum:g}")
                    lines.append(f"{name}_count{fmt_labels(k)} {h.count}")
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._hists.clear()
            self.dropped_series = 0


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return _REGISTRY


# ------------------------------------------- guarded convenience recorders
# These exist so call sites stay one line; each re-checks the flag so a
# direct call in disabled mode is still a no-op.
def counter(name: str, value: float = 1.0, **labels) -> None:
    if _ENABLED:
        _REGISTRY.counter(name, value, **labels)


def gauge(name: str, value: float, **labels) -> None:
    if _ENABLED:
        _REGISTRY.gauge(name, value, **labels)


def observe(name: str, value: float, **labels) -> None:
    if _ENABLED:
        _REGISTRY.observe(name, value, **labels)
