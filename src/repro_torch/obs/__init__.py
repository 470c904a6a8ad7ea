"""repro_torch.obs — runtime telemetry for the search stack.

Copies of the reference's framework-free ``obs.metrics`` (process-wide
registry of labeled counters, gauges and log2 histograms, behind one
enable flag: ``metrics.set_enabled`` or ``REPRO_OBS=1``) and ``obs.trace``
(per-query span tracer with Perfetto export).  The only change is
``trace.fence``, which synchronizes the CUDA device instead of blocking on
JAX arrays.  Metric and span names are the reference's (``repro_*``
families; spans plan → route → scan → rerank → merge), so dashboards read
both packages alike.

``obs.meters`` holds the part of the reference's byte and work models the
ported executors need (``tile_widths``, ``fused_tile_counts``); it is
imported on demand because it pulls in the kernel oracles.
"""
from . import metrics, trace

__all__ = ["metrics", "trace", "meters"]
