"""Process-wide count of set-ups: the one-time work a first search pays and
a warm search must not.

The reference's serving tier counts XLA compiles (``jax.monitoring``) to
prove that a warm steady state mints no executables.  The port compiles
nothing per shape: its executors are eager PyTorch, and its CUDA kernels
build once per process.  What a first search pays instead is state built
on demand and then cached, and each site that builds such state calls
``note``:

  kernel_library     a CUDA kernel library loaded (``kernels._build.library``)
  device_mirror      a scan-dtype device mirror built (``layout.device_mirror``)
  projection_mirror  a projection mirror built (``layout.projection_mirror``)
  pca_fit            the PCA of a projection mirror fitted
  device_upload      a mutable store's tiles uploaded for a new tiles_version
  host_masters       a frozen store's host copy made (``layout._host_masters``)
  quant_params       a pass over the host masters for the quantizers
  bucket_cache       a tiered ``BucketCache`` created (``plan._get_bucket_cache``)
  bucket_pool        a ``BucketCache`` slot pool allocated for a generation
  host_rows          the tiered re-rank's sorted host rows (``plan._host_master_rows``)

The count moves whether or not metrics are enabled (as the reference's
listener does); with metrics on, the ``repro_serve_jit_compiles`` gauge
mirrors it, under the reference's name.  State kept inside the kernel
libraries (K1/K3's tensor map and tail occupancy, keyed by kernel and
shape, not by batch size) is not counted here.
"""
from __future__ import annotations

import threading

from . import metrics as _metrics

__all__ = ["note", "count", "by_kind"]

_LOCK = threading.Lock()
_COUNT = 0
_BY_KIND: dict[str, int] = {}


def note(kind: str) -> None:
    """Count one set-up of ``kind``."""
    global _COUNT
    with _LOCK:
        _COUNT += 1
        _BY_KIND[kind] = _BY_KIND.get(kind, 0) + 1
        n = _COUNT
    if _metrics.enabled():
        _metrics.gauge("repro_serve_jit_compiles", float(n))


def count() -> int:
    """Set-ups counted in this process so far."""
    with _LOCK:
        return _COUNT


def by_kind() -> dict[str, int]:
    """Set-ups counted so far, by kind."""
    with _LOCK:
        return dict(_BY_KIND)
