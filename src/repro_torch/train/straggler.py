"""Straggler / failure detection for multi-host runs (a copy of the
reference's host-only module, ``repro.train.straggler``).

Two host-side mechanisms (both file/host-level — they do not touch device
code, matching how production fleets handle this):

* ``StepTimeMonitor`` — per-host step-time ring buffer; flags steps slower
  than ``factor`` x rolling median.  The launcher's policy hook decides what
  to do (log, drop batch via skip-ahead, request reshard).
* ``Heartbeat`` — each host touches ``<dir>/host_<id>``; ``stale_hosts()``
  on the coordinator lists hosts whose heartbeat is older than the timeout —
  the trigger for elastic rescale (checkpoint restore on a smaller mesh,
  ``checkpoint.restore(shardings=)``, once ROADMAP.md's modules queue item
  3 ports it).
"""
from __future__ import annotations

import os
import time
from collections import deque
from typing import Optional

__all__ = ["StepTimeMonitor", "Heartbeat"]


class StepTimeMonitor:
    def __init__(self, window: int = 64, factor: float = 2.5):
        self.times: deque[float] = deque(maxlen=window)
        self.factor = factor
        self.flagged = 0
        self._t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self) -> tuple[float, bool]:
        """-> (step_seconds, is_straggler)."""
        assert self._t0 is not None, "start() not called"
        dt = time.perf_counter() - self._t0
        self._t0 = None
        slow = False
        if len(self.times) >= 8:
            med = sorted(self.times)[len(self.times) // 2]
            slow = dt > self.factor * med
        if slow:
            self.flagged += 1
        self.times.append(dt)
        return dt, slow

    @property
    def median(self) -> float:
        if not self.times:
            return 0.0
        return sorted(self.times)[len(self.times) // 2]


class Heartbeat:
    def __init__(self, directory: str, host_id: int, timeout: float = 60.0):
        self.dir = directory
        self.host_id = host_id
        self.timeout = timeout
        os.makedirs(directory, exist_ok=True)

    def _path(self, host: int) -> str:
        return os.path.join(self.dir, f"host_{host:05d}")

    def beat(self):
        with open(self._path(self.host_id), "w") as f:
            f.write(str(time.time()))

    def stale_hosts(self, now: Optional[float] = None) -> list[int]:
        now = now if now is not None else time.time()
        stale = []
        for name in os.listdir(self.dir):
            if not name.startswith("host_"):
                continue
            host = int(name.split("_")[1])
            try:
                with open(os.path.join(self.dir, name)) as f:
                    last = float(f.read().strip() or 0)
            except (OSError, ValueError):
                last = 0.0
            if now - last > self.timeout:
                stale.append(host)
        return sorted(stale)
