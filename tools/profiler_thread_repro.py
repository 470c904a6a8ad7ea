#!/usr/bin/env python3
"""Does plain PyTorch crash when ``torch.profiler`` is stopped from one
thread while other threads launch work on the same CUDA card?

    python3 tools/profiler_thread_repro.py [--trials 5] [--windows 4]

Each trial is a fresh process (``python -X faulthandler``), so a crash
ends one trial and not the run.  In a trial two worker threads run until
told to stop: one copies NumPy arrays to the card and reduces them, the
other sorts, takes the top 10 of and copies back (64, 2^20) f32 rows, as a
serving loop's batcher and executor threads do.  The main thread opens
``--windows`` profiler windows (CPU and CUDA activities) of 0.5 s, one
after another, and ends each by calling ``stop()`` and
``key_averages()``:

- ``mid``: while the workers run;
- ``idle``: after pausing the workers and synchronizing the card, then
  resuming them.

The modes take turns, trial by trial.  Nothing of this repository is
imported.  Prints one JSON line per trial (mode, exit code, windows
closed, seconds, the stderr tail of a failed trial), a summary line, and
the card's name and power limit from ``nvidia-smi``.  Exits 0 when every
trial ran, whatever the trials' exit codes.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time


def trial(mode: str, windows: int) -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    stop = threading.Event()
    run = threading.Event()
    run.set()
    errors = []

    def feeder():
        rng = np.random.default_rng(1)
        while not stop.is_set():
            run.wait()
            x = torch.from_numpy(rng.standard_normal((64, 960), dtype=np.float32)).to(dev)
            (x * x).sum(dim=1).cpu().numpy()

    def scanner():
        g = torch.Generator(device=dev).manual_seed(2)
        while not stop.is_set():
            run.wait()
            d = torch.rand((64, 1 << 20), device=dev, generator=g)
            v, i = torch.sort(d, dim=1, stable=True)
            torch.topk(v[:, :4096], 10, dim=1, largest=False)[1].cpu().numpy()
            i[:, :10].cpu().numpy()

    def guarded(fn):
        def body():
            try:
                fn()
            except BaseException as e:  # reported, and the trial fails
                errors.append(repr(e))
        return body

    threads = [threading.Thread(target=guarded(f), daemon=True) for f in (feeder, scanner)]
    for t in threads:
        t.start()
    time.sleep(0.5)
    for _ in range(windows):
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.start()
        time.sleep(0.5)
        if mode == "idle":
            run.clear()
            time.sleep(0.2)  # each worker finishes the step it is in
            torch.cuda.synchronize()
        prof.stop()
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
        print(json.dumps({"window_device_busy_us": busy}), flush=True)
        run.set()
        time.sleep(0.2)
    stop.set()
    run.set()
    for t in threads:
        t.join(timeout=30)
    torch.cuda.synchronize()
    if errors:
        print(json.dumps({"worker_errors": errors}), flush=True)
        return 1
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trials", type=int, default=5)
    ap.add_argument("--windows", type=int, default=4)
    ap.add_argument("--trial", choices=("mid", "idle"), default=None,
                    help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.trial is not None:
        return trial(a.trial, a.windows)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    rcs = {"mid": [], "idle": []}
    # the modes take turns, so a run cut short still has both
    for t in range(a.trials):
        for mode in rcs:
            t0 = time.perf_counter()
            p = subprocess.run(
                [sys.executable, "-X", "faulthandler", __file__, "--trial", mode,
                 "--windows", str(a.windows)],
                capture_output=True, text=True, timeout=600)
            rcs[mode].append(p.returncode)
            line = {"mode": mode, "trial": t, "rc": p.returncode,
                    "windows_closed": p.stdout.count("window_device_busy_us"),
                    "seconds": time.perf_counter() - t0}
            if p.returncode != 0:
                line["stderr_tail"] = p.stderr.strip().splitlines()[-12:]
            print(json.dumps(line), flush=True)
    summary = {mode: {"trials": len(r), "crashed": sum(rc != 0 for rc in r), "rcs": r,
                      "windows_per_trial": a.windows} for mode, r in rcs.items()}
    print(json.dumps({"summary": summary}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
