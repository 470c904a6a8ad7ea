#!/usr/bin/env python3
"""How fast K6's tail gathers scattered lanes on one CUDA card, beside a
plain gather kernel that does nothing else.

    python3 tools/k6_gather_rate.py [--seed 0]

K6 (``pdx_prune_scan``) on a (960, 10^6) f32 block of standard normal
rows at thr = +inf, with ``ids`` marking only a chosen set of lanes real:
its sweep lists exactly those lanes and its tail gathers every row of
d-tiles 1-14 for each, one 4-byte load a lane and row.  The tail's time is
the call's beyond the same call at thr = 0 (the sweep alone; CUDA-event
medians of device time as ``chip_smoke.cuda_ms``), and its rate the
gathers over that time, beside the 32-byte sectors they touch.

The probe is independent of K6: a kernel of this file (built with nvcc
into the git-ignored ``build/tools/``) in which a thread takes one listed
lane at a time and gathers the same rows, 64 loads issued before it sums
them, and writes the lane's sum; no list, test or refill.  It runs at
several launch shapes on the same lanes: 1, 2 and 4 blocks of 128 threads
an SM walking the lanes in a grid-stride loop (K6's tail has one such
block an SM), and one thread a lane.  Its best rate is what the card gave
a plain gather of this pattern in this run, not a proven ceiling.

Lane sets: random (1.55 %, 6 % and 25 % of the lanes, sorted, as the sweep
lists them) and regular strides of 64 lanes, 8 (one lane a sector,
sectors adjacent) and 1 (consecutive).  Prints one JSON line per set and
the card's name and power limit from ``nvidia-smi``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE_SRC = r"""
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kGather = 64;

__global__ void __launch_bounds__(128)
gather_probe_kernel(const float* __restrict__ x, const int* __restrict__ lanes, int n, int V,
                    int r0, int r1, float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
    const int v = lanes[i];
    float c = 0.f;
    for (int i0 = r0; i0 < r1; i0 += kGather) {
      const int m = min(kGather, r1 - i0);
      const float* p = x + (int64_t)i0 * V + v;
      float xv[kGather];
#pragma unroll
      for (int k = 0; k < kGather; ++k) xv[k] = p[(int64_t)min(k, m - 1) * V];
#pragma unroll
      for (int k = 0; k < kGather; ++k) c += k < m ? xv[k] : 0.f;
    }
    out[i] = c;
  }
}

extern "C" int gather_probe(const float* x, const int* lanes, int n, int V, int r0, int r1,
                            float* out, int blocks, void* stream) {
  gather_probe_kernel<<<blocks, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      x, lanes, n, V, r0, r1, out);
  return (int)cudaGetLastError();
}
"""


def build_probe():
    """The probe's library, compiled with the port's nvcc flags."""
    from repro_torch.kernels import _build

    out = ROOT / "build" / "tools"
    out.mkdir(parents=True, exist_ok=True)
    src, lib = out / "gather_probe.cu", out / "libgather_probe.so"
    src.write_text(PROBE_SRC)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(lib)).gather_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("k6_gather_rate: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.kernels.pdx_scan import (
        pdx_prune_scan_cuda, pdx_prune_scan_geometry, pdx_prune_scan_workspace,
    )

    dev = torch.device("cuda")
    smi = cs.nvidia_smi()
    probe = build_probe()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    D, V, d_tile = 960, 1_000_000, 64
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    T = torch.randn((D, V), generator=gen, device=dev)
    q = torch.randn((D,), generator=gen, device=dev)
    ws = pdx_prune_scan_workspace(V, dev)
    inf = torch.full((1,), float("inf"), device=dev)
    zero = torch.zeros((1,), device=dev)
    geo = pdx_prune_scan_geometry(T, d_tile=d_tile)
    sets = {f"random {f:.4f}": torch.sort(torch.randperm(V, generator=gen, device=dev)
                                          [:int(f * V)]).values
            for f in (0.0155, 0.06, 0.25)}
    n = int(0.0155 * V)
    for stride in (64, 8, 1):
        sets[f"stride {stride}"] = torch.arange(0, stride * n, stride, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for name, lanes in sets.items():
        ids = torch.full((V,), -1, dtype=torch.int32, device=dev)
        ids[lanes] = lanes.to(torch.int32)

        def call(thr):
            return lambda: pdx_prune_scan_cuda(T, ids, q, thr, d_tile=d_tile, eps0=2.1,
                                               workspace=ws)
        ms = cs.cuda_ms(torch, call(inf))
        ms_sweep = cs.cuda_ms(torch, call(zero))
        kd, alive = call(inf)()
        assert int(ws[0]) == lanes.numel() and int(alive.sum()) == lanes.numel()
        gathers = lanes.numel() * (D - d_tile)
        sectors = torch.unique(lanes // 8).numel() * (D - d_tile)
        tail = ms - ms_sweep

        lanes32 = lanes.to(torch.int32)
        out = torch.empty(lanes.numel(), dtype=torch.float32, device=dev)
        shapes = {f"{b} blocks an SM": b * sms for b in (1, 2, 4)}
        shapes["a thread a lane"] = (lanes.numel() + 127) // 128
        probe_rate = {}
        for shape, blocks in shapes.items():
            def run(blocks=blocks):
                rc = probe(T.data_ptr(), lanes32.data_ptr(), lanes.numel(), V, d_tile, D,
                           out.data_ptr(), blocks, stream)
                assert rc == 0, f"gather_probe launch failed: {rc}"
            probe_ms = cs.cuda_ms(torch, run)
            probe_rate[shape] = {"blocks": blocks, "ms": probe_ms,
                                 "gathers_per_s": gathers / probe_ms * 1e3}
        want = (T[d_tile:, lanes]).sum(0)
        assert torch.allclose(out, want, rtol=1e-4, atol=1e-3), "gather_probe: wrong sums"
        best = max(r["gathers_per_s"] for r in probe_rate.values())
        print(json.dumps({"phase": "k6_gather_rate", "lanes": name, "count": lanes.numel(),
                          "ms": ms, "ms_sweep": ms_sweep, "tail_ms": tail,
                          "gathers_per_s": gathers / tail * 1e3,
                          "sectors_per_s": sectors / tail * 1e3,
                          "sector_bytes_per_s": 32 * sectors / tail * 1e3,
                          "tail_blocks": geo["tail_blocks"], "probe": probe_rate,
                          "tail_over_best_probe": gathers / tail * 1e3 / best,
                          "nvidia_smi": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
