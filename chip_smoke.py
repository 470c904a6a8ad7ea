#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main search path on one CUDA card.

    python3 chip_smoke.py [--n 1000000] [--dim 960] [--seed 0]

Imports only ``torch``, ``numpy`` and the port (``src/repro_torch``), never
JAX or the JAX package.  Phases, each printing one JSON line:

  1. device — the card's name and power limit, torch/CUDA versions, and
     the build of the CUDA kernels from ``src/repro_torch/kernels/csrc``
     (into the git-ignored ``build/``), with their register counts.
  2. main path — an IVF + ADSampling engine over a clustered collection at
     the shape of the GIST1M dataset (n = 1,000,000, D = 960), capacity
     1024, k = 10.  For each scan dtype (f32, bf16, int8, int4): 16 single
     queries (``fused-scan``, one K1 launch each) and one batch of 64
     (``fused-batch``, K2), with the launch counters zeroed just before and
     read just after, the executors checked, returned distances checked
     against direct f32 distances of the returned ids, and recall@10
     against a ground truth computed on the card by direct f32
     differences (>= 0.95 for fused-scan, >= 0.99 for fused-batch at
     f32/bf16/int8; recorded at int4, see RECALL_FLOORS).
  3. kernels vs plain — K1 and K2 at every dtype on the engine's own
     mirror, real queries and threshold (K1 also at thr = +inf and at the
     1 % quantile of the lanes' full distances, so that lanes die at every
     d-tile), against their plain PyTorch
     versions on the same card tensors, with CUDA-event medians of the
     kernel, the plain version and (K2) a library matmul, and the least
     time the card could take (bound).
     Before it, a ``torch.profiler`` breakdown of the main path's device
     time by kernel at f32 and int8 (where the time goes).
  4. the kernels line: one JSON object per kernel and dtype.

Then the card's name and power limit (``nvidia-smi``), and as the last
line ``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero before the result lines; without a CUDA card, or without the
repository beside it, it exits non-zero at once.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
DTYPES = ("f32", "bf16", "int8", "int4")
N_SINGLE, N_BATCH, K = 16, 64, 10
# recall@10 floors (fused-scan, fused-batch) per scan dtype.  The reference
# holds its fused executors to exact recall at f32/bf16/int8 only; at int4
# with the default rerank_mult = 4 its own fused paths lose neighbours (the
# port returns the reference's ids there, also at D = 960:
# tests/test_torch_width.py), so int4 is held to exact returned distances
# and its recall is recorded.
RECALL_FLOORS = {"f32": (0.95, 0.99), "bf16": (0.95, 0.99),
                 "int8": (0.95, 0.99), "int4": None}

# H100 SXM published peaks (NVIDIA data sheet, dense, at the full 700 W):
# HBM3 bandwidth, and f32 on the SIMT cores (the kernels compute in IEEE
# f32; TF32 would change the function).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

K1_SOURCE = "src/repro_torch/kernels/csrc/pdx_scan.cu"
K1_REPLACES = "src/repro/kernels/pdx_scan.py:236"
K2_SOURCE = "src/repro_torch/kernels/csrc/batched_matmul.cu"
K2_REPLACES = "src/repro/kernels/batched_matmul.py:124"


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 10, warmup: int = 2) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    tb, to = nbytes / PEAK_BYTES_PER_S * 1e3, flops / PEAK_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def ptxas_summary(logs: dict) -> dict:
    """Max registers and total spill bytes per library from ``-Xptxas -v``."""
    import re

    out = {}
    for name, log in logs.items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", log)]
        spills = [int(a) + int(b) for a, b in re.findall(
            r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)]
        out[name] = {"kernels": len(regs), "max_registers": max(regs, default=0),
                     "spill_bytes": sum(spills)}
    return out


def ground_truth(torch, X, Q, k: int, chunk: int = 1 << 16):
    """Exact top-k ids by direct f32 differences, chunked over rows."""
    ids = []
    for q in Q:
        best_d = best_i = None
        for lo in range(0, X.shape[0], chunk):
            diff = X[lo:lo + chunk] - q[None, :]
            d = torch.sum(diff * diff, dim=1)
            dd, ii = torch.topk(d, min(k, d.shape[0]), largest=False)
            ii = ii + lo
            if best_d is None:
                best_d, best_i = dd, ii
            else:
                ad, ai = torch.cat([best_d, dd]), torch.cat([best_i, ii])
                dd, sel = torch.topk(ad, k, largest=False)
                best_d, best_i = dd, ai[sel]
        ids.append(best_i)
    return torch.stack(ids).cpu().numpy()


def dist_error(torch, X, Q, ids, dists) -> float:
    """Largest |returned - direct f32 distance| / direct over the returned
    ids (in the original space; the pruner's rotation preserves L2)."""
    ids_t = torch.from_numpy(ids.astype(np.int64)).to(X.device)
    vecs = X[ids_t]                                         # (B, k, D)
    diff = vecs - Q[:, None, :]
    true = torch.sum(diff * diff, dim=2)
    got = torch.from_numpy(dists).to(X.device)
    return float(((got - true).abs() / true.clamp(min=1e-6)).max())


def where_time_goes(torch, eng, Q, spec, dtype: str) -> dict:
    """Device time by kernel name under ``torch.profiler`` for the main
    path's two calls (16 single queries, one batch of 64), beside their
    host wall time: the device busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    out = {"phase": "where_time_goes", "scan_dtype": dtype}
    for label, run in (
        ("fused_scan_16_queries", lambda: [eng.search(Q[i], spec) for i in range(N_SINGLE)]),
        ("fused_batch_64", lambda: eng.search(Q, spec)),
    ):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only: a CPU op's device time repeats that of
        # the kernels it launched
        rows = [(e.key, e.self_device_time_total / 1e3, e.count)
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and e.self_device_time_total > 0]
        rows.sort(key=lambda r: -r[1])
        busy = sum(r[1] for r in rows)
        out[label] = {"wall_ms": wall * 1e3, "device_busy_ms": busy,
                      "device_idle_share": max(0.0, 1 - busy / (wall * 1e3)),
                      "top": [{"kernel": k[:80], "ms": ms, "calls": c}
                              for k, ms, c in rows[:8]]}
    return out


def k1_parity(torch, ref, m, ids, qt, thr, eps0, live):
    """K1 through its op against the plain version on the same card
    tensors: alive masks may differ only on lanes whose keep test came
    within 1e-4 relative of the bound; dists allclose where both keep a
    lane.  -> (ok, max abs err, mismatches, their largest margin, the plain
    walk's trace, the kernel's alive mask)."""
    from repro_torch.kernels.ops import pdx_prune_scan_multi_op

    sc = m.scale if m.quantized else None
    off = m.offset if m.quantized else None
    kd, ka = pdx_prune_scan_multi_op(m.data, ids, qt, thr, sc, off, eps0=eps0,
                                     packed=m.packed, dim=m.dim)
    pd_, pa, walk = ref.pdx_prune_scan_multi_ref(
        m.data, ids, qt, thr, d_tile=64, eps0=eps0, scale=sc, offset=off,
        packed=m.packed, dim=m.dim, trace=True)
    pa = pa != 0
    both = ka & pa & live
    mism = (ka != pa) & live
    n_mism = int(mism.sum())
    margin_max = float(walk.margin[mism].max()) if n_mism else 0.0
    err = float((kd - pd_).abs()[both].max()) if both.any() else 0.0
    ok = bool(torch.allclose(kd[both], pd_[both], rtol=1e-4, atol=1e-3)) and (
        margin_max < 1e-4)
    return ok, err, n_mism, margin_max, walk, ka


def recall(found, true) -> float:
    found, true = found.reshape(len(true), -1), true
    hits = sum(len(set(f.tolist()) & set(t.tolist())) for f, t in zip(found, true))
    return hits / true.size


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=960)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "__init__.py").exists():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.engine import SearchSpec, VectorSearchEngine
    from repro_torch.core.layout import device_mirror
    from repro_torch.core.topk import topk_from_batch, topk_threshold
    from repro_torch.core.distance import pdx_distance
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.batched_matmul import batched_distance_quant_cuda
    from repro_torch.kernels.ops import (
        _prep_multi, _unpack_int4_levels, batched_distance_quant_op,
    )
    from repro_torch.kernels.pdx_scan import pdx_prune_scan_multi_cuda
    from repro_torch.obs.meters import tile_widths

    dev = torch.device("cuda")
    smi = nvidia_smi()

    # ---------------------------------------------------------- 1. device
    t0 = time.perf_counter()
    build = _build.build_all()
    emit({"phase": "device", "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "device": torch.cuda.get_device_name(0),
          "build_s": build["seconds"], "built": build["built"],
          "ptxas": ptxas_summary(build["logs"]),
          "seconds": time.perf_counter() - t0})

    # ------------------------------------------------------- 2. main path
    t0 = time.perf_counter()
    X, Q = make_dataset(args.n, args.dim, "clustered", n_queries=N_BATCH,
                        seed=args.seed)
    t_data = time.perf_counter() - t0
    t1 = time.perf_counter()
    eng = VectorSearchEngine.build(X, index="ivf", pruner="adsampling",
                                   capacity=1024, seed=args.seed, device=dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t1
    Xd = torch.from_numpy(X).to(dev)
    Qd = torch.from_numpy(Q).to(dev)
    del X
    gt = ground_truth(torch, Xd, Qd, K)
    t2 = time.perf_counter()
    for dt in DTYPES:
        device_mirror(eng.store, dt)
    torch.cuda.synchronize()
    t_mirrors = time.perf_counter() - t2
    emit({"phase": "build", "n": args.n, "dim": args.dim, "seed": args.seed,
          "nlist": eng.ivf.nlist, "partitions": eng.store.num_partitions,
          "capacity": eng.store.capacity, "data_s": t_data, "engine_s": t_build,
          "mirrors_s": t_mirrors,
          "device_mem_gb": torch.cuda.memory_allocated() / 1e9,
          "seconds": time.perf_counter() - t0})

    specs = {dt: SearchSpec(k=K, scan_dtype=dt) for dt in DTYPES}
    for dt in DTYPES:  # warm the allocator and the libraries, uncounted
        eng.search(Q[0], specs[dt])
        eng.search(Q, specs[dt])
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    pdx_prune_scan_multi_cuda.launches = 0
    batched_distance_quant_cuda.launches = 0
    per_dtype = {}
    for dt in DTYPES:
        k1_before = pdx_prune_scan_multi_cuda.launches
        k2_before = batched_distance_quant_cuda.launches
        ts = time.perf_counter()
        singles = [eng.search(Q[i], specs[dt]) for i in range(N_SINGLE)]
        t_scan = time.perf_counter() - ts
        tb = time.perf_counter()
        batch = eng.search(Q, specs[dt])
        t_batch = time.perf_counter() - tb
        k1 = pdx_prune_scan_multi_cuda.launches - k1_before
        k2 = batched_distance_quant_cuda.launches - k2_before
        for r in singles:
            assert r.plan.executor == "fused-scan", r.plan
        assert batch.plan.executor == "fused-batch", batch.plan
        assert k1 == N_SINGLE, f"{dt}: K1 launched {k1} times for {N_SINGLE} queries"
        assert k2 >= 1, f"{dt}: K2 never launched by fused-batch"
        s_ids = np.stack([r.ids for r in singles])
        s_d = np.stack([r.dists for r in singles])
        r_scan = recall(s_ids, gt[:N_SINGLE])
        r_batch = recall(batch.ids, gt)
        err_scan = dist_error(torch, Xd, Qd[:N_SINGLE], s_ids, s_d)
        err_batch = dist_error(torch, Xd, Qd, batch.ids, batch.dists)
        per_dtype[dt] = {"k1": k1, "k2": k2}
        emit({"phase": "main_path", "scan_dtype": dt,
              "fused_scan_recall_at_10": r_scan,
              "fused_batch_recall_at_10": r_batch,
              "fused_scan_dist_rel_err": err_scan,
              "fused_batch_dist_rel_err": err_batch,
              "fused_scan_ms_per_query": t_scan / N_SINGLE * 1e3,
              "fused_batch_ms_per_batch_of_64": t_batch * 1e3,
              "k1_launches": k1, "k2_launches": k2})
        # re-ranked (and f32-scanned) distances are those of the ids returned
        assert max(err_scan, err_batch) <= 1e-3, f"{dt}: returned distances off"
        if RECALL_FLOORS[dt] is not None:
            f_scan, f_batch = RECALL_FLOORS[dt]
            assert r_scan >= f_scan, f"{dt}: fused-scan recall {r_scan}"
            assert r_batch >= f_batch, f"{dt}: fused-batch recall {r_batch}"
    emit({"phase": "main_path_done",
          "k1_launches": pdx_prune_scan_multi_cuda.launches,
          "k2_launches": batched_distance_quant_cuda.launches,
          "seconds": time.perf_counter() - t0})

    del Xd
    for dt in ("f32", "int8"):
        emit(where_time_goes(torch, eng, Q, specs[dt], dt))

    # ------------------------------------------- 3. kernels vs plain
    store, pruner = eng.store, eng.pruner
    P, D, C = store.data.shape
    eps0 = float(pruner.aux["eps0"])
    qt = pruner.transform_query(Qd[0])
    order, _ = eng.ivf.route(qt, 1, "l2")
    p0 = int(order[0])
    start = topk_from_batch(pdx_distance(store.data[p0], qt), store.ids[p0], K)
    thr = topk_threshold(start)
    ids_scan = store.ids.clone()
    ids_scan[p0] = -1
    live = ids_scan >= 0
    Qt = pruner.transform_batch(Qd)
    live_cols = (store.ids >= 0).reshape(-1)
    n_live = int(store.counts.sum())
    kernels = []
    for dt in DTYPES:
        m = device_mirror(store, dt)
        sc = m.scale if m.quantized else None
        off = m.offset if m.quantized else None

        # K1 ------------------------------------------------------------
        def k1_plain():
            return ref.pdx_prune_scan_multi_ref(
                m.data, ids_scan, qt, thr, d_tile=64, eps0=eps0, scale=sc,
                offset=off, packed=m.packed, dim=m.dim)

        ok1, err1, n_mism, margin_max, walk, ka = k1_parity(
            torch, ref, m, ids_scan, qt, thr, eps0, live)
        lanes = walk.lanes.cpu().numpy()
        parts = walk.parts.cpu().numpy()
        w = tile_widths(m.dim)
        # the main path's threshold kills most lanes in the first d-tiles
        # (at int4 all of them in the first); hold K1 also at thr = +inf and
        # at the 1 % quantile of the lanes' full distances, where lanes die
        # at every d-tile
        full, _ = ref.pdx_prune_scan_multi_ref(
            m.data, ids_scan, qt, float("inf"), d_tile=64, eps0=eps0, scale=sc,
            offset=off, packed=m.packed, dim=m.dim)
        full = full[live]
        extra = {}
        for tag, t in (("inf", float("inf")),
                       ("q1", torch.kthvalue(full, max(1, full.numel() // 100)).values)):
            okx, errx, nmx, mmx, walkx, _ = k1_parity(
                torch, ref, m, ids_scan, qt, t, eps0, live)
            extra[f"thr_{tag}"] = {
                "threshold": float(t), "parity": okx, "max_abs_err": errx,
                "alive_mismatches": nmx, "mismatch_margin_max": mmx,
                "lanes_per_tile": walkx.lanes.cpu().tolist()}
            assert okx, f"K1 {dt} disagrees with its plain version at thr {tag}"
        del full
        k1_bytes = (float((parts * w).sum()) * C * m.bytes_per_value
                    + P * C * (4 + 4 + 1) + 3 * D * 4)
        k1_flops = float((lanes * w).sum()) * (5 if m.quantized else 3)
        b1, by1 = bound_ms(k1_bytes, k1_flops)
        # time the kernel itself on the operands its wrapper prepares
        args, kwargs = _prep_multi(m.data, ids_scan, qt, thr, sc, off, eps0, 64,
                                   m.packed, m.dim)
        ms1 = cuda_ms(torch, lambda: pdx_prune_scan_multi_cuda(*args, **kwargs))
        plain1 = cuda_ms(torch, k1_plain)
        row1 = {"name": f"K1 pdx_prune_scan_multi [{dt}]", "route": "cuda",
                "source": K1_SOURCE, "replaces": K1_REPLACES,
                "launches": per_dtype[dt]["k1"], "max_abs_err": err1,
                "ms": ms1, "plain_ms": plain1, "bound_ms": b1, "bound_by": by1,
                "library_ms": None, "parity": ok1}
        emit({"phase": "kernel_vs_plain", **row1, "alive_mismatches": n_mism,
              "mismatch_margin_max": margin_max,
              "lanes_alive_after": int(ka.sum()),
              "tiles_streamed": float(parts.sum()), "bound_bytes": k1_bytes,
              "bound_flops": k1_flops, **extra})
        assert ok1, f"K1 {dt} disagrees with its plain version"
        kernels.append(row1)

        # K2 ------------------------------------------------------------
        kout = batched_distance_quant_op(m.data, Qt, sc, off, "l2",
                                         packed=m.packed, dim=m.dim)
        T32 = ref.dequantize_ref(m.data, sc, off, dim_axis=1, packed=m.packed,
                                 dim=m.dim)

        src = _unpack_int4_levels(m.data, m.dim) if m.packed else m.data

        def k2_plain():  # the op's CPU body, partition by partition
            return torch.cat([ref.batched_distance_quant_ref(t, Qt, sc, off)
                              for t in src], dim=1)

        pout = k2_plain()
        qn = torch.sum(Qt * Qt, dim=1)
        xn = torch.sum(T32 * T32, dim=1).reshape(-1)
        tol = 1e-5 * (qn[:, None] + xn[None, :]) + 1e-3
        diff = (kout - pout).abs()[:, live_cols]
        err2 = float(diff.max())
        ok2 = bool((diff <= tol[:, live_cols]).all())
        tiles = src.contiguous()
        sc2 = m.scale if m.quantized else torch.ones(D, device=dev)
        off2 = m.offset if m.quantized else torch.zeros(D, device=dev)
        ms2 = cuda_ms(torch, lambda: batched_distance_quant_cuda(
            tiles, Qt, qn, sc2, off2, metric="l2", quantized=m.quantized))
        plain2 = cuda_ms(torch, k2_plain)
        lib2 = cuda_ms(torch, lambda: torch.matmul(Qt, T32))
        # the search needs the live columns only: their tile values at the
        # mirror's width, the queries, (B, live) distances out; the product,
        # the column norms, the epilogue, and the dequant FMA where quantized
        k2_bytes = (n_live * D * m.bytes_per_value + Qt.numel() * 4
                    + N_BATCH * n_live * 4 + (2 * D * 4 if m.quantized else 0))
        k2_flops = n_live * (2.0 * N_BATCH * D + 2.0 * D + 3.0 * N_BATCH
                             + (2.0 * D if m.quantized else 0.0))
        b2, by2 = bound_ms(k2_bytes, k2_flops)
        row2 = {"name": f"K2 batched_distance_quant [{dt}]", "route": "cuda",
                "source": K2_SOURCE, "replaces": K2_REPLACES,
                "launches": per_dtype[dt]["k2"], "max_abs_err": err2,
                "ms": ms2, "plain_ms": plain2, "bound_ms": b2, "bound_by": by2,
                "library_ms": lib2, "parity": ok2}
        emit({"phase": "kernel_vs_plain", **row2,
              "library_call": "torch.matmul(Q, dequantized f32 tiles), cross term only",
              "bound_bytes": k2_bytes, "bound_flops": k2_flops,
              "live_columns": n_live, "columns_written": P * C})
        assert ok2, f"K2 {dt} disagrees with its plain version"
        kernels.append(row2)
        del T32, pout, kout, tiles, src

    # ----------------------------------------------------- 4. the record
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
