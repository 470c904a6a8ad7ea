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
     1024, k = 10; the data is drawn from ``--seed``, the rotation and
     k-means from ``--seed + 1``, so the two share no random draws.  For
     each scan dtype (f32, bf16, int8, int4): 16 single
     queries (``fused-scan``, one K1 launch each) and one batch of 64
     (``fused-batch``, K2), with the launch counters zeroed just before and
     read just after, the executors checked, returned distances checked
     against direct f32 distances of the returned ids, and recall@10
     against a ground truth computed on the card by direct f32
     differences (>= 0.95 for fused-scan, >= 0.99 for fused-batch at
     f32/bf16/int8; recorded at int4, see RECALL_FLOORS).
  3. cascade — the same engine through the multi-resolution cascade, for
     each ladder of LADDERS: 16 single queries (``cascade-scan``: K1 on the
     first stage, K3 on the second) and one batch of 64 (``cascade-batch``:
     K2 once per d-tile per stage), counters zeroed just before each and
     read just after, recall@10 >= 0.99 and returned distances exact for
     both, and equal ids on the queries both answer.  Survivors and bytes
     per stage come from the port's own counters.
  4. kernels vs plain — K1, K2 and K3 at every dtype on the engine's own
     mirror, real queries and threshold (K1 and K3 also at thr = +inf and
     at the 1 % quantile of the lanes' full distances, so that lanes die
     at every d-tile; K3's ids are a real previous stage's survivors);
     K1 at ladder A's projection stage (d_tile = rank, eps0 = 0); K2 per
     d-tile in each ``cascade-batch`` stage, on the arguments that stage
     passed on the counted path (also at +inf and the 1 % quantile) —
     against their plain PyTorch
     versions on the same card tensors, with CUDA-event medians of the
     kernel, the plain version and (K2) a library matmul, and the least
     time the card could take (bound).
     Before it, a ``torch.profiler`` breakdown of the main path's device
     time by kernel at f32 and int8, and of cascade ladder A (where the
     time goes).
  5. the kernels line: one JSON object per kernel and dtype.

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
K3_SOURCE = K1_SOURCE
K3_REPLACES = "src/repro/kernels/pdx_scan.py:366"

# cascade ladders: A is the reference's own benchmark ladder
# (benchmarks/bench_cascade.py), B a full-dimension one
LADDERS = {"A": ("proj32:int8", "int4", "f32"), "B": ("bf16", "int8", "f32")}
CASCADE_RECALL_FLOOR = 0.99


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


def where_time_goes(torch, eng, Q, spec, prefix: str, **tag) -> dict:
    """Device time by kernel name under ``torch.profiler`` for the path's
    two calls (16 single queries, one batch of 64), beside their host wall
    time: the device busy share and the top kernels."""
    from torch.profiler import ProfilerActivity, profile

    out = {"phase": "where_time_goes", **tag}
    for label, run in (
        (f"{prefix}_scan_16_queries", lambda: [eng.search(Q[i], spec) for i in range(N_SINGLE)]),
        (f"{prefix}_batch_64", lambda: eng.search(Q, spec)),
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


def scan_parity(torch, ref, m, ids, qt, thr, eps0, prefetch: bool = False,
                d_tile: int = 64):
    """K1 (or K3 with ``prefetch``) through its op against the plain
    version on the same card tensors: alive masks may differ only on lanes
    whose keep test came within 1e-4 relative of the bound, no lane with
    ids < 0 is alive, dists allclose where both keep a lane, and (K3)
    ``streamed`` equal on every partition whose masks agree.  -> (summary,
    the plain walk's trace, the kernel's alive mask)."""
    from repro_torch.kernels.ops import (
        pdx_prune_scan_multi_op, pdx_prune_scan_multi_prefetch_op,
    )

    sc = m.scale if m.quantized else None
    off = m.offset if m.quantized else None
    op = pdx_prune_scan_multi_prefetch_op if prefetch else pdx_prune_scan_multi_op
    plain = ref.pdx_prune_scan_multi_dskip_ref if prefetch else ref.pdx_prune_scan_multi_ref
    kern = op(m.data, ids, qt, thr, sc, off, eps0=eps0, d_tile=d_tile,
              packed=m.packed, dim=m.dim)
    *want, walk = plain(m.data, ids, qt, thr, d_tile=d_tile, eps0=eps0, scale=sc,
                        offset=off, packed=m.packed, dim=m.dim, trace=True)
    kd, ka, pd_, pa = kern[0], kern[1], want[0], want[1] != 0
    live = ids >= 0
    both = ka & pa & live
    mism = (ka != pa) & live
    n_mism = int(mism.sum())
    out = {"max_abs_err": float((kd - pd_).abs()[both].max()) if both.any() else 0.0,
           "alive_mismatches": n_mism,
           "mismatch_margin_max": float(walk.margin[mism].max()) if n_mism else 0.0}
    ok = (bool(torch.allclose(kd[both], pd_[both], rtol=1e-4, atol=1e-3))
          and out["mismatch_margin_max"] < 1e-4 and not bool(ka[~live].any()))
    if prefetch:
        agree = ~mism.any(dim=1)
        out["streamed_mismatches"] = int((kern[2] != want[2])[agree].sum())
        ok = ok and out["streamed_mismatches"] == 0
    return {"parity": ok, **out}, walk, ka


def scan_kernel_row(torch, ref, m, ids, qt, thr, eps0, *, prefetch: bool,
                    launches: int, d_tile: int = 64, tag: str = "",
                    **row_extra) -> dict:
    """K1 (or K3) on mirror ``m`` at ``d_tile``: held to its plain version
    at the path's threshold ``thr`` and, since a path's threshold may kill
    most lanes in the first d-tiles, also at +inf and at the 1 % quantile
    of the live lanes' full distances, where lanes die at every d-tile;
    CUDA-event medians of the kernel (on the operands its wrapper prepares)
    and of the plain version; the bound.  ``tag`` names the row (the mirror
    dtype by default).  Emits the phase line, returns the row."""
    from repro_torch.kernels.ops import _prep_multi
    from repro_torch.kernels.pdx_scan import (
        pdx_prune_scan_multi_cuda, pdx_prune_scan_multi_prefetch_cuda,
    )
    from repro_torch.obs.meters import tile_widths

    sc = m.scale if m.quantized else None
    off = m.offset if m.quantized else None
    plain_fn = ref.pdx_prune_scan_multi_dskip_ref if prefetch else ref.pdx_prune_scan_multi_ref

    def plain(t=thr):
        return plain_fn(m.data, ids, qt, t, d_tile=d_tile, eps0=eps0, scale=sc,
                        offset=off, packed=m.packed, dim=m.dim)

    name = "K3 pdx_prune_scan_multi_prefetch" if prefetch else "K1 pdx_prune_scan_multi"
    name = f"{name} [{tag or m.dtype}]"
    summary, walk, ka = scan_parity(torch, ref, m, ids, qt, thr, eps0, prefetch, d_tile)
    live = ids >= 0
    full = plain(float("inf"))[0][live]
    extra = {}
    for label, t in (("inf", float("inf")),
                     ("q1", torch.kthvalue(full, max(1, full.numel() // 100)).values)):
        sx, walkx, _ = scan_parity(torch, ref, m, ids, qt, t, eps0, prefetch, d_tile)
        extra[f"thr_{label}"] = {"threshold": float(t), **sx,
                                 "lanes_per_tile": walkx.lanes.cpu().tolist()}
        assert sx["parity"], f"{name} disagrees with its plain version at thr {label}"
    del full
    P, _, C = m.data.shape
    lanes = walk.lanes.cpu().numpy()
    parts = walk.parts.cpu().numpy()
    w = tile_widths(m.dim, d_tile)
    # the tiles of the partitions still alive entering each d-tile, at the
    # mirror's width; ids in, dists and alive (and K3's streamed) out;
    # q/scale/offset; the operations of the lanes alive entering each tile
    nbytes = (float((parts * w).sum()) * C * m.bytes_per_value
              + P * C * (4 + 4 + 1) + (P * 4 if prefetch else 0) + 3 * m.dim * 4)
    flops = float((lanes * w).sum()) * (5 if m.quantized else 3)
    b, by = bound_ms(nbytes, flops)
    args, kwargs = _prep_multi(m.data, ids, qt, thr, sc, off, eps0, d_tile, m.packed,
                               m.dim)
    kern = pdx_prune_scan_multi_prefetch_cuda if prefetch else pdx_prune_scan_multi_cuda
    ms = cuda_ms(torch, lambda: kern(*args, **kwargs))
    plain_ms = cuda_ms(torch, plain)
    row = {"name": name, "route": "cuda",
           "source": K3_SOURCE if prefetch else K1_SOURCE,
           "replaces": K3_REPLACES if prefetch else K1_REPLACES,
           "launches": launches, "max_abs_err": summary["max_abs_err"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
           "library_ms": None, "parity": summary["parity"], **row_extra}
    emit({"phase": "kernel_vs_plain", **summary, **row, "threshold": float(thr),
          "d_tile": d_tile, "eps0": eps0, "lanes_entering": int(live.sum()),
          "partitions_entering": int(live.any(dim=1).sum()),
          "lanes_alive_after": int(ka.sum()), "tiles_streamed": float(parts.sum()),
          "bound_bytes": nbytes, "bound_flops": flops, **extra})
    assert summary["parity"], f"{name} disagrees with its plain version"
    return row


def stage_kernel_row(torch, ref, call: dict, ladder: str, stage: str) -> dict:
    """K2 per d-tile through ``batched_cascade_stage_op`` on the arguments a
    ``cascade-batch`` stage passed it on the path (compacted union columns
    at their real width S, the batch's entry alive and thresholds), held to
    the plain stage (``ref.batched_cascade_stage_ref``, the plain K2 per
    tile) at the path's thresholds, at +inf and at each query's 1 %
    quantile of its entering lanes' full distances.  Tolerance: K2's own
    per tile, ``|kernel - plain| <= 1e-5 * (||q||^2 + ||x^||^2) + 1e-3`` per
    d-tile summed over the tiles; alive masks may differ only on pairs
    whose keep test came within 1e-4 relative, or within that tolerance
    (times D / d_tile), of the bound.  Emits the phase line, returns the
    row."""
    from repro_torch.kernels.ops import _unpack_int4_levels, batched_cascade_stage_op
    from repro_torch.obs.meters import tile_widths

    T, alive, Qs, thr, sc, off = call["args"]
    kw = call["kwargs"]
    eps0, d_tile, packed, D = kw["eps0"], kw["d_tile"], kw["packed"], kw["dim"]
    B, S = alive.shape
    w = tile_widths(D, d_tile)
    levels = _unpack_int4_levels(T, D) if packed else T
    xn = torch.zeros(S, device=T.device)
    for lo in range(0, D, d_tile):
        hi = min(lo + d_tile, D)
        t = ref.dequantize_ref(levels[lo:hi], sc[lo:hi] if sc is not None else None,
                               off[lo:hi] if off is not None else None)
        xn += torch.sum(t * t, dim=0)
    del levels, t
    tol = 1e-5 * (torch.sum(Qs * Qs, dim=1)[:, None] + xn[None, :]) + 1e-3 * len(w)
    # the least bound over the tiles is the last tile's (eps0 >= 0), and an
    # acc error e moves acc * ratio by at most e * D / (first tile's width)
    slack_scale = float(D / w[0]) / ref._inflation(eps0, D)
    name = f"K2 batched_distance_quant in cascade stage [{ladder} {stage}]"

    def kernel(t):
        return batched_cascade_stage_op(T, alive, Qs, t, sc, off, **kw)

    def plain(t, trace=False):
        return ref.batched_cascade_stage_ref(T, alive, Qs, t, sc, off, trace=trace, **kw)

    def parity(t):
        kd, ka = kernel(t)
        pd_, pa, walk = plain(t, trace=True)
        pa = pa != 0
        mism = (ka != pa) & alive
        slack = torch.clamp(tol * slack_scale / t[:, None], min=1e-4)
        n_mism = int(mism.sum())
        both = ka & pa
        diff = (kd - pd_).abs()
        out = {"max_abs_err": float(diff[both].max()) if both.any() else 0.0,
               "alive_mismatches": n_mism,
               "mismatch_margin_max": float(walk.margin[mism].max()) if n_mism else 0.0,
               "mismatches_beyond_slack": int((mism & (walk.margin >= slack)).sum())}
        ok = (bool((diff <= tol)[both].all()) and out["mismatches_beyond_slack"] == 0
              and not bool(ka[~alive].any()))
        return {"parity": ok, **out}, walk

    summary, walk = parity(thr)
    full = torch.where(alive, plain(torch.full_like(thr, float("inf")))[0], float("inf"))
    n_in = alive.sum(dim=1)
    kth = torch.clamp(n_in // 100, min=1) - 1
    q1 = torch.sort(full, dim=1).values.gather(1, kth[:, None])[:, 0]
    del full
    extra = {}
    for label, t in (("inf", torch.full_like(thr, float("inf"))), ("q1", q1)):
        sx, walkx = parity(t)
        extra[f"thr_{label}"] = {**sx, "pairs_per_tile": walkx.lanes.cpu().tolist()}
        assert sx["parity"], f"{name} disagrees with its plain version at thr {label}"
    lanes = walk.lanes.cpu().numpy()
    parts = walk.parts.cpu().numpy()
    quantized = sc is not None
    bpv = 0.5 if packed else T.element_size()
    # the columns any query keeps entering each d-tile at the mirror's
    # width; entry alive, queries, thresholds, dequant vectors in; dists and
    # alive out.  Operations: the cross term of the pairs alive entering
    # each tile, its epilogue, accumulate and keep test (2w + 7 a pair), and
    # each entering column's norm and dequant
    nbytes = (float((parts * w).sum()) * bpv + B * S * (1 + 4 + 1) + Qs.numel() * 4
              + B * 4 + (2 * D * 4 if quantized else 0))
    flops = (float((lanes * (2.0 * w + 7)).sum())
             + float(parts[0]) * D * (4.0 if quantized else 2.0))
    b, by = bound_ms(nbytes, flops)
    ms = cuda_ms(torch, lambda: kernel(thr))
    plain_ms = cuda_ms(torch, lambda: plain(thr))
    row = {"name": name, "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
           "launches": call["k2_launches"], "max_abs_err": summary["max_abs_err"],
           "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": by,
           "library_ms": None, "parity": summary["parity"]}
    emit({"phase": "kernel_vs_plain", **summary, **row,
          "library_call": None, "batch": B, "columns": S,
          "columns_entering": int(parts[0]), "pairs_entering": int(alive.sum()),
          "pairs_per_tile": lanes.tolist(), "columns_per_tile": parts.tolist(),
          "d_tile": d_tile, "eps0": eps0, "bound_bytes": nbytes, "bound_flops": flops,
          **extra})
    assert summary["parity"], f"{name} disagrees with its plain version"
    return row


class StageRecorder:
    """Stands in for ``ops.batched_cascade_stage_op`` while a
    ``cascade-batch`` run is counted: calls the op, keeps each stage's
    arguments and the K2 launches the call made."""

    def __init__(self, ops, k2):
        self.ops, self.k2, self.calls = ops, k2, []
        self.op = ops.batched_cascade_stage_op

    def __call__(self, *args, **kwargs):
        n0 = self.k2.launches
        out = self.op(*args, **kwargs)
        self.calls.append({"args": args, "kwargs": kwargs,
                           "k2_launches": self.k2.launches - n0})
        return out

    def __enter__(self):
        self.ops.batched_cascade_stage_op = self
        return self

    def __exit__(self, *exc):
        self.ops.batched_cascade_stage_op = self.op
        return False


def cascade_ladder(torch, eng, Q, Xd, Qd, gt, name: str, ladder: tuple,
                   counters: dict) -> tuple[dict, list]:
    """Drive one cascade ladder through both executors with the launch
    counters zeroed just before each run and read just after; assert the
    executors, launch counts, recall, returned distances and equal ids of
    the two executors; report survivors, bytes and re-rank width per stage
    from the port's own counters.  -> (the phase line, the arguments and
    K2 launches of each ``cascade-batch`` stage)."""
    import contextlib

    from repro_torch.core.engine import SearchSpec
    from repro_torch.core.spec import parse_cascade_stage
    from repro_torch.kernels import ops
    from repro_torch.obs import metrics

    spec = SearchSpec(k=K, cascade=ladder)
    eng.search(Q[0], spec)  # warm the allocator and the libraries, uncounted
    eng.search(Q, spec)
    torch.cuda.synchronize()
    stages = [parse_cascade_stage(s) for s in ladder][:-1]
    D = eng.store.dim
    # K2 runs once per d-tile of each stage: one tile on a projection
    # (d_tile = rank), ceil(D / 64) on a full-dimension stage
    k2_tiles = sum(1 if kind == "proj" else -(-D // 64) for kind, _, _ in stages)
    out = {"phase": "cascade", "ladder": name, "stages": list(ladder)}
    reg = metrics.get_registry()
    results = {}
    metrics.set_enabled(True)
    try:
        for executor, n_q, want in (
            ("cascade-scan", N_SINGLE, {"k1": N_SINGLE, "k3": N_SINGLE, "k2": 0}),
            ("cascade-batch", N_BATCH, {"k1": 0, "k3": 0, "k2": k2_tiles}),
        ):
            batch = executor == "cascade-batch"
            with (StageRecorder(ops, counters["k2"]) if batch
                  else contextlib.nullcontext()) as rec:
                reg.reset()
                for c in counters.values():
                    c.launches = 0
                t0 = time.perf_counter()
                if batch:
                    res = [eng.search(Q, spec)]
                else:
                    res = [eng.search(Q[i], spec) for i in range(N_SINGLE)]
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                got = {k: c.launches for k, c in counters.items()}
            if batch:
                stage_calls = rec.calls
                assert len(stage_calls) == len(stages), stage_calls
            for r in res:
                assert r.plan.executor == executor, r.plan
            assert got == want, f"ladder {name} {executor}: launches {got}, want {want}"
            ids = np.stack([r.ids for r in res]).reshape(n_q, K)
            dists = np.stack([r.dists for r in res]).reshape(n_q, K)
            rec = recall(ids, gt[:n_q])
            err = dist_error(torch, Xd, Qd[:n_q], ids, dists)
            tag = executor.replace("-", "_")
            rerank = reg.get("repro_device_bytes_total", executor=executor,
                             component="rerank", dtype="f32")
            out[tag] = {
                "recall_at_10": rec, "dist_rel_err": err,
                ("ms_per_query" if n_q == N_SINGLE else "ms_per_batch_of_64"):
                    wall * 1e3 / (N_SINGLE if n_q == N_SINGLE else 1),
                "launches": got,
                "survivors_per_query": [
                    reg.get("repro_cascade_stage_survivors", stage=str(si),
                            stage_name=ladder[si]) / n_q for si in range(len(stages))],
                "stage_bytes_per_query": [
                    reg.get("repro_cascade_stage_bytes", stage=str(si),
                            stage_name=ladder[si]) / n_q for si in range(len(stages))],
                "rk_eff_mean": rerank / (D * 4 * n_q),
            }
            results[executor] = ids
            assert err <= 1e-3, f"ladder {name} {executor}: returned distances off by {err}"
            assert rec >= CASCADE_RECALL_FLOOR, f"ladder {name} {executor}: recall {rec}"
    finally:
        metrics.set_enabled(False)
        reg.reset()
    same = np.array_equal(results["cascade-batch"][:N_SINGLE], results["cascade-scan"])
    out["batch_ids_equal_scan_ids"] = same
    assert same, f"ladder {name}: cascade-batch ids differ from cascade-scan's"
    out["cascade_batch"]["k2_launches_per_stage"] = [c["k2_launches"] for c in stage_calls]
    return out, stage_calls


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
    from repro_torch.core.layout import device_mirror, projection_mirror
    from repro_torch.core.plan import _inflate, _quant_err_norm
    from repro_torch.core.topk import topk_from_batch, topk_threshold
    from repro_torch.core.distance import pdx_distance
    from repro_torch.data.synthetic import make_dataset
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels.batched_matmul import batched_distance_quant_cuda
    from repro_torch.kernels.ops import (
        _unpack_int4_levels, batched_distance_quant_op, pdx_prune_scan_multi_op,
    )
    from repro_torch.kernels.pdx_scan import (
        pdx_prune_scan_multi_cuda, pdx_prune_scan_multi_prefetch_cuda,
    )

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
    # the rotation and k-means draw from their own seed: seeded like the
    # data, their first standard_normal draws would be the cluster centres'
    engine_seed = args.seed + 1
    eng = VectorSearchEngine.build(X, index="ivf", pruner="adsampling",
                                   capacity=1024, seed=engine_seed, device=dev)
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
    emit({"phase": "build", "n": args.n, "dim": args.dim,
          "data_seed": args.seed, "engine_seed": engine_seed,
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

    # --------------------------------------------------------- 3. cascade
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    pm = projection_mirror(eng.store, 32, "int8")  # ladder A's first stage
    torch.cuda.synchronize()
    t_proj = time.perf_counter() - t0
    counters = {"k1": pdx_prune_scan_multi_cuda,
                "k3": pdx_prune_scan_multi_prefetch_cuda,
                "k2": batched_distance_quant_cuda}
    # launches on the cascade path: K1 by first stage (a dtype, or ladder
    # A's projection), K3 by second-stage dtype, K2 by stage
    k1_cascade = {}
    k3_path_launches = {dt: 0 for dt in DTYPES}
    stage_calls = {}
    for name, ladder in LADDERS.items():
        row, calls = cascade_ladder(torch, eng, Q, Xd, Qd, gt, name, ladder, counters)
        if name == "A":
            row["projection_mirror_build_s"] = t_proj
        emit(row)
        launched = row["cascade_scan"]["launches"]
        k1_cascade[ladder[0]] = k1_cascade.get(ladder[0], 0) + launched["k1"]
        k3_path_launches[ladder[1]] += launched["k3"]
        for stage, call in zip(ladder, calls):
            stage_calls[(name, stage)] = call
    emit({"phase": "cascade_done", "k1_launches": k1_cascade,
          "k3_launches": k3_path_launches,
          "k2_launches_per_stage": {f"{a} {s}": c["k2_launches"]
                                    for (a, s), c in stage_calls.items()},
          "seconds": time.perf_counter() - t0})

    del Xd
    for dt in ("f32", "int8"):
        emit(where_time_goes(torch, eng, Q, specs[dt], "fused", scan_dtype=dt))
    emit(where_time_goes(torch, eng, Q, SearchSpec(k=K, cascade=LADDERS["A"]),
                         "cascade", cascade=list(LADDERS["A"])))

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
    Qt = pruner.transform_batch(Qd)
    live_cols = (store.ids >= 0).reshape(-1)
    n_live = int(store.counts.sum())
    kernels = []
    for dt in DTYPES:
        m = device_mirror(store, dt)
        sc = m.scale if m.quantized else None
        off = m.offset if m.quantized else None

        by_executor = {"fused-scan": per_dtype[dt]["k1"],
                       "cascade-scan": k1_cascade.get(dt, 0)}
        kernels.append(scan_kernel_row(torch, ref, m, ids_scan, qt, thr, eps0,
                                       prefetch=False, launches=sum(by_executor.values()),
                                       launches_by_executor=by_executor))

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

    # K3 ----------------------------------------------------------------
    # its ids are the survivors of a real previous stage: ladder A's
    # projection stage (K1 at d_tile = rank, eps0 = 0) for the first query
    # that has any, so entry-dead partitions are present
    for i in range(N_SINGLE):
        qt3 = pruner.transform_query(Qd[i])
        p3 = int(eng.ivf.route(qt3, 1, "l2")[0][0])
        thr3 = topk_threshold(topk_from_batch(
            pdx_distance(store.data[p3], qt3), store.ids[p3], K))
        ids3 = store.ids.clone()
        ids3[p3] = -1
        qp3, thr_p = qt3 @ pm.components, _inflate(thr3, _quant_err_norm(pm))
        _, alive0 = pdx_prune_scan_multi_op(
            pm.data, ids3, qp3, thr_p, pm.scale, pm.offset, eps0=0.0,
            d_tile=pm.rank, dim=pm.dim)
        if bool(alive0.any()):
            break
    # K1 at ladder A's first stage: the int8 projection mirror, one test at
    # d = rank with eps 0 and the inflated threshold
    kernels.append(scan_kernel_row(
        torch, ref, pm, ids3, qp3, thr_p, 0.0, prefetch=False, d_tile=pm.rank,
        tag=LADDERS["A"][0], launches=k1_cascade[LADDERS["A"][0]],
        launches_by_executor={"cascade-scan": k1_cascade[LADDERS["A"][0]]}))
    ids_k3 = torch.where(alive0, ids3, -1)
    live3 = ids_k3 >= 0
    assert bool(live3.any()), "no query keeps a lane through the projection stage"
    # a row's launches: K3 on the cascade path at that dtype (the path runs
    # it at int4 and int8 only; the f32 and bf16 rows are held off the path)
    for dt in DTYPES:
        m = device_mirror(store, dt)
        thr_m = _inflate(thr3, _quant_err_norm(m))  # the cascade's own threshold
        kernels.append(scan_kernel_row(
            torch, ref, m, ids_k3, qt3, thr_m, eps0, prefetch=True,
            launches=k3_path_launches[dt], on_path=k3_path_launches[dt] > 0))

    # K2 per d-tile in cascade-batch, on each stage's compacted columns
    for (name, stage), call in stage_calls.items():
        kernels.append(stage_kernel_row(torch, ref, call, name, stage))
    del stage_calls

    # ----------------------------------------------------- 4. the record
    emit({"kernels": kernels})
    print(nvidia_smi(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
