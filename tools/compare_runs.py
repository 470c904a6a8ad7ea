#!/usr/bin/env python3
"""Compare the kernel rows and the tiered phases of ``chip_smoke.py`` runs.

    python tools/compare_runs.py --parent p1.txt p2.txt --change c1.txt c2.txt

Each file is one run's standard output.  Prints, for every kernel row of
the change's ``{"kernels": [...]}`` line, its ``ms`` in each run and the
ratio of the change's mean over the parent's (rows the parent lacks show
the change's times alone), then each change run's ``tiered`` and
``tiered_tree`` phases: walls, hits, bytes and recall per scan dtype, and
its ``serve`` and ``serve_churn`` phases: QPS, latency, recall, idle share,
upload overlap and swaps, its ``lm`` and ``rag`` phases with their
profiles' busy and idle time, its ``train``, ``train_2l`` and
``train_reduced`` phases, its ``families`` lines (one per model: times,
bounds, holds, the MoE and MLA records, the decode profile's busy and
idle time), its ``mesh_lm`` phase (its holds, walls and a sharded decode
step's profile), and its ``routing``, ``sharded`` and ``routed`` phases
and the ``fused_scan_wall`` medians, in each run given (parent runs too).
"""
from __future__ import annotations

import argparse
import json
import statistics


def lines(path: str) -> list[dict]:
    return [json.loads(line) for line in open(path) if line.startswith("{")]


def kernel_rows(run: list[dict]) -> dict:
    return next({k["name"]: k for k in line["kernels"]} for line in run if "kernels" in line)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", nargs="*", default=[])
    ap.add_argument("--change", nargs="+")
    args = ap.parse_args()
    parent = [kernel_rows(lines(p)) for p in args.parent]
    runs = [lines(c) for c in args.change]
    change = [kernel_rows(r) for r in runs]
    for name in change[0]:
        c = [rows[name]["ms"] for rows in change]
        p = [rows[name]["ms"] for rows in parent if name in rows]
        ratio = f"{statistics.mean(c) / statistics.mean(p):.3f}" if p else "-"
        print(f"{name[:64]:64s} parent {p} change {c} c/p {ratio}")
    for path in args.parent + args.change:
        for line in lines(path):
            if line.get("phase") in ("routing", "sharded"):
                print(path, line["phase"], {k: v for k, v in line.items() if k != "phase"})
            elif line.get("phase") == "routed":
                print(path, "routed", {k: v for k, v in line.items()
                                       if k not in ("phase", "routed_tiered")})
                for dt, rec in line["routed_tiered"].items():
                    print("    routed_tiered", dt, {k: v for k, v in rec.items()
                                                    if k != "walls_ms"})
            elif line.get("phase") == "fused_scan_wall":
                print(path, "fused_scan_wall median ms",
                      {dt: rec.get("ms_per_query_median") for dt, rec in line.items()
                       if isinstance(rec, dict)})
    for path, run in zip(args.change, runs):
        for line in run:
            if line.get("phase") == "tiered":
                print(path, line["scan_dtype"], {
                    k: line[k] for k in ("recall_at_10_routed", "dist_rel_err",
                                         "ids_equal_full_pool", "quant_params_s",
                                         "host_quantize_s_cold", "upload_overlap_ratio")})
                for tag in ("cold", "warm", "sync_cold"):
                    rec = line[tag]
                    print("   ", tag, {k: rec[k] for k in (
                        "wall_ms_median", "hits", "misses", "evictions", "uploaded_slots",
                        "hit_rate", "h2d_bytes")}, "first batch ms", rec["wall_ms_per_batch"][0])
            elif line.get("phase") == "tiered_tree":
                print(path, "tree", line)
            elif line.get("phase") == "serve" and line["path"] == "main":
                for dt in ("f32", "int8"):
                    rec = line[dt]
                    print(path, "serve", dt, "serial qps", line["serial_qps"][dt], {
                        k: rec[k] for k in ("qps", "qps_over_serial", "p50_ms", "p99_ms",
                                            "p99_over_p50", "recall_at_10", "profile",
                                            "batches_per_bucket", "queue_wait_ms_p50",
                                            "plan_ms_mean", "run_ms_per_bucket")})
                print(path, "serve cascade", {k: v for k, v in line["cascade"].items()
                                              if k not in ("ladder", "fill_per_bucket")})
                print(path, "serve setups", line["setups_after_warmup"], "new segments",
                      line["new_allocator_segments_after_warmup"])
            elif line.get("phase") == "serve" and line["path"] == "tiered":
                print(path, "serve tiered", {k: line[k] for k in (
                    "serial_qps", "qps", "p50_ms", "p99_ms", "plan_ms_mean",
                    "run_ms_per_bucket", "batches_per_bucket", "served",
                    "blocking_batches_of_16", "recall_at_10_routed")})
            elif line.get("phase") == "serve_churn":
                print(path, "serve_churn", {k: line.get(k) for k in (
                    "qps", "p50_ms", "p99_ms", "p99_ms_during_swap", "queries_during_swap",
                    "clone_s", "repack_s", "swaps_adopted", "swaps_discarded",
                    "rows_replayed", "first_batch_after_swap_ms", "recall_at_10",
                    "setups_after_warmup_by_kind", "self_rank0", "deleted_ids_returned")})
            elif line.get("phase") == "families":
                print(path, "families", line["arch"], {k: v for k, v in line.items() if k not in (
                    "phase", "arch", "decode_profile", "first_row", "moe", "mla")})
                if "moe" in line:
                    print("    moe", {k: v for k, v in line["moe"].items()
                                     if k not in ("drops_prefill_by_layer",
                                                  "active_experts_decode")})
                if "mla" in line:
                    print("    mla", line["mla"])
                prof = line["decode_profile"]
                print("    decode_profile", {f: prof[f] for f in (
                    "wall_ms", "device_busy_ms", "device_idle_share")},
                    [(t["kernel"][:40], round(t["ms"], 3)) for t in prof["top"][:4]])
            elif line.get("phase") in ("lm", "rag"):
                print(path, line["phase"], {k: v for k, v in line.items()
                                            if k != "phase" and not k.endswith("profile")})
                for k, prof in line.items():
                    if k.endswith("profile"):
                        print("   ", k, {f: prof[f] for f in ("wall_ms", "device_busy_ms",
                                                              "device_idle_share")},
                              [(t["kernel"][:40], round(t["ms"], 3)) for t in prof["top"][:4]])
            elif line.get("phase") == "train":
                print(path, "train", {k: v for k, v in line.items() if k not in (
                    "phase", "profiled_step", "step_ms", "opt_ms", "grad_norms")})
                prof = line["profiled_step"]
                print("    profiled_step", {f: prof[f] for f in (
                    "wall_ms", "device_busy_ms", "device_idle_share")},
                    [(t["kernel"][:40], round(t["ms"], 3)) for t in prof["top"][:4]])
            elif line.get("phase") in ("train_2l", "train_reduced"):
                print(path, line["phase"], {k: v for k, v in line.items() if k != "phase"})
            elif line.get("phase") == "mesh_lm":
                for part in ("train", "restore", "pipeline"):
                    print(path, "mesh_lm", part, line[part])
                serve = line["serve"]
                print(path, "mesh_lm serve", {k: v for k, v in serve.items()
                                              if k not in ("first_row", "decode_profile")})
                prof = serve["decode_profile"]
                print("    decode_profile", {f: prof[f] for f in (
                    "wall_ms", "device_busy_ms", "device_idle_share")},
                    [(t["kernel"][:40], round(t["ms"], 3)) for t in prof["top"][:4]])
            elif line.get("phase", "").endswith("_done") and "seconds" in line:
                print(path, line["phase"], line["seconds"])


if __name__ == "__main__":
    main()
