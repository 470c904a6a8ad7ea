#!/usr/bin/env python3
"""Compare the kernel rows and the tiered phases of ``chip_smoke.py`` runs.

    python tools/compare_runs.py --parent p1.txt p2.txt --change c1.txt c2.txt

Each file is one run's standard output.  Prints, for every kernel row of
the change's ``{"kernels": [...]}`` line, its ``ms`` in each run and the
ratio of the change's mean over the parent's (rows the parent lacks show
the change's times alone), then each change run's ``tiered`` and
``tiered_tree`` phases: walls, hits, bytes and recall per scan dtype.
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


if __name__ == "__main__":
    main()
