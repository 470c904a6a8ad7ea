#!/usr/bin/env python3
"""What holds rank 0's peak in a dry-run cell: the largest live storages
at the moment the live bytes reach their high-water mark, each with the
shape, the ATen op and the model lines that made it.

    PYTHONPATH=src python tools/dryrun_peak.py --arch deepseek-v3-671b \\
        --shape train_4k [--mesh single_pod] [--top 12]

It runs ``repro_torch.launch.dryrun.run_cell`` (meta tensors over a
``fake`` process group, no card) with ``analysis.memory_trace``'s tracker
wrapped, so the cell's record is the one the dry-run writes, and prints
the peak twice: over the ops that run inside the model's code (forward
and remat's recompute) and over those autograd's engine runs with no
model frame (the backward).  Then the largest storage that each model
line made over the whole run (which heads a rank's attention blocks and
mixer products carry, whether or not they hold the peak), keyed by the
innermost model line and its caller.  The wrapper
walks the Python stack at every tracked storage, so a cell takes several
times its plain meta run.
"""
from __future__ import annotations

import argparse
import sys
import traceback


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single_pod", choices=["single_pod", "multi_pod"])
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args(argv)

    from repro_torch.launch import analysis, dryrun

    made = {}  # id of storage -> (shape, op, model lines)
    peak = {"forward": (0.0, []), "backward": (0.0, [])}
    by_line = {}  # innermost two model lines -> (bytes, shape, op) of its largest storage
    track = analysis._Trace._track

    def tracked(self, t):
        key = id(t.untyped_storage())
        if key in self._seen:  # an argument's or a live storage: no new bytes
            return
        op = sys._getframe(1).f_locals.get("func")
        lines = [f"{f.filename.split('src/')[-1]}:{f.lineno}"
                 for f in traceback.extract_stack()
                 if "repro_torch/models" in f.filename or "repro_torch/dist" in f.filename]
        made[key] = (tuple(t.shape), str(op), lines[-3:])
        n, at = t.untyped_storage().nbytes(), " < ".join(reversed(lines[-2:]))
        if lines and n > by_line.get(at, (0,))[0]:
            by_line[at] = (n, tuple(t.shape), str(op))
        track(self, t)
        phase = "forward" if made[key][2] else "backward"
        if self.live > peak[phase][0]:
            live = sorted(((r().nbytes(), k) for k, r in self._refs.items()
                           if r() is not None), reverse=True)
            peak[phase] = (self.live, [(n, made.get(k)) for n, k in live[:args.top]])

    analysis._Trace._track = tracked
    rec = dryrun.run_cell(args.arch, args.shape, args.mesh, "")
    if rec["status"] != "ok":
        raise SystemExit(f"the cell failed: {rec.get('error')}")
    print(f"record peak {rec['memory']['peak_memory_in_bytes']:.6g} B, "
          f"arguments {rec['memory']['argument_size_in_bytes']:.6g} B")
    for phase, (live, top) in peak.items():
        print(f"{phase} peak {live:.6g} B; largest live storages:")
        for n, (shape, op, lines) in top:
            print(f"  {n:.4g} B  {shape}  {op}  {' < '.join(reversed(lines))}")
    print("largest storage by model line (and its caller):")
    for line, (n, shape, op) in sorted(by_line.items(), key=lambda kv: -kv[1][0])[:args.top]:
        print(f"  {n:.4g} B  {shape}  {op}  {line}")


if __name__ == "__main__":
    main()
