"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``repro.kernels``.  ``csrc/*.cu`` are the kernels (built at
first use by ``_build``); ``pdx_scan.py``, ``nary_scan.py`` and
``batched_matmul.py`` bind them; ``ops.py`` are the public wrappers that
pad operands and dispatch by device (CPU tensors run ``ref.py``'s plain
versions, CUDA tensors the kernels); ``ref.py`` holds the plain versions
every kernel is held to.

  K1  ``pdx_scan.pdx_prune_scan_multi_cuda`` — whole-store fused L2 scan
      with the ADSampling test per d-tile (replaces
      ``repro.kernels.pdx_scan.pdx_prune_scan_multi_pallas``); behind the
      ``fused-scan`` executor.
  K2  ``batched_matmul.batched_distance_quant_cuda`` — batched
      query-vs-tile distances with in-register dequantization (replaces
      ``repro.kernels.batched_matmul.batched_distance_quant_pallas``);
      behind the ``fused-batch`` executor and, once per d-tile, the
      ``cascade-batch`` stages.
  K3  ``pdx_scan.pdx_prune_scan_multi_prefetch_cuda`` — K1 for the later
      cascade stages, a partition that enters dead fetching nothing
      (replaces ``pdx_prune_scan_multi_prefetch_pallas``); behind
      ``cascade-scan``.
  K4  ``pdx_scan.pdx_distance_cuda`` — the paper's PDX kernel, a plain
      (D, V) distance scan (l2, ip, l1; replaces ``pdx_distance_pallas``).
  K5  ``nary_scan.nary_distance_cuda`` — the paper's N-ary baseline, a
      horizontal (N, D) scan (replaces
      ``repro.kernels.nary_scan.nary_distance_pallas``).
  K6  ``pdx_scan.pdx_prune_scan_cuda`` — one partition's fused L2 scan with
      the ADSampling test per d-tile (replaces ``pdx_prune_scan_pallas``).
  K7  ``batched_matmul.batched_distance_cuda`` — the f32/bf16 batch
      distance product with the norms given (replaces
      ``batched_distance_pallas``).

K4-K7 are the reference's public kernel API and run on no executor: only
their ops (below) reach them.
"""
from .ops import (
    batched_distance_op,
    batched_distance_quant_op,
    nary_distance_op,
    pdx_distance_op,
    pdx_prune_scan_multi_op,
    pdx_prune_scan_op,
)

__all__ = [
    "pdx_distance_op",
    "nary_distance_op",
    "batched_distance_op",
    "batched_distance_quant_op",
    "pdx_prune_scan_op",
    "pdx_prune_scan_multi_op",
]
