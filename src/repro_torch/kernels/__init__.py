"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

Counterpart of ``repro.kernels``.  ``csrc/*.cu`` are the kernels (built at
first use by ``_build``); ``pdx_scan.py`` and ``batched_matmul.py`` bind
them; ``ops.py`` are the public wrappers that pad operands and dispatch by
device (CPU tensors run ``ref.py``'s plain versions, CUDA tensors the
kernels); ``ref.py`` holds the plain versions every kernel is held to.

  K1  ``pdx_scan.pdx_prune_scan_multi_cuda`` — whole-store fused L2 scan
      with the ADSampling test per d-tile (replaces
      ``repro.kernels.pdx_scan.pdx_prune_scan_multi_pallas``); behind the
      ``fused-scan`` executor.
  K2  ``batched_matmul.batched_distance_quant_cuda`` — batched
      query-vs-tile distances with in-register dequantization (replaces
      ``repro.kernels.batched_matmul.batched_distance_quant_pallas``);
      behind the ``fused-batch`` executor.
"""
