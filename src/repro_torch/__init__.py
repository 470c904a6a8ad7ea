"""repro_torch — the PDX vector-search engine on PyTorch and CUDA.

A second package beside the JAX reference ``repro``: it mirrors that
package module for module and name for name (``repro_torch.core.plan``
is the counterpart of ``repro.core.plan``), imports ``torch`` and
``numpy`` only, and is held to the reference by the parity tests in
``tests/test_torch_*.py``.  Host-side NumPy (every RNG, PCA,
quantization parameters) is reproduced line for line, so both packages
see identical inputs.

Entry point::

    from repro_torch.core.engine import VectorSearchEngine, SearchSpec
    eng = VectorSearchEngine.build(X, index="ivf", pruner="adsampling")
    res = eng.search(Q, SearchSpec(k=10, scan_dtype="int8"))

``build`` places the store on ``device`` (default ``"cuda"``; pass
``device="cpu"`` explicitly where no card exists).  On the card the fused
executors run the hand-written CUDA kernels in ``repro_torch.kernels``;
on the CPU they run the kernels' plain PyTorch versions.

Precision: TF32 is switched off for matmuls and cuDNN at import.  The
batched distance form ``||q||^2 - 2 q.x + ||x||^2`` cancels, and TF32's
10-bit mantissa flips near-tie neighbour ids; the reference computes it in
full f32, and so does the port.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
