"""Where the port's entry points place their tensors.

Every builder (engine, store, IVF, k-means, pruner) takes ``device``;
``None`` means the CUDA card, and without one ``resolve_device`` raises
and asks for ``device="cpu"`` rather than running on the CPU unasked.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; without one this raises rather than
    running on the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available: repro_torch places the store on "
                "'cuda' by default; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device
