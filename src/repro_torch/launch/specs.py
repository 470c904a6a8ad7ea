"""Concrete input batches per architecture (counterpart of
``repro.launch.specs``): ``text_len`` and ``make_concrete_batch``, drawing
from ``np.random.default_rng(seed)`` in the reference's order, so both
packages see identical batches.  ``input_specs`` (the dry-run's
ShapeDtypeStructs) waits with the dry-run (ROADMAP.md, modules item 3).
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..core.device import resolve_device

__all__ = ["make_concrete_batch", "text_len"]


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    """Token-stream length so that the model's total sequence == seq_len."""
    if cfg.vlm:
        return seq_len - cfg.n_patches
    return seq_len


def make_concrete_batch(
    cfg: ArchConfig, seq_len: int, batch: int, step: str, seed: int = 0,
    dtype=torch.float32, *, device=None,
) -> dict[str, torch.Tensor]:
    """Tiny concrete batch for smoke tests, as tensors on ``device``
    (``None`` means the CUDA card): int32 tokens (and labels for a train
    step), ``dtype`` modality inputs."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    S = text_len(cfg, seq_len)

    def ints(shape):
        return torch.as_tensor(rng.integers(0, cfg.vocab, shape), dtype=torch.int32, device=dev)

    def normal(shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)

    out: dict[str, torch.Tensor] = {}
    if step == "decode":
        out["tokens"] = ints((batch, 1))
        return out
    out["tokens"] = ints((batch, S))
    if step == "train":
        out["labels"] = ints((batch, S))
    if cfg.vlm:
        out["vision_embeds"] = normal((batch, cfg.n_patches, cfg.d_model))
    if cfg.encdec:
        out["enc_frames"] = normal((batch, cfg.enc_seq, cfg.d_model))
    return out
