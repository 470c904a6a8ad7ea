"""Input specs per (architecture x shape) (counterpart of
``repro.launch.specs``): ``input_specs``, meta tensors that stand in for
the dry-run's batch (the reference's ShapeDtypeStructs: shapes and dtypes,
no storage), and ``text_len`` and ``make_concrete_batch``, drawing from
``np.random.default_rng(seed)`` in the reference's order, so both packages
see identical batches.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ArchConfig, ShapeSpec
from ..core.device import resolve_device

__all__ = ["input_specs", "make_concrete_batch", "text_len"]


def text_len(cfg: ArchConfig, seq_len: int) -> int:
    """Token-stream length so that the model's total sequence == seq_len."""
    if cfg.vlm:
        return seq_len - cfg.n_patches
    return seq_len


def input_specs(
    cfg: ArchConfig,
    shape: ShapeSpec,
    *,
    dtype=torch.bfloat16,
) -> dict[str, torch.Tensor]:
    """Meta tensors for the *batch* argument of the given step: int32
    tokens (and labels for a train step), ``dtype`` modality inputs."""
    B = shape.global_batch

    def meta(dims, dt):
        return torch.empty(dims, dtype=dt, device="meta")

    if shape.step == "train":
        S = text_len(cfg, shape.seq_len)
        specs = {"tokens": meta((B, S), torch.int32), "labels": meta((B, S), torch.int32)}
    elif shape.step == "prefill":
        specs = {"tokens": meta((B, text_len(cfg, shape.seq_len)), torch.int32)}
    else:  # decode: one new token; the seq_len lives in the KV cache
        specs = {"tokens": meta((B, 1), torch.int32)}
    if cfg.vlm and shape.step != "decode":
        specs["vision_embeds"] = meta((B, cfg.n_patches, cfg.d_model), dtype)
    if cfg.encdec and shape.step != "decode":
        specs["enc_frames"] = meta((B, cfg.enc_seq, cfg.d_model), dtype)
    return specs


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
