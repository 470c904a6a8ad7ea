"""Deterministic, resumable training data pipeline (counterpart of
``repro.data.pipeline``; NumPy batches drawn as the reference draws them).

Batches are a pure function of (seed, step) via counter-keyed RNG, so
restart-from-checkpoint replays the exact stream with no stored iterator
state — the simplest correct fault-tolerance story for synthetic/tokenized
data.  ``Prefetcher`` overlaps host batch synthesis with device compute;
its ``place`` (``to_device`` below) copies a batch to the device from the
prefetch thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..launch.specs import text_len

__all__ = ["TokenStream", "Prefetcher", "to_device"]


class TokenStream:
    """Synthetic LM token stream with next-token labels."""

    def __init__(
        self, cfg: ArchConfig, seq_len: int, batch: int, seed: int = 0,
        dtype=np.float32,
    ):
        self.cfg = cfg
        self.seq = text_len(cfg, seq_len)
        self.batch = batch
        self.seed = seed
        self.dtype = dtype

    def batch_at(self, step: int) -> dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step))
        toks = rng.integers(
            0, self.cfg.vocab, (self.batch, self.seq + 1), dtype=np.int64
        ).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.vlm:
            out["vision_embeds"] = rng.standard_normal(
                (self.batch, self.cfg.n_patches, self.cfg.d_model)
            ).astype(self.dtype)
        if self.cfg.encdec:
            out["enc_frames"] = rng.standard_normal(
                (self.batch, self.cfg.enc_seq, self.cfg.d_model)
            ).astype(self.dtype)
        return out

    def iter_from(self, step: int) -> Iterator[dict[str, np.ndarray]]:
        while True:
            yield self.batch_at(step)
            step += 1


def to_device(device) -> Callable:
    """A ``place`` for ``Prefetcher``: each array of a batch as a tensor on
    ``device``."""
    dev = torch.device(device)
    return lambda b: {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


class Prefetcher:
    """Background-thread prefetch of host batches (double buffering), with
    optional device placement (donatable input pipeline)."""

    def __init__(
        self,
        it: Iterator[dict[str, np.ndarray]],
        depth: int = 2,
        place: Optional[Callable] = None,
    ):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.place = place or (lambda b: b)
        self._stop = False
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        try:
            for b in self.it:
                if self._stop:
                    return
                self.q.put(self.place(b))
        except BaseException as e:
            self.q.put(e)

    def next(self):
        item = self.q.get()
        if isinstance(item, BaseException):
            raise item
        return item

    def close(self):
        self._stop = True
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
