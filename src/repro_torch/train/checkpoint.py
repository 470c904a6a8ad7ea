"""Fault-tolerant checkpointing (counterpart of ``repro.train.checkpoint``):
atomic on-disk snapshots, async writes, retention, restore.

The on-disk format is the reference's: one ``arrays.npz`` of the flattened
leaves under ``||``-joined tree-path keys, plus ``meta.json`` (step, user
metadata), in ``<root>/step_<step:010d>``.  Writes go to ``<root>/tmp.<step>``
then rename, so a crashed writer never corrupts the latest checkpoint.  A
checkpoint written by either package restores in the other.  NumPy has no
bf16, so a bf16 leaf is written as its exact f32 values; either package's
restore casts it back to the template's dtype.

Elastic restore (``restore(shardings=)``): every rank reads the same
``arrays.npz`` and lands each leaf on its ``dist.sharding.NamedSharding``
(``distribute_tensor``: the rank keeps its own shard), whatever the mesh
the checkpoint was written from.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from ._tree import flatten_with_paths, map_with_paths, tree_map

__all__ = ["save", "restore", "latest_step", "all_steps", "AsyncCheckpointer"]

_SEP = "||"


def _key(path: tuple) -> str:
    return _SEP.join(str(p) for p in path)


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf``: the params are updated in place, so a
    snapshot must not share their memory (on the CPU neither)."""
    if isinstance(leaf, torch.Tensor):
        dtype = torch.float32 if leaf.dtype == torch.bfloat16 else leaf.dtype
        return leaf.detach().to("cpu", dtype, copy=True).numpy()
    return np.array(leaf)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(path): _host(leaf) for path, leaf in flatten_with_paths(tree)}


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def save(root: str, step: int, tree: Any, *, meta: Optional[dict] = None,
         keep: int = 3) -> str:
    """Atomic checkpoint write; prunes to the newest ``keep`` snapshots."""
    os.makedirs(root, exist_ok=True)
    tmp = os.path.join(root, f"tmp.{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = _flatten(tree)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "meta": meta or {}}, f)
    final = _ckpt_dir(root, step)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    # retention
    steps = sorted(all_steps(root))
    for s in steps[:-keep]:
        shutil.rmtree(_ckpt_dir(root, s), ignore_errors=True)
    return final


def all_steps(root: str) -> list[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and os.path.isdir(os.path.join(root, name)):
            out.append(int(name.split("_")[1]))
    return sorted(out)


def latest_step(root: str) -> Optional[int]:
    steps = all_steps(root)
    return steps[-1] if steps else None


def restore(root: str, template: Any, *, step: Optional[int] = None,
            shardings: Any = None) -> tuple[int, Any]:
    """Restore into the structure of ``template``: each leaf lands on the
    template leaf's device with its dtype.  ``shardings``: a tree of the
    same structure of ``dist.sharding.NamedSharding`` (``None`` for a leaf
    that stays whole); each such leaf becomes a DTensor on its mesh
    (elastic restore).  -> (step, tree)."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    d = _ckpt_dir(root, step)
    with np.load(os.path.join(d, "arrays.npz")) as z:
        arrays = {k: z[k] for k in z.files}

    def leaf(path, like):
        key = _key(path)
        if key not in arrays:
            raise KeyError(f"checkpoint missing {key}")
        arr = torch.from_numpy(np.array(arrays[key]))
        if isinstance(like, torch.Tensor):
            return arr.to(device=like.device, dtype=like.dtype)
        return arr

    tree = map_with_paths(leaf, template)
    if shardings is None:
        return step, tree
    from ..dist.sharding import device_put

    return step, tree_map(lambda t, s: t if s is None else device_put(t, s), tree, shardings)


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training: the device->host copy happens
    on the caller thread (cheap, required for consistency: the next step
    updates the params in place), serialization and disk I/O on a
    background thread.  ``wait()`` before exit."""

    def __init__(self, root: str, keep: int = 3):
        self.root = root
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, meta: Optional[dict] = None):
        self.wait()
        host_tree = tree_map(_host, tree)

        def _work():
            try:
                save(self.root, step, host_tree, meta=meta, keep=self.keep)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err
