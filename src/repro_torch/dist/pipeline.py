"""Microbatch pipeline parallelism over a ``stage`` mesh axis (counterpart
of ``repro.dist.pipeline``: the GPipe schedule, on ``torch.distributed``
with one process per rank).

Under the SPMD contract (``repro_torch.dist``) every rank passes the whole
stacked ``stage_params`` and takes its own slice, ``[rank]`` along the
axis: the reference's ``in_specs`` of ``P(axis)``.  Microbatch ``m``
enters stage 0 at step ``m`` and leaves stage ``S-1`` at step
``m + S - 1``; the schedule runs ``n_micro + n_stages - 1`` steps, each
ending in one ``ppermute`` that shifts the activations one stage round the
ring.  One ``psum`` then replicates the last stage's outputs.  Bubble
fraction: ``(S-1) / (n_micro + S - 1)``.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..train._tree import leaves, tree_map
from . import axis_rank, axis_size, mesh_device, ppermute, psum

__all__ = ["pipeline_apply"]


def pipeline_apply(
    mesh,
    stage_fn: Callable,
    stage_params,
    x: torch.Tensor,
    *,
    axis: str = "stage",
) -> torch.Tensor:
    """Run ``x`` (n_micro, mb, ...) through ``n_stages`` pipelined stages.

    ``stage_fn(w, xb) -> yb`` applies one stage to one microbatch;
    ``stage_params`` is a tree whose leaves carry a leading stage axis of
    size ``axis_size(mesh, axis)``.  Output shapes must equal input shapes
    (residual-block pipelines).  Returns the (n_micro, mb, ...) outputs,
    the same on every rank: the stages applied in sequence.
    """
    n_stages = axis_size(mesh, axis)
    n_micro = x.shape[0]
    leading = {leaf.shape[0] for leaf in leaves(stage_params)}
    if leading != {n_stages}:
        raise ValueError(
            f"stage_params leading dims {sorted(leading)} must all equal the "
            f"'{axis}' axis size {n_stages} (one stage per device)"
        )
    last = n_stages - 1
    ring = [(i, (i + 1) % n_stages) for i in range(n_stages)]
    sidx = axis_rank(mesh, axis)
    dev = mesh_device(mesh)
    w = tree_map(lambda a: a[sidx].to(dev), stage_params)  # this rank's stage
    xs = x.to(dev)
    carry = torch.zeros_like(xs[0])
    out = torch.zeros_like(xs)
    for t in range(n_micro + n_stages - 1):
        feed = xs[t] if t < n_micro else torch.zeros_like(xs[0])
        y = stage_fn(w, feed if sidx == 0 else carry)
        m = t - last
        if 0 <= m < n_micro and sidx == last:  # the last stage emits microbatch m now
            out[m] = y
        carry = ppermute(y, mesh, axis, ring)
    # only the last stage holds real outputs; psum replicates them
    return psum(out if sidx == last else torch.zeros_like(out), mesh, axis)
