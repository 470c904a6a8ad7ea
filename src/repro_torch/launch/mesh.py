"""Production mesh construction (counterpart of ``repro.launch.mesh``).  A
FUNCTION (not a module constant), so that importing this module touches
no process group: the mesh exists only where a world of 256 or 512 ranks
has been initialised.
"""
from __future__ import annotations

import math

__all__ = ["make_production_mesh", "MESH_SHAPES"]

MESH_SHAPES = {
    "single_pod": ((16, 16), ("data", "model")),
    "multi_pod": ((2, 16, 16), ("pod", "data", "model")),
}


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") one, over the initialised default
    process group (``dist.make_mesh``; ``device=None`` means "cuda").
    Raises unless the world has exactly the mesh's 256 or 512 ranks."""
    import torch.distributed as tdist

    from ..dist import make_mesh

    shape, axes = MESH_SHAPES["multi_pod" if multi_pod else "single_pod"]
    if tdist.is_available() and tdist.is_initialized():
        world = tdist.get_world_size()
        if world != math.prod(shape):
            raise ValueError(
                f"the {shape} mesh needs a world of {math.prod(shape)} ranks, "
                f"this one has {world}")
    return make_mesh(shape, axes, device=device)
