"""Assigned-architecture registry.  ``get_config(name)`` / ``list_configs()``.

A copy of the reference's NumPy-free registry (``repro.configs``): the same
names with the same fields, so both packages build the same shapes.

Each architecture lives in its own module with the exact published dims
[source tags in the module docstrings]; importing this package registers all.
"""
from .base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    ShapeSpec,
    get_config,
    list_configs,
    register,
    shape_is_applicable,
)

_LOADED = False


def _load_all():
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from . import (  # noqa: F401
        deepseek_moe_16b,
        deepseek_v3_671b,
        gemma_2b,
        granite_3_8b,
        internvl2_1b,
        jamba_v0_1_52b,
        llama3_2_3b,
        mamba2_370m,
        qwen2_72b,
        whisper_small,
    )
