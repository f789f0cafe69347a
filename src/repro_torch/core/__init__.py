"""Configuration, the architecture registry and device resolution.

- config.py    ModelConfig / ParallelPlan / assigned input shapes (own copy)
- registry.py  ``--arch <id>`` resolution for the 10 assigned architectures
- device.py    entry-point device (default ``cuda``) and dtype names
"""

from .config import (
    ATTN_IMPLS,
    Family,
    InputShape,
    INPUT_SHAPES,
    SHAPES_BY_NAME,
    ModelConfig,
    MoEConfig,
    ParallelPlan,
    SSMConfig,
)
from .device import resolve_device, resolve_dtype
from .registry import ARCH_IDS, all_configs, get_config, get_smoke_config, register

__all__ = [
    "ATTN_IMPLS",
    "Family",
    "InputShape",
    "INPUT_SHAPES",
    "SHAPES_BY_NAME",
    "ModelConfig",
    "MoEConfig",
    "ParallelPlan",
    "SSMConfig",
    "ARCH_IDS",
    "all_configs",
    "get_config",
    "get_smoke_config",
    "register",
    "resolve_device",
    "resolve_dtype",
]
