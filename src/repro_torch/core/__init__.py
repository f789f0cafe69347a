"""Configuration, the architecture registry and device resolution.

- config.py    ModelConfig / ParallelPlan / assigned input shapes (own copy)
- registry.py  ``--arch <id>`` resolution for the 10 assigned architectures
- device.py    entry-point device (default ``cuda``) and dtype names
- tree.py      ``leaves`` / ``map_tree`` over nested dict/list param trees
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
    RECOVERY_ACTIONS,
    REMAT_MODES,
    RecoveryPolicy,
    SSMConfig,
)
from .device import resolve_device, resolve_dtype
from .registry import ARCH_IDS, all_configs, get_config, get_smoke_config, register
from .tree import leaves, map_tree

__all__ = [
    "ATTN_IMPLS",
    "Family",
    "InputShape",
    "INPUT_SHAPES",
    "SHAPES_BY_NAME",
    "ModelConfig",
    "MoEConfig",
    "ParallelPlan",
    "RECOVERY_ACTIONS",
    "REMAT_MODES",
    "RecoveryPolicy",
    "SSMConfig",
    "ARCH_IDS",
    "all_configs",
    "get_config",
    "get_smoke_config",
    "leaves",
    "map_tree",
    "register",
    "resolve_device",
    "resolve_dtype",
]
