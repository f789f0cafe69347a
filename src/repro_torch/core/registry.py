"""Architecture registry: ``--arch <id>`` resolution (copy of the reference's).

Each ``repro_torch/configs/<id>.py`` module registers its :class:`ModelConfig`
(full production config) and a ``smoke()`` reduced variant at import time.
"""

from __future__ import annotations

import importlib
from typing import Callable, Dict, List

from .config import ModelConfig

_FULL: Dict[str, ModelConfig] = {}
_SMOKE: Dict[str, Callable[[], ModelConfig]] = {}

ARCH_IDS: List[str] = [
    "pixtral-12b",
    "olmoe-1b-7b",
    "qwen2.5-14b",
    "zamba2-1.2b",
    "codeqwen1.5-7b",
    "gemma2-9b",
    "whisper-small",
    "deepseek-moe-16b",
    "mamba2-370m",
    "qwen1.5-4b",
]


def register(cfg: ModelConfig, smoke: Callable[[], ModelConfig]) -> ModelConfig:
    _FULL[cfg.arch_id] = cfg
    _SMOKE[cfg.arch_id] = smoke
    return cfg


def _ensure_loaded(arch_id: str) -> None:
    if arch_id not in _FULL:
        mod = arch_id.replace("-", "_").replace(".", "_")
        importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str) -> ModelConfig:
    _ensure_loaded(arch_id)
    return _FULL[arch_id]


def get_smoke_config(arch_id: str) -> ModelConfig:
    _ensure_loaded(arch_id)
    return _SMOKE[arch_id]()


def all_configs() -> Dict[str, ModelConfig]:
    for a in ARCH_IDS:
        _ensure_loaded(a)
    return dict(_FULL)
