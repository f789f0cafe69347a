"""Assigned-architecture configs (data copied from ``repro/configs``)."""

from repro_torch.core.registry import ARCH_IDS, all_configs, get_config, get_smoke_config

__all__ = ["ARCH_IDS", "all_configs", "get_config", "get_smoke_config"]
