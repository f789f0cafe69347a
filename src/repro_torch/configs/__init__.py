"""Assigned-architecture configs (data copied from ``repro/configs``) and the
input specs of each step (the port of ``repro/configs/__init__.py``).

``input_specs(cfg, shape, model)`` returns tensors on the ``meta`` device for
every input of the step the shape's kind selects, with the reference's
shapes and dtypes: they allocate nothing (the dry-run contract, where the
reference returns ``ShapeDtypeStruct``s).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.core.config import Family, InputShape, ModelConfig
from repro_torch.core.registry import ARCH_IDS, all_configs, get_config, get_smoke_config
from repro_torch.models import build_model


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    b, s = shape.global_batch, shape.seq_len
    specs = {
        "tokens": _spec((b, s), torch.int32),
        "labels": _spec((b, s), torch.int32),
    }
    if cfg.family == Family.AUDIO:
        specs["frames"] = _spec((b, cfg.enc_frames, cfg.d_model), torch.float32)
    if cfg.family == Family.VLM and cfg.vision_tokens:
        specs["vision_embeds"] = _spec((b, cfg.vision_tokens, cfg.d_model), torch.float32)
        specs["vision_pos"] = _spec((b, cfg.vision_tokens), torch.int32)
    return specs


def prefill_input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, Any]:
    specs = train_input_specs(cfg, shape)
    del specs["labels"]
    return specs


def decode_input_specs(cfg: ModelConfig, shape: InputShape, model) -> Dict[str, Any]:
    """Specs for ``decode_step(params, cache, tokens, pos)``: the whole cache
    (every rank's rows and positions) from ``init_cache`` of a twin of
    ``model`` on the meta device, so nothing is allocated whatever device
    ``model`` is on."""
    b, s = shape.global_batch, shape.seq_len
    twin = build_model(cfg, model.plan, device="meta")
    return {
        "cache": twin.init_cache(b, s),
        "tokens": _spec((b,), torch.int32),
        "pos": _spec((), torch.int32),
    }


def input_specs(cfg: ModelConfig, shape: InputShape, model=None) -> Dict[str, Any]:
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "prefill":
        return prefill_input_specs(cfg, shape)
    if model is None:
        raise ValueError("decode specs need the model (cache shapes)")
    return decode_input_specs(cfg, shape, model)


__all__ = [
    "ARCH_IDS", "all_configs", "get_config", "get_smoke_config",
    "input_specs", "train_input_specs", "prefill_input_specs",
    "decode_input_specs",
]
