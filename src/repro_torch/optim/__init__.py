"""AdamW, global-norm clipping and the learning-rate schedule."""

from .adamw import AdamWState, adamw_init, adamw_update, adamw_update_sharded
from .clip import clip_by_global_norm, global_norm
from .schedule import cosine_schedule, linear_warmup

__all__ = [
    "AdamWState", "adamw_init", "adamw_update", "adamw_update_sharded",
    "clip_by_global_norm", "global_norm",
    "cosine_schedule", "linear_warmup",
]
