"""Learning-rate schedules: warmup + cosine decay (port of
``repro/optim/schedule.py``). Steps are Python ints; the result is a float."""

from __future__ import annotations

import math


def linear_warmup(step: int, peak_lr: float, warmup_steps: int) -> float:
    return peak_lr * min(1.0, (step + 1) / max(warmup_steps, 1))


def cosine_schedule(step: int, peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1) -> float:
    if step < warmup_steps:
        return linear_warmup(step, peak_lr, warmup_steps)
    frac = min(max((step - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0), 1.0)
    cos = min_ratio + (1.0 - min_ratio) * 0.5 * (1.0 + math.cos(math.pi * frac))
    return peak_lr * cos
