"""Global-norm gradient clipping (port of ``repro/optim/clip.py``)."""

from __future__ import annotations

import torch

from repro_torch.core.tree import leaves


def global_norm(tree):
    """sqrt of the fp32 sum of squares over every leaf: a 0-d fp32 tensor."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Scale every grad by min(1, max_norm / max(norm, 1e-12)), **in place**
    (the reference returns a new tree). Returns (grads, norm)."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in leaves(grads):
        g.copy_(g.float() * scale)
    return grads, norm
