"""Cross-entropy over full-vocab logits (port of ``repro/train/loss.py``).

Logits arrive fp32 (models upcast at the head). The reference's vocab-parallel
twin ``cross_entropy_vp`` comes with the tensor-parallel slice.
"""

from __future__ import annotations

import torch


def cross_entropy(logits, labels, *, z_loss: float = 0.0, reduction: str = "mean"):
    """logits: (..., V) fp32; labels: (...) int. Mean over all positions.

    ``z_loss`` (PaLM-style) regularises the partition function: it adds
    ``z_loss * lse**2`` per position. The max-shift carries no gradient, as in
    the reference. ``reduction="none"`` returns the per-position nll.
    """
    m = logits.amax(dim=-1, keepdim=True).detach()
    lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
    label_logit = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - label_logit
    if z_loss:
        nll = nll + z_loss * lse.square()
    if reduction == "none":
        return nll
    if reduction != "mean":
        raise ValueError(f"reduction must be 'mean' or 'none', got {reduction!r}")
    return nll.mean()


def top1_accuracy(logits, labels):
    return (logits.argmax(dim=-1) == labels).float().mean()
