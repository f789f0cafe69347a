"""Cross-entropy over full-vocab logits, and its vocab-parallel twin (port of
``repro/train/loss.py``).

Logits arrive fp32 (models upcast at the head). :func:`cross_entropy_vp` takes
one rank's vocab shard of the logits under tensor parallelism and completes
the softmax statistics over the model ring.
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


def cross_entropy_vp(logits, labels, ring, *, shard_index: int, z_loss: float = 0.0):
    """Vocab-parallel cross-entropy: ``logits`` (..., V/tp) fp32 is this
    rank's vocab shard (rank ``shard_index`` of ``ring``, a
    ``launch.mesh.ModelRing``), ``labels`` (...) the global ids. Returns the
    per-position nll, the same on every rank of the ring; callers own the
    mean.

    The max is a stop-gradient MAX over the ring. The sum of exponentials and
    the target logit (a masked local gather: one rank holds it, the others add
    zeros) are all-reduced over the ring by
    ``tensor_parallel.all_reduce_replicated``: every rank goes on to compute
    the same loss from them, so each rank's cotangent of the sum is already
    the whole one and passes through unchanged. z_loss as in
    :func:`cross_entropy`."""
    from .tensor_parallel import all_reduce_replicated  # noqa: PLC0415 (import cycle)
    v_loc = logits.shape[-1]
    m = ring.all_reduce_max(logits.detach().amax(dim=-1))
    se = all_reduce_replicated(ring, torch.exp(logits - m[..., None]).sum(dim=-1))
    lse = torch.log(se) + m
    local = labels.long() - shard_index * v_loc
    ok = (local >= 0) & (local < v_loc)
    ll = torch.gather(logits, -1, local.clamp(0, v_loc - 1)[..., None])[..., 0]
    label_logit = all_reduce_replicated(ring, torch.where(ok, ll, torch.zeros_like(ll)))
    nll = lse - label_logit
    if z_loss:
        nll = nll + z_loss * lse.square()
    return nll


def top1_accuracy(logits, labels):
    return (logits.argmax(dim=-1) == labels).float().mean()
