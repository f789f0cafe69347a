"""ZeRO-3 / FSDP (survey §4.1.1, §6.2): the per-layer gather of the params
split over the data domain, and its backward.

The reference gets ZeRO-3 from GSPMD: ``ParallelPlan.dp_shard`` > 1 annotates
every param with the data axes (``repro/core/sharding.py`` ``_add_fsdp``) and
XLA inserts the all-gathers and reduce-scatters. The port holds each rank's
part of every leaf (``core.sharding.fsdp_cut``, tagged with its
``FsdpPart``) and gathers explicitly:

- :class:`_Gather` is an autograd Function over the data group. Its forward
  all-gathers a part into the whole tensor (a broadcast from the owner for a
  layer the rule gave whole to one rank); its backward reduce-scatters the
  cotangent, a mean over the ranks, into the part's ``.grad`` (a reduce to
  the owner). Each rank's loss is the mean over its rows, so that mean is the
  grad of the global batch's loss, ZeRO-1's reduce-scatter moved into the
  backward.
- :func:`gather_tree` runs it on the tagged tensors of a (sub)tree. The layer
  bodies (``train/executor.py``) call it on each layer's params inside the
  layer's remat boundary, so under ``remat="full"`` the backward re-gathers
  and no whole layer outlives its use; ``"selective"`` gathers each
  checkpointed piece's own leaves. The models gather the embedding, the head
  and the final norm where they use them (``models/families.py``).

Layer l + 1's gather is not prefetched during layer l (ROADMAP A13.7's
leftover): every gather is exposed.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.core.sharding import FsdpPart, fsdp_part


def gather_part(mesh, t: torch.Tensor, part: FsdpPart) -> torch.Tensor:
    """The whole tensor from every data rank's part (no autograd)."""
    if part.owner is not None:
        out = (t.detach().clone() if mesh.rank == part.owner
               else t.new_empty(part.whole))
        return mesh.broadcast_(out, part.owner)
    full = mesh.all_gather(t.detach().movedim(part.dim, 0).contiguous())
    return full.movedim(0, part.dim)


def scatter_grad(mesh, g: torch.Tensor, part: FsdpPart, like: torch.Tensor) -> torch.Tensor:
    """This rank's part of the mean of ``g`` (the whole tensor's cotangent)
    over the data ranks, shaped as ``like`` (the part)."""
    if part.owner is not None:
        out = mesh.reduce_mean_(g.detach().contiguous().clone(), part.owner)
        return out if mesh.rank == part.owner else like.new_zeros(like.shape)
    return mesh.reduce_scatter_mean(g.detach().movedim(part.dim, 0).contiguous()
                                    ).movedim(0, part.dim).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(fctx, t, mesh, part):
        fctx.mesh, fctx.part = mesh, part
        fctx.like = t.detach()
        return gather_part(mesh, t, part)

    @staticmethod
    def backward(fctx, g):
        return scatter_grad(fctx.mesh, g, fctx.part, fctx.like), None, None


def gather_leaf(mesh, t):
    """``t`` whole: the gather of a ZeRO-3 part (differentiable), ``t``
    itself when it is no part."""
    part = fsdp_part(t) if isinstance(t, torch.Tensor) else None
    if part is None:
        return t
    return _Gather.apply(t, mesh, part)


def gather_tree(mesh, tree: Any, select: Optional[Callable[[Tuple[str, ...]], bool]] = None,
                path: Tuple[str, ...] = ()) -> Any:
    """``tree`` (nested dicts of tensors) with every ZeRO-3 part whose path
    ``select`` accepts (every one when None) replaced by its gather."""
    if isinstance(tree, dict):
        return {k: gather_tree(mesh, v, select, path + (k,)) for k, v in tree.items()}
    if select is not None and not select(path):
        return tree
    return gather_leaf(mesh, tree)


def gatherer(mesh) -> Callable:
    """``gather(tree, select=None)`` over ``mesh``'s data group."""
    return lambda tree, select=None: gather_tree(mesh, tree, select)


@torch.no_grad()
def gather_fsdp(params: Any, mesh) -> Any:
    """The whole param tree from every rank's ZeRO-3 parts (new tensors;
    leaves kept whole are returned as they are): for serving, checks and
    checkpoints. Every rank of the data group must call it."""
    def one(x):
        part = fsdp_part(x) if isinstance(x, torch.Tensor) else None
        return x if part is None else gather_part(mesh, x, part)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return one(tree)
    return walk(params)
