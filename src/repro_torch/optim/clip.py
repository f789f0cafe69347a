"""Global-norm gradient clipping (port of ``repro/optim/clip.py``)."""

from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, named_leaves


def global_norm(tree):
    """sqrt of the fp32 sum of squares over every leaf: a 0-d fp32 tensor."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, *, mesh=None, specs=None, ring=None,
                        tp_split=None):
    """Scale every grad by min(1, max_norm / max(norm, 1e-12)), **in place**
    (the reference returns a new tree). Returns (grads, norm).

    Under a data ``mesh`` (ZeRO-1) ``grads`` holds this rank's slices by name
    and ``specs`` says which leaves are split (``core.sharding``): the squares
    of the slices are summed over the ranks, and a leaf kept whole, which every
    rank holds the same, is counted once. Under tensor parallelism ``ring`` is
    the model ring and ``tp_split`` the names of the leaves split over it:
    their squares are summed over the ring first, and a leaf every model rank
    holds whole is counted once."""
    if ring is not None:
        named = named_leaves(grads)
        # [data-split, data-whole] squares, of the TP-split and the TP-whole leaves
        sq_tp = torch.zeros(2, dtype=torch.float32, device=mesh.device)
        sq_rep = torch.zeros(2, dtype=torch.float32, device=mesh.device)
        for n, x in named:
            (sq_tp if n in tp_split else sq_rep)[0 if specs[n].dim is not None else 1] += \
                x.float().square().sum()
        sq = ring.all_reduce_sum(sq_tp) + sq_rep
        norm = torch.sqrt(mesh.all_reduce_sum(sq[:1].clone())[0] + sq[1])
    elif mesh is None:
        norm = global_norm(grads)
    else:
        named = named_leaves(grads)
        sq = torch.zeros(1, dtype=torch.float32, device=mesh.device)
        for n, x in named:
            if specs[n].dim is not None:
                sq += x.float().square().sum()
        sq = mesh.all_reduce_sum(sq)[0]
        for n, x in named:
            if specs[n].dim is None:
                sq = sq + x.float().square().sum()
        norm = torch.sqrt(sq)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    for g in leaves(grads):
        g.copy_(g.float() * scale)
    return grads, norm
