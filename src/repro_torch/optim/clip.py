"""Global-norm gradient clipping (port of ``repro/optim/clip.py``)."""

from __future__ import annotations

import torch

from repro_torch.core.tree import leaves, named_leaves


def global_norm(tree):
    """sqrt of the fp32 sum of squares over every leaf: a 0-d fp32 tensor."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float, *, mesh=None, specs=None, splits=()):
    """Scale every grad by min(1, max_norm / max(norm, 1e-12)), **in place**
    (the reference returns a new tree). Returns (grads, norm).

    Under a data ``mesh`` (ZeRO-1) ``grads`` holds this rank's slices by name
    and ``specs`` says which leaves are split (``core.sharding``): the squares
    of the slices are summed over the ranks, and a leaf kept whole, which every
    rank holds the same, is counted once. ``splits`` is a list of (ring,
    names) for leaves that are also split over a model-parallel ring (TP
    shards over the model ring, expert blocks over the expert ring, a
    stage's layers over the pod ring; a tuple of rings for a leaf split over
    several, each summed in turn): their squares are summed over that ring
    first, and a leaf every rank of the grid holds whole (the embedding and
    head every stage holds, without tp) is counted once."""
    if splits:
        named = named_leaves(grads)
        group = {n: i for i, (_, names) in enumerate(splits) for n in names}
        # per split group and for the grid-whole leaves: [data-split, data-whole] squares
        sq = torch.zeros((len(splits) + 1, 2), dtype=torch.float32, device=mesh.device)
        for n, x in named:
            sq[group.get(n, len(splits))][0 if specs[n].dim is not None else 1] += \
                x.float().square().sum()
        tot = sq[-1]
        for i, (rings, _) in enumerate(splits):
            part = sq[i]
            for ring in (rings if isinstance(rings, tuple) else (rings,)):
                part = ring.all_reduce_sum(part)
            tot = part + tot
        norm = torch.sqrt(mesh.all_reduce_sum(tot[:1].clone())[0] + tot[1])
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
