"""Silent-data-corruption defense (survey §8.2; port of
``repro/ft/integrity.py``): exact integrity checksums cross-checked across the
data ranks.

``plan.integrity = "audit"`` makes the train step compute the reference's
**exact** uint32 checksum of the updated params and the clipped grads (the sum
of every element's bits, mod 2^32: a float sum would hide low-mantissa flips)
and compare it across the ranks: one MAX all-reduce of (c, -c) gives the
max and the min (the reference's pmax/pmin pair). Every rank
holds the same replicated values after a healthy step, so any divergence
means a device produced different bits. The step reports ``integrity_div``
(0.0 = healthy); ``ft/recovery`` turns a nonzero into an ``sdc`` anomaly.

The checksum is held in an int64 tensor masked to 32 bits. A leaf is summed
through an integer view of its bits: bf16/fp16 and int16 as uint16 values,
fp32 and int32 as uint32, 1-byte types as uint8; an 8-byte leaf is cast first
as the reference casts it (fp64 to fp32, int64 to int32), and a bool to fp32.
The sum of the signed int32 view equals the uint32 sum mod 2^32, so those
leaves need no mask; a 16-bit view is masked to its unsigned value first.
int64 sums wrap mod 2^64, which 2^32 divides, so one mask of the total is
exact (and the audit costs one reduction launch per fp32 leaf).

ZeRO-1: under a data mesh each rank holds only its slices of the grads (the
reference's grads are global arrays, so each device's checksum is already a
global sum). :func:`replica_divergence` therefore takes those slices apart,
all-reduces (SUM) their checksum, then adds the checksum of what every rank
holds whole (the params after the all-gather, and any grad kept whole), and
only then compares MAX against MIN: a healthy step reads 0.0, and the value is
the checksum of the whole state. Under ZeRO-3 the params' parts are counted
the same way as the grad slices.

The checksum input passes the ``integrity.checksum`` fault point with the
caller's rank, which is how the tests create a genuinely rank-divergent value
(a rank-masked bitflip) to prove the detection end to end.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.tree import leaves, named_leaves
from .inject import taint

MASK = 0xFFFFFFFF


def _leaf_checksum(x) -> torch.Tensor:
    """One leaf's bits summed as unsigned values, in int64 (exact mod 2^32;
    the caller masks)."""
    if not isinstance(x, torch.Tensor):
        x = torch.tensor(x, dtype=torch.float32 if isinstance(x, float) else torch.int32)
    x = x.detach()
    if x.dtype == torch.bool:
        x = x.float()
    if x.element_size() == 8:
        x = x.float() if x.is_floating_point() else x.to(torch.int32)
    size = x.element_size()
    if size == 4:
        return x.view(torch.int32).sum(dtype=torch.int64)
    if size == 2:
        return (x.view(torch.int16).to(torch.int32) & 0xFFFF).sum(dtype=torch.int64)
    return x.view(torch.uint8).sum(dtype=torch.int64)


def tree_checksum(tree) -> torch.Tensor:
    """Exact uint32 checksum of a tree's bits (a 0-d int64 tensor; order does
    not matter, so a per-layer tree and the reference's stacked one agree)."""
    sums = [_leaf_checksum(leaf) for leaf in leaves(tree)]
    if not sums:
        return torch.zeros((), dtype=torch.int64)
    return torch.stack([c.to(sums[0].device) for c in sums]).sum() & MASK


def replica_divergence(tree, mesh=None, sharded=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(checksum, divergence) of ``tree`` across the data ranks of ``mesh``.

    ``sharded`` is this rank's part of a tree split over the ranks (the ZeRO-1
    grad slices): its checksum is all-reduced (SUM) before the whole ``tree``'s
    is added (module docstring). ``divergence`` is ``float32(max - min)`` of
    the per-rank checksum: 0.0 when every rank holds identical bits. Without a
    mesh of more than one rank the local checksum is returned with divergence
    0.0, as in the reference."""
    cs = tree_checksum(tree)
    n = 1 if mesh is None else mesh.size
    if sharded is not None:
        part = tree_checksum(sharded).to(cs.device).reshape(1)
        if n > 1:
            part = mesh.all_reduce_int(part, "sum")
        cs = (cs + part[0]) & MASK
    if n <= 1:
        return cs, torch.zeros((), dtype=torch.float32, device=cs.device)
    c = taint("integrity.checksum", cs, rank=mesh.rank) & MASK
    both = mesh.all_reduce_int(torch.stack([c, -c]), "max")
    mx, mn = both[0], -both[1]
    return mx, (mx - mn).to(torch.float32)


def audit(params, grads, mesh=None, specs=None,
          sharded_params: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """The train step's audit (``plan.integrity == "audit"``): (checksum,
    divergence) of ``{"params": params, "grads": grads}``. Under a data mesh,
    ``grads`` holds this rank's slices by name and ``specs`` says which are
    split (``core.sharding``); a grad kept whole is counted once. Under
    ZeRO-3 (``sharded_params``) the params' parts are counted as the grad
    slices are: summed over the ranks (a layer placeholder holds no bits)."""
    if mesh is None or specs is None:
        return replica_divergence({"params": params, "grads": grads}, mesh)
    named = named_leaves(grads)
    split = [x for n, x in named if specs[n].dim is not None]
    whole = [x for n, x in named if specs[n].dim is None]
    if not sharded_params:
        return replica_divergence({"params": params, "grads": whole}, mesh, sharded=split)
    pnamed = named_leaves(params)
    split += [x for n, x in pnamed if specs[n].dim is not None]
    whole += [x for n, x in pnamed if specs[n].dim is None]
    return replica_divergence(whole, mesh, sharded=split)
