"""The ZeRO-1 layout: which dim of each AdamW moment is split over the data
ranks (the port's copy of ``repro/core/sharding.py``'s ``_divisible``,
``opt_state_specs`` and ``train_state_specs``, on a mesh with one ``data``
axis).

A layout is a :class:`LeafSpec` per named leaf: the leaf's shape **as the
reference stacks it** (a ``layers`` list, or ``encoder/layers``, as (L, ...))
and the dim of that stacked shape that is split, or None for a leaf kept whole
on every rank. The rule is the reference's: the data axis goes on the largest
dim of at least 2 that the rank count divides, the later dim on a tie; a leaf
with no such dim stays replicated. A stacked dim ``d >= 1`` is dim ``d - 1`` of
every layer's tensor.

Where no other dim qualifies, or the layer count is the largest, the rule picks
the stacked layer dim itself, and whole layers then belong to ranks: rank r
holds layers [r L/n, (r + 1) L/n). The port supports this. Among the ten
registered configs at full size it happens at dp 2, 4 and 8 for mamba2-370m
alone, on its (48, 32) ``ssm/A_log``, ``ssm/D`` and ``ssm/dt_bias`` (48 layers
against 32 heads); no smoke config reaches it
(``tests/test_torch_sharding.py`` checks both).

A rank's moment for a split leaf is its slice in stacked coordinates,
``local_index``: along ``dim``, rows [r k, (r + 1) k) for k = shape[dim] / n.

Under tensor parallelism (a (data, model) grid, ``launch.mesh.GridMesh``) the
params themselves are split over the model ranks first, by the reference's
overlap layout (``overlap_spec_for_param``, ``repro/core/sharding.py:260``):
column GEMMs on their output dim, row GEMMs on their input dim, the embedding
and LM head on the vocab, the routed experts on d_expert; norm scales,
biases, the router, Mamba2's ``wB/wC``, convs and per-head leaves stay whole
on every model rank (the blocks slice what they need). :func:`shard_params`
cuts a whole tree into rank r's TP shards and :func:`gather_params` puts the
shards back together. The ZeRO-1 rule above then runs on each rank's TP
shards, over its data group.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch

from .tree import named_leaves, stacked_shape


class LeafSpec(NamedTuple):
    shape: Tuple[int, ...]        # the full leaf, stacked as the reference holds it
    dim: Optional[int]            # the dim split over the data ranks; None: whole
    dtype: torch.dtype


# Leaf-name classification of the overlap layout (the reference's
# core/sharding.py:60-64). wB/wC are not column-sharded: the heads (wz/wx/wdt)
# carry the model dim and the small state projections stay whole.
_COL_KEYS = {"wq", "wk", "wv", "gate", "up", "wz", "wx", "wdt"}
_ROW_KEYS = {"wo", "down", "out_proj"}
_REPLICATED_KEYS = {"scale", "bias", "A_log", "D", "dt_bias", "bq", "bk", "bv",
                    "wB", "wC"}

Spec = Tuple[Optional[str], ...]


def overlap_spec_for_param(path_names: Tuple[str, ...], shape: Tuple[int, ...],
                           cfg=None) -> Spec:
    """The reference's spec of one leaf on the overlap-TP path, as a tuple of
    axis names per dim ("model" or None; the reference's ``PartitionSpec``):
    ``model`` on the classified dim, never FSDP, the embedding always
    vocab-sharded, and the small per-head or per-channel leaves whole. The
    classification reads the names only (``cfg`` is the reference's argument
    and is not read there either)."""
    del cfg
    name = path_names[-1]
    spec: List[Optional[str]] = [None] * len(shape)
    if name == "tok" or (name == "w" and "lm_head" in path_names):
        spec[0 if name == "tok" else 1] = "model"
    elif "experts" in path_names and name in ("gate", "up"):
        spec[-1] = "model"                      # (L?, E, d, de): shard d_expert
    elif "experts" in path_names and name == "down":
        spec[-2] = "model"
    elif name in _COL_KEYS:
        spec[-1] = "model"
    elif name in _ROW_KEYS:
        spec[-2] = "model"
    return tuple(spec)


def overlap_param_specs(params: Any, cfg=None, plan=None, mesh=None) -> Dict[str, Spec]:
    """{name: spec} of every leaf of ``params`` (a per-layer tree, stacked
    shapes as ``named_leaves`` gives them) on the overlap-TP path."""
    del plan, mesh
    return {name: overlap_spec_for_param(tuple(name.split("/")), stacked_shape(leaf), cfg)
            for name, leaf in named_leaves(params)}


def tp_dim(spec: Spec) -> Optional[int]:
    """The stacked dim a spec splits over the model ranks (None: whole)."""
    return spec.index("model") if "model" in spec else None


def leaf_tp_dim(name: str, shape) -> Optional[int]:
    """The stacked dim the leaf ``name`` (a ``named_leaves`` name, prefixed
    or not: ``params/...``, ``opt/mu/...``) of stacked ``shape`` splits over
    the model ranks, by the overlap layout (None: whole)."""
    return tp_dim(overlap_spec_for_param(tuple(name.split("/")), tuple(shape)))


def _tp_cut(value, dim: int, rank: int, n: int):
    """Rank ``rank``'s 1/n of ``value`` (a tensor or an array) along ``dim``,
    a view."""
    if value.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(value.shape)} does not split over "
                         f"{n} model ranks")
    k = value.shape[dim] // n
    return value[(slice(None),) * dim + (slice(rank * k, (rank + 1) * k),)]


def tp_shard_of(name: str, value, rank: int, n: int):
    """Model rank ``rank``'s TP shard of the whole leaf ``name`` (``value``, a
    tensor or an array in stacked coordinates) over ``n`` model ranks, by the
    overlap layout: a view, or ``value`` itself for a leaf kept whole."""
    d = leaf_tp_dim(name, value.shape)
    return value if d is None else _tp_cut(value, d, rank, n)


def shard_params(params: Any, rank: int, n: int) -> Any:
    """Rank ``rank``'s TP shards of a whole per-layer param tree over ``n``
    model ranks (new contiguous tensors, so each rank's shards are leaves of
    their own); leaves the layout keeps whole are copied."""
    specs = overlap_param_specs(params)
    out = {}
    for name, leaf in named_leaves(params):
        d = tp_dim(specs[name])
        ps = leaf if isinstance(leaf, list) else [leaf]
        off = 1 if isinstance(leaf, list) else 0            # a layer list's L dim
        cut = [(p if d is None else _tp_cut(p.detach(), d - off, rank, n)).detach().clone()
               for p in ps]
        out[name] = cut if isinstance(leaf, list) else cut[0]
    return _unflatten_like(params, out)


def gather_params(shards: List[Any]) -> Any:
    """The whole tree from every model rank's shards (``shards[r]`` rank r's,
    as :func:`shard_params` cut them): the inverse of :func:`shard_params`,
    bit for bit; leaves kept whole come from rank 0."""
    specs = overlap_param_specs(shards[0])
    named = [dict(named_leaves(s)) for s in shards]
    out = {}
    for name, leaf in named[0].items():
        d = tp_dim(specs[name])
        if isinstance(leaf, list):
            out[name] = [p.detach().clone() if d is None else
                         torch.cat([nm[name][i].detach() for nm in named], dim=d - 1)
                         for i, p in enumerate(leaf)]
        else:
            out[name] = (leaf.detach().clone() if d is None else
                         torch.cat([nm[name].detach() for nm in named], dim=d))
    return _unflatten_like(shards[0], out)


def _unflatten_like(tree: Any, named: Dict[str, Any], prefix: str = "") -> Any:
    """``tree``'s structure (dicts, per-layer lists) with its leaves taken
    from ``named`` (by ``named_leaves`` name; a layer list's leaf is the list
    of its layers' tensors)."""
    if isinstance(tree, dict):
        return {k: _unflatten_like(v, named, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_unflatten_like(lp, {n: v[i] for n, v in named.items()
                                     if n.startswith(prefix)}, prefix)
                for i, lp in enumerate(tree)]
    return named[prefix[:-1]]


def data_size(mesh) -> int:
    """The mesh's data-axis size (1 without a mesh)."""
    return int(mesh.shape.get("data", 1)) if mesh is not None else 1


def _divisible(size: int, n: int) -> bool:
    return n > 1 and size % n == 0


def opt_shard_dim(shape: Tuple[int, ...], n: int) -> Optional[int]:
    """The reference's ZeRO-1 rule on one stacked shape: the largest dim the
    data axis divides that is larger than 1 (the later one on a tie)."""
    cands = [(s, i) for i, s in enumerate(shape) if _divisible(s, n) and s > 1]
    return max(cands)[1] if cands else None


def opt_state_specs(params: Any, mesh, plan) -> Dict[str, LeafSpec]:
    """{name: LeafSpec} of the fp32 moments of ``params`` (a per-layer tree),
    by name as ``named_leaves`` gives them. ``plan.zero_stage`` 0, or no mesh,
    keeps every moment whole."""
    n = data_size(mesh) if plan is None or plan.zero_stage >= 1 else 1
    out = {}
    for name, leaf in named_leaves(params):
        shape = stacked_shape(leaf)
        out[name] = LeafSpec(shape, opt_shard_dim(shape, n), torch.float32)
    return out


def train_state_specs(state: Any, mesh, plan) -> Dict[str, LeafSpec]:
    """The layout of a whole ``TrainState`` by leaf name (``params/...``,
    ``opt/step``, ``opt/mu/...``, ``opt/nu/...``): params and the step whole,
    the moments as :func:`opt_state_specs`. What a checkpoint records and an
    elastic restore re-slices onto."""
    out = {f"params/{n}": LeafSpec(stacked_shape(x), None, _dtype(x))
           for n, x in named_leaves(state.params)}
    out["opt/step"] = LeafSpec((), None, torch.int32)
    moments = opt_state_specs(state.params, mesh, plan)
    for which in ("mu", "nu"):
        out.update({f"opt/{which}/{n}": s for n, s in moments.items()})
    return out


def _dtype(leaf) -> torch.dtype:
    return (leaf[0] if isinstance(leaf, list) else leaf).dtype


def bytes_per_device(specs: Dict[str, LeafSpec], mesh) -> int:
    """Bytes one data rank holds of the leaves in ``specs``."""
    n = data_size(mesh)
    total = 0
    for s in specs.values():
        size = math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
        total += size // n if s.dim is not None else size
    return total


def local_shape(spec: LeafSpec, n: int) -> Tuple[int, ...]:
    """One rank's slice of the leaf, in stacked coordinates."""
    if spec.dim is None:
        return spec.shape
    return spec.shape[:spec.dim] + (spec.shape[spec.dim] // n,) + spec.shape[spec.dim + 1:]


def local_index(spec: LeafSpec, rank: int, n: int) -> List[List[int]]:
    """Rank ``rank``'s slice as [[start, stop], ...] per stacked dim (the
    manifest's shard ``index``)."""
    index = [[0, s] for s in spec.shape]
    if spec.dim is not None:
        k = spec.shape[spec.dim] // n
        index[spec.dim] = [rank * k, (rank + 1) * k]
    return index


def rank_views(leaf, spec: LeafSpec, rank: int, n: int) -> List[Tuple[torch.Tensor, Optional[int]]]:
    """The parts of a param leaf (a tensor, or a layer list) that rank
    ``rank`` owns under ``spec``, each with the index of its row in the rank's
    stacked moment (None for a leaf that is not a layer list): views of the
    live tensors, so an in-place update through them updates the params."""
    d = spec.dim
    k = spec.shape[d] // n if d is not None else 0
    if not isinstance(leaf, list):
        return [(leaf if d is None else leaf.narrow(d, rank * k, k), None)]
    if d == 0:                                   # whole layers belong to ranks
        return [(leaf[rank * k + j], j) for j in range(k)]
    return [(p if d is None else p.narrow(d - 1, rank * k, k), i) for i, p in enumerate(leaf)]


def dim_first(shape: Tuple[int, ...], dim: int, dtype: torch.dtype,
              device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A contiguous buffer holding a tensor of ``shape`` with ``dim`` moved
    first (the layout ``reduce_scatter`` and ``all_gather`` split), and the
    view of it in ``shape``'s own order to write or read through."""
    buf = torch.empty((shape[dim],) + shape[:dim] + shape[dim + 1:], dtype=dtype, device=device)
    return buf, buf.movedim(0, dim)
