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

Under expert parallelism (``plan.ep`` > 1, the reference's
``ep_fold_axes``/``ep_spec_for_param``) the routed experts (the
``experts/*`` leaves, E on dim 0 of each layer's tensor) are cut into ``ep``
contiguous blocks over the fold of the cp and model axes, at full d_expert
width, in place of the overlap layout's d_expert cut; the shared experts and
the router are whole on every fold rank, and so is every other leaf under
ep-only (the other leaves keep the overlap layout when tp is on).
:func:`param_spec` is a leaf's layout under a plan, :func:`layout_part` cuts
a whole leaf to a grid rank's part, :func:`shard_layout` a whole tree and
:func:`gather_layout` puts the parts back together.

Under pipeline parallelism (``plan.pp`` > 1, a grid with a pod axis) the
layer leaves are split over the stages, the reference's ``P("pod")`` on the
stacked layer dim: stage p holds layers ``[pp_offsets(layout)[p],
pp_offsets(layout)[p] + layout[p])``, with ``layout`` the plan's
``pp_layout`` or the even split. The port's params are per-layer lists, so an
uneven stage simply holds ``layout[p]`` layers: no padded slots and no gather
of the canonical stacks into them. The pod cut composes with the TP and EP
cuts above (they never touch the layer dim); the embedding, the final norm
and the head are whole on every stage. Within a stage every rank of its
model, cp and expert rings runs the same layers, so the reference's masked
uniform execution of padded slots has no counterpart here; what every rank of
the grid must run on every tick is the pod shift (``train/pipeline.py``).
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


def _tp_place(rank: int, n: int):
    return {"model": rank, "cp": 0}, {"model": n, "cp": 1}


def tp_shard_of(name: str, value, rank: int, n: int):
    """Model rank ``rank``'s TP shard of the whole leaf ``name`` (``value``, a
    tensor or an array in stacked coordinates) over ``n`` model ranks, by the
    overlap layout: a view, or ``value`` itself for a leaf kept whole."""
    return layout_part(name, value, None, *_tp_place(rank, n))


def shard_params(params: Any, rank: int, n: int) -> Any:
    """Rank ``rank``'s TP shards of a whole per-layer param tree over ``n``
    model ranks (new contiguous tensors, so each rank's shards are leaves of
    their own); leaves the layout keeps whole are copied."""
    return shard_layout(params, None, *_tp_place(rank, n))


def gather_params(shards: List[Any]) -> Any:
    """The whole tree from every model rank's shards (``shards[r]`` rank r's,
    as :func:`shard_params` cut them): the inverse of :func:`shard_params`,
    bit for bit; leaves kept whole come from rank 0."""
    return gather_layout(shards, None, _tp_place(0, len(shards))[1])


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


# ---------------------------------------------------------------------------
# expert parallelism: the folded expert ring's layout


def ep_fold_axes(plan) -> Tuple[str, ...]:
    """The mesh axes the expert ring folds onto (MoE parallel folding): ("cp",
    "model") when both are engaged, the one engaged, and ("model",) in the
    ep-only placement (tp == cp == 1: the experts ride the model axis, and
    attention runs as a cp ring over it). Empty when ep is off."""
    if plan.ep <= 1:
        return ()
    axes = ("cp",) if plan.cp > 1 else ()
    if plan.tp > 1 or plan.cp <= 1:
        axes = axes + ("model",)
    return axes


def ep_spec_for_param(path_names: Tuple[str, ...], shape: Tuple[int, ...], plan) -> Optional[Spec]:
    """The layout EP imposes on one leaf, or None where it imposes none (the
    leaf keeps its tp or whole layout): routed experts ((L?, E, ...), with
    "experts" in the path) split their E dim over :func:`ep_fold_axes` (a
    tuple of names for a folded ring) at full d_expert width, so each fold
    rank holds whole experts; the shared experts and the router are whole."""
    axes = ep_fold_axes(plan)
    if not axes:
        return None
    if "experts" in path_names:
        spec: List[Any] = [None] * len(shape)
        spec[1 if "layers" in path_names else 0] = axes if len(axes) > 1 else axes[0]
        return tuple(spec)
    if "shared" in path_names or path_names[-1] == "router":
        return (None,) * len(shape)
    return None


def pp_offsets(layout) -> Tuple[int, ...]:
    """The first layer of each stage of ``layout`` (layers per stage)."""
    out, off = [], 0
    for n in layout:
        out.append(off)
        off += int(n)
    return tuple(out)


def param_spec(name: str, shape: Tuple[int, ...], plan=None) -> Spec:
    """The layout of the leaf ``name`` (stacked ``shape``) on a grid under
    ``plan``: EP's (:func:`ep_spec_for_param`), else the overlap layout where
    the plan runs tp, else whole; under ``plan.pp`` > 1 a layer leaf's
    stacked dim 0 is split over "pod" (module docstring). ``plan=None`` is
    the TP layout."""
    path = tuple(name.split("/"))
    if plan is None:
        return overlap_spec_for_param(path, shape)
    spec = ep_spec_for_param(path, shape, plan)
    if spec is None:
        spec = (overlap_spec_for_param(path, shape) if plan.tp > 1
                else (None,) * len(shape))
    if getattr(plan, "pp", 1) > 1 and "layers" in path:
        spec = ("pod",) + tuple(spec[1:])
    return spec


def _layout_of(plan) -> Optional[Tuple[int, ...]]:
    """``plan``'s uneven stage layout, None for the even split (or no pp)."""
    return getattr(plan, "pp_layout", None) if plan is not None else None


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """The mesh axes that split a leaf of layout ``spec``."""
    return tuple(a for e in spec if e is not None for a in (e if isinstance(e, tuple) else (e,)))


def grid_place(mesh) -> Tuple[Dict[str, int], Dict[str, int]]:
    """A grid rank's index on the model, cp and pod axes, and their sizes."""
    cp, pod = mesh.cp, getattr(mesh, "pod", None)
    return ({"model": mesh.model.rank, "cp": cp.rank if cp is not None else 0,
             "pod": pod.rank if pod is not None else 0},
            {"model": mesh.model.size, "cp": cp.size if cp is not None else 1,
             "pod": pod.size if pod is not None else 1})


def _box(spec: Spec, shape, place, sizes, layout=None) -> List[Tuple[int, int]]:
    """[start, stop) per dim of the part of a whole leaf of ``shape`` that the
    rank at ``place`` holds under ``spec`` (a folded entry indexes its axes
    row-major; "pod" takes the stage's layers of ``layout``, the even split
    when None)."""
    box = []
    for d, entry in enumerate(spec):
        if entry is None:
            box.append((0, shape[d]))
            continue
        if entry == "pod":
            n = sizes.get("pod", 1)
            lay = layout or _even_layout(shape[d], n)
            if sum(lay) != shape[d] or len(lay) != n:
                raise ValueError(f"layout {tuple(lay)} does not split {shape[d]} layers over "
                                 f"{n} stages")
            lo = pp_offsets(lay)[place.get("pod", 0)]
            box.append((lo, lo + lay[place.get("pod", 0)]))
            continue
        idx, n = 0, 1
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            idx, n = idx * sizes[a] + place[a], n * sizes[a]
        if shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split over {n} ranks")
        k = shape[d] // n
        box.append((idx * k, (idx + 1) * k))
    return box


def _even_layout(n_layers: int, pp: int) -> Tuple[int, ...]:
    if n_layers % pp:
        raise ValueError(f"{n_layers} layers do not split evenly over {pp} stages")
    return (n_layers // pp,) * pp


def whole_shape(name: str, local_shape, plan, sizes) -> Tuple[int, ...]:
    """The whole leaf's stacked shape from a rank's part of it under ``plan``
    on a grid of ``sizes`` (a stage's layers: the plan's ``pp_layout`` sums
    them, the even split has ``pod`` times as many)."""
    spec = param_spec(name, tuple(local_shape), plan)
    layout = _layout_of(plan)
    return tuple(sum(layout) if e == "pod" and layout else
                 s * math.prod(sizes.get(a, 1) for a in spec_axes((e,)))
                 for s, e in zip(local_shape, spec))


def whole_box(name: str, whole, plan, place, sizes) -> List[Tuple[int, int]]:
    """The box (per stacked dim [start, stop)) of the whole leaf ``name`` of
    stacked shape ``whole`` that the rank at ``place`` holds under ``plan``."""
    return _box(param_spec(name, tuple(whole), plan), tuple(whole), place, sizes,
                _layout_of(plan))


def layout_box(name: str, local_shape, plan, place, sizes) -> List[List[int]]:
    """The box (per stacked dim [start, stop]) of the whole leaf ``name`` that
    a rank's part of stacked ``local_shape`` is, at ``place`` (``grid_place``)."""
    return [list(b) for b in whole_box(name, whole_shape(name, local_shape, plan, sizes),
                                       plan, place, sizes)]


def _cut(value, spec: Spec, place, sizes, layout=None):
    """``value`` cut to the box :func:`_box` gives: a view (a slice of a layer
    list), or ``value``."""
    shape = (len(value),) + tuple(value[0].shape) if isinstance(value, list) \
        else tuple(value.shape)
    for d, (lo, hi) in enumerate(_box(spec, shape, place, sizes, layout)):
        if hi - lo != shape[d]:
            value = value[lo:hi] if isinstance(value, list) else \
                value[(slice(None),) * d + (slice(lo, hi),)]
    return value


def layout_part(name: str, value, plan, place, sizes):
    """The grid rank at ``place`` 's part of the whole leaf ``name``
    (``value``, a tensor or array in stacked coordinates) under ``plan``: a
    view, or ``value`` itself for a leaf it holds whole."""
    return _cut(value, param_spec(name, tuple(value.shape), plan), place, sizes,
                _layout_of(plan))


def shard_layout(params: Any, plan, place, sizes) -> Any:
    """The grid rank at ``place`` 's parts of a whole per-layer param tree
    under ``plan`` (new contiguous tensors, each a leaf of its own; a layer
    list cut to the stage's layers, then layer by layer)."""
    out = {}
    layout = _layout_of(plan)
    for name, leaf in named_leaves(params):
        spec = param_spec(name, stacked_shape(leaf), plan)
        if isinstance(leaf, list):
            stage = _cut(leaf, spec[:1], place, sizes, layout)
            out[name] = [_cut(p.detach(), spec[1:], place, sizes).clone() for p in stage]
        else:
            out[name] = _cut(leaf.detach(), spec, place, sizes).clone()
    n_layers = {len(v) for v in out.values() if isinstance(v, list)}
    return _unflatten_like(_layers_like(params, max(n_layers, default=0)), out)


def gather_layout(shards: List[Any], plan, sizes) -> Any:
    """The whole tree from every rank's parts under ``plan``: ``shards[(p *
    cp + c) * model + m]`` the tree of the rank at pod index p, cp index c
    and model index m (the fold's row-major order, stage by stage); the
    inverse of :func:`shard_layout`, bit for bit. Leaves held whole come from
    ``shards[0]``."""
    named = [dict(named_leaves(s)) for s in shards]
    layout = _layout_of(plan)
    out = {}
    for name, leaf in named[0].items():
        parts = [torch.stack([p.detach() for p in nm[name]]) if isinstance(leaf, list)
                 else nm[name].detach() for nm in named]
        spec = param_spec(name, tuple(parts[0].shape), plan)
        shape = whole_shape(name, parts[0].shape, plan, sizes)
        whole = parts[0].clone() if not spec_axes(spec) else parts[0].new_empty(shape)
        for i, part in enumerate(parts if spec_axes(spec) else []):
            p, rest = divmod(i, sizes.get("cp", 1) * sizes["model"])
            c, m = divmod(rest, sizes["model"])
            box = _box(spec, shape, {"model": m, "cp": c, "pod": p}, sizes, layout)
            whole[tuple(slice(lo, hi) for lo, hi in box)] = part
        out[name] = [x.clone() for x in whole.unbind(0)] if isinstance(leaf, list) else whole
    n_layers = {len(v) for v in out.values() if isinstance(v, list)}
    return _unflatten_like(_layers_like(shards[0], max(n_layers, default=0)), out)


def _layers_like(tree: Any, n: int) -> Any:
    """``tree``'s structure with each layer list ``n`` layers long (a stage's
    tree standing for the whole one)."""
    if isinstance(tree, dict):
        return {k: _layers_like(v, n) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree[0]] * n
    return tree


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
