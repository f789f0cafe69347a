"""Train step: loss + grad + clip + AdamW, with microbatch accumulation (port of
``repro/train/step.py``).

    state = init_train_state(model, gen)
    step = make_train_step(model, plan, hyper)
    state, metrics = step(state, batch)

The params are the autograd leaves (``requires_grad``). Each microbatch's
backward adds grad(loss) / ``plan.microbatches`` into ``.grad``, so ``.grad``
ends as the reference's mean over microbatches with no second fp32 buffer.
Clipping and AdamW then update the grads, params and moments in place
(``repro_torch.optim``).

Data parallelism with ZeRO-1 (survey §4.1.1, §6.2.1): pass a data ``mesh``
(``repro_torch.launch.mesh.DataMesh``) to :func:`init_train_state` and
:func:`make_train_step`, in every rank's process, with the same global batch
on each. Rank r runs its rows of each microbatch (``rank_microbatches``) into
``.grad`` as above; then, leaf by leaf, the grads are reduce-scattered (a mean
over the ranks) onto the moment slices of ``core.sharding.opt_state_specs``
and ``.grad`` is freed, a leaf kept whole is all-reduced instead, and the
clip and ``adamw_update_sharded`` run on the slices, ending in the all-gather
of the params. ``loss``, ``grad_norm`` and ``moe_aux`` are means over the
ranks, the numbers of one device's step on the global batch.

The collectives split dim 0, and a leaf's split dim is often another
(``wq``'s output dim, a stacked leaf's layer rows). Each leaf's grads are
therefore copied once into a buffer with the split dim first (the layers of a
layer list stacked in the same copy), and each rank's param slice into
another before the all-gather, which lands in a third that is copied back:
one extra pass over the grads and two over the params a step, against one
collective per leaf name instead of one per layer. Overlapping the
reduce-scatter with the backward is later work (ROADMAP A13.1).

Without a mesh the step keeps its own path, on moments laid out as the params
(per-layer trees), rather than running the ZeRO-1 code on a mesh of one
process (``DataMesh()``, which agrees with it: ``tests/test_torch_dp.py``).
That code would stack every layer list's grads into one buffer per leaf name
(a copy of all the grads a step, to no end on one process) and hold the
moments by name, stacked, a layout that every single-device caller and the
reference-holding tests read per layer (``interop``, ``leaves``).

``plan.integrity == "audit"`` adds the reference's silent-data-corruption
audit to the metrics: ``integrity_checksum``, the exact uint32 checksum of the
new params and the clipped grads, and ``integrity_div``, its spread over the
data ranks (0.0 when every rank holds the same bits; ``ft/integrity.py``, which
also says how the ZeRO-1 grad slices are counted).

Tensor parallelism (survey §4.1.2): pass a (data, model) grid
(``repro_torch.launch.mesh.GridMesh``) whose model axis is 2 or more, with a
plan asking for it (``tp`` equal to that axis). :func:`init_train_state` then
draws the whole params and keeps this rank's TP shards
(``core.sharding.shard_layout``), and the step takes the executor's
tensor-parallel loss (``train.executor.make_executor_loss_fn``, the
reference's ``_overlap_loss_fn``). After the backward the grads of the leaves
the layout keeps whole on every model rank (norm scales, ``bq/bk/bv``, the
router, ``wB/wC``, the SSM per-head leaves) hold each rank's share and are
summed over the model ring (:func:`sum_grid_grads`, one all-reduce per
dtype); the ZeRO-1 code then runs on each rank's shards over its data group
as above, and the global-norm clip counts each sharded leaf's squares once a
model rank and each replicated leaf once.

Context parallelism (survey §4.1.4): pass a grid with a cp axis
(``init_grid_mesh(cp=)``) and a plan whose ``cp`` is its size. The params are
whole on every cp rank (or its tp shards, the same on every cp rank of a model
index); the step takes the executor's context-parallel loss, whose value is
the mean over the rank's rows and the whole sequence, and after the backward
every leaf's grads are summed over the cp ring (:func:`sum_grid_grads`, one
all-reduce per dtype in buckets): they are the cp ranks' shares of that loss's
grads, so they are summed, not averaged. The tp sum and ZeRO-1 over the data
group then run as above, and every cp rank makes the same update.

Expert parallelism (survey §4.1.5): a plan with ``ep`` > 1 on a grid whose
cp × model ranks number ``ep`` (or whose model axis does, the ep-only
placement). :func:`init_train_state` keeps this rank's expert blocks, after
its TP shards where tp is on (``core.sharding.shard_layout``), and the step
takes the executor's loss. The routed experts' grads are complete on their
owner after the backward (the combine exchange's backward brought every
peer's cotangent to it), so the sums over the cp and model rings cover every
other leaf (a ring's sum skips the leaves split over its axis); ZeRO-1 then
runs over the data group on the rank's leaves as they are, and the clip
counts each expert block once per fold rank, as it counts TP shards. The
integrity audit, like under TP, checks each rank's own leaves over its data
group.

The MoE family under data parallelism alone routes each rank's own rows and
sums the aux statistics over the data group (the reference executor's
``batch_axes`` rule, ``train.executor.ParallelContext``): the same as one
device's step when the capacity drops nothing (``warn_shard_local_routing``
flags the rest). The reference's GSPMD step routes over the global batch
instead (ROADMAP queue C).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.config import ParallelPlan
from repro_torch.core.sharding import (LeafSpec, dim_first, grid_place, opt_state_specs,
                                       param_spec, shard_layout, spec_axes)
from repro_torch.core.tree import from_names, leaves, map_tree, named_leaves, stacked_shape
from repro_torch.ft.integrity import audit
from repro_torch.launch.mesh import data_mesh, rank_microbatches
from .executor import make_executor_loss_fn, resolve_context
from repro_torch.models.families import Model
from repro_torch.optim import (AdamWState, adamw_init, adamw_update, adamw_update_sharded,
                               clip_by_global_norm, cosine_schedule)
from .loss import cross_entropy


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


class Hyper(NamedTuple):
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    z_loss: float = 1e-4


def init_train_state(model: Model, gen: torch.Generator, mesh=None,
                     plan: Optional[ParallelPlan] = None) -> TrainState:
    """Fresh params from ``gen`` (as autograd leaves) and zero fp32 moments;
    with a data ``mesh`` the moments are born on ``plan``'s ZeRO-1 layout
    (this rank's slices). On a grid whose plan runs tensor, expert or
    pipeline parallelism the params are this rank's TP shards, expert blocks
    and stage's layers of the whole draw, and the ZeRO-1 layout is over its
    data group. Every rank must
    draw the same params: pass generators seeded alike."""
    plan = plan or model.plan
    params = model.init(gen)
    ctx = resolve_context(model.cfg, plan, mesh)
    if ctx.tp is not None or ctx.ep is not None or plan.pp > 1:
        params = shard_layout(params, plan, *grid_place(mesh))
    for p in leaves(params):
        p.requires_grad_(True)
    if mesh is None:
        return TrainState(params, adamw_init(params))
    dmesh = data_mesh(mesh)
    specs = opt_state_specs(params, dmesh, plan)
    return TrainState(params, adamw_init(params, mesh=dmesh, specs=specs))


def make_loss_fn(model: Model, hyper: Hyper) -> Callable:
    def loss_fn(params, batch):
        logits, aux = model.forward(params, batch)
        loss = cross_entropy(logits, batch["labels"], z_loss=hyper.z_loss)
        return loss + aux, {"xent": loss, "moe_aux": aux}
    return loss_fn


def _split_microbatches(batch: Dict[str, torch.Tensor], n: int):
    b = batch["tokens"].shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(n)]


@torch.no_grad()
def _scatter_grads(params: Any, specs: Dict[str, LeafSpec], mesh) -> Any:
    """This rank's slices of the mean grads over the ranks, by name, with
    ``.grad`` freed leaf by leaf (module docstring)."""
    out = {}
    for name, leaf in named_leaves(params):
        spec = specs[name]
        ps = leaf if isinstance(leaf, list) else [leaf]
        g0 = ps[0].grad
        if spec.dim is None:
            buf = torch.stack([p.grad for p in ps]) if isinstance(leaf, list) else g0
            out[name] = mesh.all_reduce_mean(buf)
        else:
            buf, nat = dim_first(spec.shape, spec.dim, g0.dtype, g0.device)
            if isinstance(leaf, list):
                for i, p in enumerate(ps):
                    nat[i].copy_(p.grad)
            else:
                nat.copy_(g0)
            out[name] = mesh.reduce_scatter_mean(buf).movedim(0, spec.dim)
        for p in ps:
            p.grad = None
    return from_names(out)


# the most elements one all-reduce of :func:`_sum_grads` moves: its flat copy,
# the ring's result and their host copies stay a few hundred MB a rank
GRAD_BUCKET = 1 << 26


@torch.no_grad()
def _sum_grads(params: Any, ring, names=None) -> None:
    """The grads of the leaves named in ``names`` (every leaf when None),
    each rank's share, summed over ``ring`` in place (:func:`sum_tensors`).
    A leaf without a grad counts as zeros."""
    grads = []
    for name, leaf in named_leaves(params):
        if names is None or name in names:
            for p in (leaf if isinstance(leaf, list) else [leaf]):
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
                grads.append(p.grad)
    sum_tensors(grads, ring)


@torch.no_grad()
def sum_tensors(tensors, ring) -> None:
    """``tensors`` summed over ``ring`` (a ``ModelRing`` or a ``DataMesh``) in
    place: all-reduces of flat buffers, one dtype at a time, of at most
    ``GRAD_BUCKET`` elements (a larger tensor goes alone)."""
    by_dtype: Dict[torch.dtype, list] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for grads in by_dtype.values():
        bucket, size = [], 0
        for g in grads + [None]:
            if bucket and (g is None or size + g.numel() > GRAD_BUCKET):
                flat = ring.all_reduce_sum(torch.cat([x.reshape(-1) for x in bucket]))
                for x, part in zip(bucket, flat.split([x.numel() for x in bucket])):
                    x.copy_(part.view_as(x))
                bucket, size = [], 0
            if g is not None:
                bucket.append(g)
                size += g.numel()


def _split_axes(params: Any, plan: ParallelPlan) -> Dict[str, tuple]:
    """{name: the grid axes that split the leaf under ``plan``}."""
    return {n: spec_axes(param_spec(n, stacked_shape(leaf), plan))
            for n, leaf in named_leaves(params)}


def sum_grid_grads(params: Any, plan: ParallelPlan, ctx) -> Dict[str, tuple]:
    """The grads of the leaves each of ``ctx``'s cp and model rings does not
    split, each rank's share, summed over that ring in place (module
    docstring); returns ``_split_axes``."""
    axes = _split_axes(params, plan)
    if ctx.cp is not None:
        _sum_grads(params, ctx.cp, {n for n, a in axes.items() if ctx.cp.axis not in a})
    if ctx.tp is not None:
        _sum_grads(params, ctx.tp, {n for n, a in axes.items() if "model" not in a})
    return axes


def make_train_step(model: Model, plan: ParallelPlan, hyper: Hyper = Hyper(),
                    mesh=None) -> Callable:
    """The step for ``model`` under ``plan`` (``microbatches``, ``zero_stage``,
    ``tp``, ``cp``, ``ep``; ``remat`` is the model's). ``batch`` holds the global batch's
    tensors on the model's device; with a data ``mesh`` or a grid, the same
    on every rank. ``plan.pp`` > 1 is refused: a pipelined step is composed
    around ``train.pipeline.pipelined_loss_fn``, as the reference's callers
    compose theirs (its step builds no pipeline)."""
    plan.validate(model.cfg)
    if plan.pp > 1:
        raise ValueError(f"make_train_step runs no pipeline (plan.pp={plan.pp}): build the "
                         "loss with repro_torch.train.pipeline.pipelined_loss_fn and compose "
                         "the step around it")
    ctx = resolve_context(model.cfg, plan, mesh)
    dmesh = data_mesh(mesh)
    loss_fn = (make_loss_fn(model, hyper) if ctx.is_local
               else make_executor_loss_fn(model.cfg, plan, mesh, z_loss=hyper.z_loss))
    grid_rings = {} if mesh is None or not hasattr(mesh, "ep") else {
        ("model",): mesh.model, ("cp",): mesh.cp, ("cp", "model"): mesh.ep}

    def splits(axes):
        """(ring, names) of the leaves split over each model-parallel ring."""
        out: Dict[tuple, set] = {}
        for name, a in axes.items():
            if a:
                out.setdefault(a, set()).add(name)
        return [(grid_rings[a], names) for a, names in out.items()]
    n = plan.microbatches

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params, opt = state
        for p in leaves(params):
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        aux = torch.zeros((), dtype=torch.float32, device=model.device)
        mbs = (_split_microbatches(batch, n) if mesh is None
               else rank_microbatches(batch, dmesh, n))
        for mb in mbs:
            total, parts = loss_fn(params, mb)
            (total / n).backward()
            loss += total.detach() / n
            aux += parts["moe_aux"].detach() / n
        axes = sum_grid_grads(params, plan, ctx)
        lr = cosine_schedule(opt.step, hyper.peak_lr, hyper.warmup_steps,
                             hyper.total_steps)
        specs = None
        if mesh is None:
            grads = map_tree(lambda p: p.grad, params)
            grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip)
            params, opt = adamw_update(grads, opt, params, lr,
                                       weight_decay=hyper.weight_decay)
        else:
            specs = opt_state_specs(params, dmesh, plan)
            grads = _scatter_grads(params, specs, dmesh)
            grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip, mesh=dmesh,
                                               specs=specs, splits=splits(axes))
            params, opt = adamw_update_sharded(grads, opt, params, lr, mesh=dmesh,
                                               specs=specs, weight_decay=hyper.weight_decay)
            loss, aux = dmesh.all_reduce_mean(torch.stack([loss, aux]))
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, "moe_aux": aux}
        if plan.integrity == "audit":
            metrics["integrity_checksum"], metrics["integrity_div"] = audit(
                params, grads, dmesh, specs)
        return TrainState(params, opt), metrics

    return train_step
