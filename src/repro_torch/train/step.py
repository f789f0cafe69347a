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

The MoE family raises under more than one rank: its capacity queues and the
load-balancing aux are global over the batch in the reference, which
per-rank routing would change (ROADMAP A13.4).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import torch

from repro_torch.core.config import Family, ParallelPlan
from repro_torch.core.sharding import LeafSpec, dim_first, opt_state_specs
from repro_torch.core.tree import from_names, leaves, map_tree, named_leaves
from repro_torch.ft.integrity import audit
from repro_torch.launch.mesh import rank_microbatches
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
    (this rank's slices). Every rank must draw the same params: pass
    generators seeded alike."""
    params = model.init(gen)
    for p in leaves(params):
        p.requires_grad_(True)
    if mesh is None:
        return TrainState(params, adamw_init(params))
    specs = opt_state_specs(params, mesh, plan or model.plan)
    return TrainState(params, adamw_init(params, mesh=mesh, specs=specs))


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


def make_train_step(model: Model, plan: ParallelPlan, hyper: Hyper = Hyper(),
                    mesh=None) -> Callable:
    """The step for ``model`` under ``plan`` (``microbatches``, ``zero_stage``;
    ``remat`` is the model's). ``batch`` holds the global batch's tensors on
    the model's device; with a data ``mesh``, the same on every rank."""
    plan.validate(model.cfg)
    if mesh is not None and mesh.size > 1 and model.cfg.family == Family.MOE:
        raise NotImplementedError(
            "data parallelism over the MoE family: its capacity queues and "
            "load-balancing aux are global over the batch in the reference, and "
            "per-rank routing would change them; this comes with expert "
            "parallelism (ROADMAP A13.4)")
    loss_fn = make_loss_fn(model, hyper)
    n = plan.microbatches

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params, opt = state
        for p in leaves(params):
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        aux = torch.zeros((), dtype=torch.float32, device=model.device)
        mbs = (_split_microbatches(batch, n) if mesh is None
               else rank_microbatches(batch, mesh, n))
        for mb in mbs:
            total, parts = loss_fn(params, mb)
            (total / n).backward()
            loss += total.detach() / n
            aux += parts["moe_aux"].detach() / n
        lr = cosine_schedule(opt.step, hyper.peak_lr, hyper.warmup_steps,
                             hyper.total_steps)
        specs = None
        if mesh is None:
            grads = map_tree(lambda p: p.grad, params)
            grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip)
            params, opt = adamw_update(grads, opt, params, lr,
                                       weight_decay=hyper.weight_decay)
        else:
            specs = opt_state_specs(params, mesh, plan)
            grads = _scatter_grads(params, specs, mesh)
            grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip, mesh=mesh,
                                               specs=specs)
            params, opt = adamw_update_sharded(grads, opt, params, lr, mesh=mesh,
                                               specs=specs, weight_decay=hyper.weight_decay)
            loss, aux = mesh.all_reduce_mean(torch.stack([loss, aux]))
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, "moe_aux": aux}
        if plan.integrity == "audit":
            metrics["integrity_checksum"], metrics["integrity_div"] = audit(
                params, grads, mesh, specs)
        return TrainState(params, opt), metrics

    return train_step
