"""Train step: loss + grad + clip + AdamW, with microbatch accumulation (port of
``repro/train/step.py``, single device).

    state = init_train_state(model, gen)
    step = make_train_step(model, plan, hyper)
    state, metrics = step(state, batch)

The params are the autograd leaves (``requires_grad``). Each microbatch's
backward adds grad(loss) / ``plan.microbatches`` into ``.grad``, so ``.grad``
ends as the reference's mean over microbatches with no second fp32 buffer.
Clipping and AdamW then update the grads, params and moments in place
(``repro_torch.optim``). The reference's mesh, ZeRO-1 and overlap-TP paths come
with the distributed slices: a mesh raises, naming them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import torch

from repro_torch.core.config import ParallelPlan
from repro_torch.models.families import Model
from repro_torch.optim import (AdamWState, adamw_init, adamw_update,
                               clip_by_global_norm, cosine_schedule)
from repro_torch.core.tree import leaves, map_tree
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


def init_train_state(model: Model, gen: torch.Generator) -> TrainState:
    """Fresh params from ``gen`` (as autograd leaves) and zero fp32 moments."""
    params = model.init(gen)
    for p in leaves(params):
        p.requires_grad_(True)
    return TrainState(params, adamw_init(params))


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


def make_train_step(model: Model, plan: ParallelPlan, hyper: Hyper = Hyper(),
                    mesh=None) -> Callable:
    """The step for ``model`` under ``plan`` (``microbatches``; ``remat`` is the
    model's). ``batch`` holds tensors on the model's device."""
    if mesh is not None:
        raise NotImplementedError(
            "a mesh (data parallelism with ZeRO-1, overlap tensor parallelism, "
            "context/expert/pipeline parallelism) comes with the port's "
            "distributed slices; this step runs on one device")
    plan.validate(model.cfg)
    loss_fn = make_loss_fn(model, hyper)
    n = plan.microbatches

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]):
        params, opt = state
        for p in leaves(params):
            p.grad = None
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        aux = torch.zeros((), dtype=torch.float32, device=model.device)
        for mb in _split_microbatches(batch, n):
            total, parts = loss_fn(params, mb)
            (total / n).backward()
            loss += total.detach() / n
            aux += parts["moe_aux"].detach() / n
        grads = map_tree(lambda p: p.grad, params)
        grads, gnorm = clip_by_global_norm(grads, hyper.grad_clip)
        lr = cosine_schedule(opt.step, hyper.peak_lr, hyper.warmup_steps,
                             hyper.total_steps)
        params, opt = adamw_update(grads, opt, params, lr,
                                   weight_decay=hyper.weight_decay)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr, "moe_aux": aux}
        return TrainState(params, opt), metrics

    return train_step
