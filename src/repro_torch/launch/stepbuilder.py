"""Build (step fn, example args, placement, meta) for any (arch x input shape
x mesh x plan): the port of ``repro/launch/stepbuilder.py``, the single entry
point of the trainer, the dry run and the benchmarks.

    fn, args, placement, meta = build_step("qwen1.5-4b", "train_4k", None, plan)
    state = init_train_state(meta["model"], gen, None, plan)
    state, metrics = fn(state, batch)

- train:   ``fn(state, batch) -> (state, metrics)`` (``make_train_step``)
- prefill: ``fn(params, batch) -> logits`` (the model's ``forward``, as the
  reference's; serving records no autograd graph)
- decode:  ``fn(params, cache, tokens, pos) -> (logits, cache)``

``args`` are tensors on the ``meta`` device with the named shape's global
shapes and dtypes (``configs.input_specs``; the params and moments whole, as
the reference's ``ShapeDtypeStruct``s are global): building them allocates
nothing. The fn takes any batch whose rows the rank's placement accepts, not
only the named shape's: the phases of ``chip_smoke.py`` run it on their own
rows. ``placement`` mirrors ``args`` with the rank's layout, where the
reference gives ``NamedSharding``s: for the params, the spec of each leaf by
name (``core.sharding.param_spec``: the tp and ep cuts), or its ZeRO-3
``LeafSpec`` under ``plan.dp_shard`` > 1 (``fsdp_specs``); for the moments,
``opt_state_specs`` on what the rank holds of each param; for the decode
cache, ``cache_specs``; for a batch tensor, its rows over ``batch_axes``.

``mesh`` is None for one device, a ``DataMesh`` or ``GridMesh``, or any
object with ``shape`` (and ``rank``), such as the shape-only stand-ins of the
tests: on a stand-in the placement and the example args are real, but the
model is built on the meta device and no fn runs. ``device=None`` is the
card, as for ``build_model``.

The reference's ``jit_step`` has no counterpart: its donation of the train
state buys an update in place, which the port's step already does (params,
grads and moments are updated in place, ``train/step.py``). ``plan.pp`` > 1
is refused, as ``make_train_step`` refuses it: a pipelined step is composed
around ``train.pipeline.pipelined_loss_fn`` (``chip_smoke.pp_train_step``).
"""

from __future__ import annotations

import dataclasses
import types
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import decode_input_specs, input_specs
from repro_torch.core import ParallelPlan, SHAPES_BY_NAME, get_config, get_smoke_config
from repro_torch.core.config import InputShape, ModelConfig
from repro_torch.core.sharding import (cache_specs, fsdp_specs, opt_state_specs, param_spec,
                                       spec_axes)
from repro_torch.core.tree import from_names, named_leaves, stacked_shape
from repro_torch.models import build_model
from repro_torch.optim import AdamWState, adamw_init
from repro_torch.train import Hyper, TrainState, make_train_step
from .mesh import DataMesh, GridMesh, batch_axes_for


def resolve_config(arch: str, shape_name: str, smoke: bool = False) -> ModelConfig:
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if shape_name == "long_500k" and cfg.arch_id == "gemma2-9b":
        cfg = dataclasses.replace(cfg, long_context=True)   # sliding-window variant
    return cfg


def skip_reason(cfg: ModelConfig, shape: InputShape) -> Optional[str]:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full-attention arch: long_500k skipped per DESIGN.md §4"
    return None


class _MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads ``meta``. ``Model.init`` draws
    every leaf on ``gen.device`` from ``gen``; ``torch.rand`` on the meta
    device takes a CPU generator and allocates nothing, so ``init`` with this
    generator gives the params' shapes and dtypes only."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def meta_params(model) -> Any:
    """``model``'s whole params on the meta device (nothing allocated)."""
    return model.init(_MetaGenerator())


def _domain(mesh, plan: ParallelPlan) -> int:
    """The ranks of the data domain: the data axis, times the model axis
    under ``dp_over_model`` (``launch.mesh.data_mesh``)."""
    if mesh is None:
        return 1
    n = int(mesh.shape.get("data", 1))
    return n * int(mesh.shape.get("model", 1)) if plan.dp_over_model else n


def _rank_shape(shape, spec, sizes: Dict[str, int]):
    """What one rank holds of a whole leaf of ``shape`` under ``spec``."""
    out = list(shape)
    for d, entry in enumerate(spec):
        for axis in spec_axes((entry,)):
            out[d] //= int(sizes.get(axis, 1))
    return tuple(out)


def _placements(params, plan: ParallelPlan, mesh):
    """(the params' placement by name, the moments' by name). The moments'
    rule reads the data domain as a mesh's ``shape``."""
    domain = types.SimpleNamespace(shape={"data": _domain(mesh, plan)})
    if plan.dp_shard > 1 and mesh is not None:
        return fsdp_specs(params, domain.shape["data"]), opt_state_specs(params, domain, plan)
    sizes = dict(mesh.shape) if mesh is not None else {}
    specs, held = {}, {}
    for name, leaf in named_leaves(params):
        shape = stacked_shape(leaf)
        specs[name] = param_spec(name, shape, plan)
        held[name] = torch.empty(_rank_shape(shape, specs[name], sizes), device="meta")
    return specs, opt_state_specs(from_names(held), domain, plan)


def _batch_placement(batch: Dict[str, torch.Tensor], baxes):
    return {k: (tuple(baxes) if baxes else None,) + (None,) * (v.dim() - 1)
            for k, v in batch.items()}


def _on_stand_in(*_):
    raise RuntimeError("build_step on a stand-in mesh gives the placement and example args; "
                       "its fn runs on one device, a DataMesh or a GridMesh")


def build_step(arch, shape_name, mesh=None, plan: Optional[ParallelPlan] = None,
               smoke: bool = False, device=None):
    """Returns ``(fn, args, placement, meta)`` (module docstring); ``meta``
    holds ``cfg``, ``shape``, ``batch_axes`` (the reference's rule on the
    named shape's global batch) and ``model``. ``arch`` may be a
    ``ModelConfig`` (a config cut in depth, say) and ``shape_name`` an
    ``InputShape`` (a cell's own rows), as the dry run's estimator passes
    them (``launch/dryrun.py``)."""
    shape = shape_name if isinstance(shape_name, InputShape) else SHAPES_BY_NAME[shape_name]
    cfg = (arch if isinstance(arch, ModelConfig)
           else resolve_config(arch, shape.name, smoke))
    reason = skip_reason(cfg, shape)
    if reason:
        raise ValueError(reason)
    plan = plan or ParallelPlan()
    if plan.pp > 1:
        raise ValueError(f"build_step builds no pipeline (plan.pp={plan.pp}): compose the step "
                         "around repro_torch.train.pipeline.pipelined_loss_fn")
    baxes = (batch_axes_for(mesh, shape.global_batch, plan.pp, plan.dp_over_model)
             if mesh is not None else ())
    live = mesh is None or isinstance(mesh, (DataMesh, GridMesh))
    model = build_model(cfg, plan, device=device if live else "meta",
                        mesh=mesh if live else None)
    params = meta_params(model)
    pspecs, ospecs = _placements(params, plan, mesh)
    meta = {"cfg": cfg, "shape": shape, "batch_axes": baxes, "model": model}

    if shape.kind == "train":
        fn = make_train_step(model, plan, Hyper(), mesh=mesh) if live else _on_stand_in
        state = TrainState(params, adamw_init(params))
        batch = input_specs(cfg, shape)
        placement = (TrainState(pspecs, AdamWState(step=(), mu=ospecs, nu=ospecs)),
                     _batch_placement(batch, baxes))
        return fn, (state, batch), placement, meta

    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill(params, batch):
            logits, _ = model.forward(params, batch)
            return logits
        batch = input_specs(cfg, shape)
        return (prefill if live else _on_stand_in, (params, batch),
                (pspecs, _batch_placement(batch, baxes)), meta)

    specs = decode_input_specs(cfg, shape, model)
    cspecs = cache_specs(specs["cache"], plan, mesh, baxes)

    @torch.no_grad()
    def decode(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, int(pos))
    args = (params, specs["cache"], specs["tokens"], specs["pos"])
    placement = (pspecs, cspecs, (tuple(baxes) if baxes else None,), ())
    return decode if live else _on_stand_in, args, placement, meta
