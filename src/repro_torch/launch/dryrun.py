"""Multi-pod dry run (port of ``repro/launch/dryrun.py``): what one rank of the
production grid would hold and move for every (architecture x input shape x
mesh), with no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun                # pod16x16
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch olmoe-1b-7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --both-meshes --out /tmp/dry

The reference lowers and compiles each step against ``ShapeDtypeStruct``s on
512 placeholder devices and reads XLA's ``memory_analysis`` and an HLO walk.
The port has no compiler, so it runs rank 0's real step, whole (forward,
backward with its remat, the clip and AdamW, the rings and the data sums),
on meta tensors (shapes, dtypes and strides, no memory) under
``kernels.build.fake_card``, which puts them on the kernels' route: the
dispatchers' ``"auto"`` picks each kernel as on the card, and each launch
function returns before its kernel with the outputs its wrapper allocated
(``kernels.build.traced``): nothing is built or launched. Meta tensors, not
``FakeTensorMode``'s: a backward on fake ``cuda`` tensors asks the CUDA
runtime for a stream, which needs a visible card, and fake tensors are a
tensor subclass, on which PyTorch's backward formulas take out-of-place
variants a plain run does not (the tracker undoes that under its own
dispatch mode, ``_tracker``). The grid is joined
to a fake c10d group of the production world size (``init_grid_mesh(
backend="fake")``), so every collective runs on meta tensors and is counted by
the meshes as on the card (``collective_stats``). ``MemTracker`` follows every
allocation and free of the step and gives its peak by category. One rank is
traced, as the reference's memory analysis is one device's: the ranks are
symmetric on every even split.

Each record, ``<tag>__<arch>__<shape>__<mesh>.json`` under ``--out``:

- ``status``: ``ok``; ``skipped`` (the reference's ``skip_reason``, word for
  word); ``unsupported`` (a placement the port refuses: ``reason`` is the
  port's own message, ``lifted_by`` the ROADMAP item that would lift it); or
  ``failed`` (anything else; the CLI then exits 1, as the reference's does);
- ``plan``: ``dataclasses.asdict`` of the plan;
- ``placement_bytes``: what rank 0 holds by ``build_step``'s placement, by
  part (params, grads, AdamW moments, the decode cache, the batch rows):
  arithmetic on a shape-only stand-in of the mesh, nothing allocated;
- ``traced``: the peak of rank 0's step by category, and in all, from the
  trace, with what the rank held when the step began;
- ``collectives``: count, result bytes and link bytes by ring and kind, from
  the meshes' counters during the step (the reference walks its HLO);
- ``roofline``: ``perf.roofline.Roofline(...).row()`` from the port's
  reckoned FLOPs, its floor of bytes and the traced link bytes;
- ``trace_s``: the host seconds of the traced step (the reference's
  ``lower_s`` / ``compile_s``);
- ``notes``: every way the record differs from the reference's.

:func:`estimate` is the estimator under :func:`run_one`: it takes a config or
an arch, an ``InputShape`` and a mesh shape (None: one device), so
``chip_smoke.py`` and the tests call it on their own rows; :func:`record` is
its part before the trace (status, plan, placement bytes, notes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.core import ARCH_IDS, INPUT_SHAPES, SHAPES_BY_NAME, ParallelPlan
from repro_torch.core.config import Family, InputShape, ModelConfig
from repro_torch.core.sharding import LeafSpec, spec_axes
from repro_torch.core.tree import leaves, named_leaves, stacked_shape
from repro_torch.perf.roofline import (CollectiveStats, Roofline, decode_bytes, decode_flops,
                                       model_flops_for, train_bytes, train_flops)
from .stepbuilder import build_step, resolve_config, skip_reason

# the reference's production meshes (``repro/launch/mesh.py:23-35``)
MESHES = {False: ("pod16x16", {"data": 16, "model": 16}),
          True: ("pod2x16x16", {"pod": 2, "data": 16, "model": 16})}

# the port's refusals of a placement, and the ROADMAP items that lift them
PODS_AS_DATA = ("the port runs a pod axis as pipeline stages only: resolve_context takes "
                "plan.pp equal to its size, build_step refuses pp > 1, and a pod axis of "
                "data replicas (pp 1) is not ported")
LIFTED_BY = {
    "pods": "ROADMAP A14.7 (pods as data replicas on a pod axis with pp 1)",
    "family": "ROADMAP A14.8 (the model axis for the encoder-decoder, VLM and hybrid "
              "families)",
    "uneven": "ROADMAP A14.9 (the tp rings at a degree that does not divide the heads, "
              "the KV heads or the vocabulary)",
}

def default_plan(arch: str) -> ParallelPlan:
    """The reference's baseline recipe: TP over ``model``, DP + ZeRO-1 over
    ``data``, full remat, EP 16 for the MoE arches (folded onto the 16-wide
    tp ring)."""
    cfg = resolve_config(arch, "train_4k")
    return ParallelPlan(tp=16, dp_shard=1, zero_stage=1,
                        ep=16 if cfg.family == Family.MOE else 1, remat="full")


def plan_from_args(arch: str, args) -> ParallelPlan:
    """``default_plan`` with the CLI's overrides, field for field the
    reference's."""
    plan = default_plan(arch)
    overrides = {}
    if args.dp_shard is not None:
        overrides["dp_shard"] = args.dp_shard
    if args.remat is not None:
        overrides["remat"] = args.remat
    if args.zero is not None:
        overrides["zero_stage"] = args.zero
    if args.no_ep:
        overrides["ep"] = 1
    if args.no_seq_shard:
        overrides["seq_shard_decode"] = False
        overrides["seq_shard_attn"] = False
    if args.pad_vocab:
        overrides["pad_vocab_to_multiple"] = args.pad_vocab
    if args.microbatches:
        overrides["microbatches"] = args.microbatches
    if args.dp_over_model:
        overrides["dp_over_model"] = True
        overrides["ep"] = 1
    if args.moe_dispatch:
        overrides["moe_dispatch"] = args.moe_dispatch
    return dataclasses.replace(plan, **overrides) if overrides else plan


class StandIn:
    """A shape-only stand-in of a mesh (``shape``, ``rank``): ``build_step``
    gives its placement and meta-device example args."""

    def __init__(self, shape: Dict[str, int], rank: int = 0):
        self.shape, self.rank = dict(shape), rank


def refusal(cfg: ModelConfig, shape: InputShape, plan: ParallelPlan,
            mesh_shape: Optional[Dict[str, int]]):
    """``(message, ROADMAP item)`` when the port refuses this placement, else
    None. A pod axis of data replicas is refused for every step; a train step
    is refused where ``train.executor.resolve_context`` refuses the plan on the
    grid (the same checks, on the shape alone)."""
    from repro_torch.train.executor import check_cp_support  # noqa: PLC0415
    from repro_torch.train.tensor_parallel import (check_overlap_support,  # noqa: PLC0415
                                                   decoder_only_support_errors)
    if not mesh_shape:
        return None
    if mesh_shape.get("pod", 1) != plan.pp:
        return PODS_AS_DATA, LIFTED_BY["pods"]
    if shape.kind != "train":
        return None
    model = mesh_shape.get("model", 1)
    tp = 1 if plan.dp_over_model else model
    try:
        if plan.ep > 1 and plan.tp == 1 and plan.cp == 1:
            check_cp_support(cfg, plan.ep)
        elif tp > 1:
            check_overlap_support(cfg, plan, tp)
    except ValueError as e:
        item = "family" if decoder_only_support_errors(cfg) else "uneven"
        return f"resolve_context: {e}", LIFTED_BY[item]
    return None


# ---------------------------------------------------------------------------
# placement arithmetic


def _nbytes(shape, dtype) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n * torch.empty((), dtype=dtype).element_size()


def _held(shape, spec, sizes, domain: int):
    """Rank 0's shape of a whole leaf under a param, moment or cache spec, or a
    ZeRO ``LeafSpec``: a dim split over n ranks gives rank 0 ceil(d / n) of it,
    as a padded uneven split would (the port's rings refuse uneven splits; a
    serving rank holds the whole params whatever its spec)."""
    if isinstance(spec, LeafSpec):
        out = list(spec.shape)
        if spec.dim is not None:
            out[spec.dim] = -(-out[spec.dim] // domain)
        return tuple(out)
    out = list(shape)
    for d, entry in enumerate(spec):
        for axis in spec_axes((entry,)):
            out[d] = -(-out[d] // int(sizes.get(axis, 1)))
    return tuple(out)


def placement_bytes(cfg, shape: InputShape, mesh_shape, plan: ParallelPlan) -> Dict[str, int]:
    """What rank 0 holds by ``build_step``'s placement on a shape-only
    stand-in of ``mesh_shape`` (one device when None), by part; nothing is
    allocated."""
    sizes = dict(mesh_shape or {})
    _, args, placement, meta = build_step(cfg, shape, StandIn(sizes), plan)
    domain = sizes.get("data", 1) * (sizes.get("model", 1) if plan.dp_over_model else 1)
    params = args[0].params if shape.kind == "train" else args[0]
    pspecs = placement[0].params if shape.kind == "train" else placement[0]
    out = {"params": 0, "grads": 0, "optimizer": 0, "cache": 0, "batch": 0}
    for name, leaf in named_leaves(params):
        dtype = (leaf[0] if isinstance(leaf, list) else leaf).dtype
        out["params"] += _nbytes(_held(stacked_shape(leaf), pspecs[name], sizes, domain), dtype)
    if shape.kind == "train":
        out["grads"] = out["params"]
        for spec in placement[0].opt.mu.values():
            out["optimizer"] += 2 * _nbytes(_held(spec.shape, spec, sizes, domain), spec.dtype)
        batch, bspecs = args[1], placement[1]
    elif shape.kind == "prefill":
        batch, bspecs = args[1], placement[1]
    else:
        for name, t in named_leaves(args[1]):
            out["cache"] += _nbytes(_held(t.shape, placement[1][name], sizes, domain), t.dtype)
        batch, bspecs = {"tokens": args[2]}, {"tokens": placement[2]}
    for k, t in batch.items():
        out["batch"] += _nbytes(_held(t.shape, bspecs[k], sizes, domain), t.dtype)
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# the fake trace


class _Generator(torch.Generator):
    """A CPU generator whose ``device`` reads the trace's (``meta``, or
    ``cpu`` for the tests' real run): ``Model.init`` draws every leaf on
    ``gen.device``, on the meta device nothing but the params' shapes and
    dtypes."""

    def __new__(cls, device):
        gen = super().__new__(cls)
        gen._device = torch.device(device)
        return gen

    def __init__(self, device):
        super().__init__()

    @property
    def device(self) -> torch.device:
        return self._device


# the out-of-place ops PyTorch's backward formulas take on a tensor subclass
# (or under a dispatch mode) where a plain tensor gets the in-place one
IN_PLACE = {torch.ops.aten.scatter_add.default: torch.ops.aten.scatter_add_.default,
            torch.ops.aten.scatter.src: torch.ops.aten.scatter_.src,
            torch.ops.aten.scatter.value: torch.ops.aten.scatter_.value,
            torch.ops.aten.index_put.default: torch.ops.aten.index_put_.default}


def _tracker():
    """A ``MemTracker`` (it reads storages' sizes, so it follows meta tensors
    as real ones) that is told each input's category (the port's params
    are tensors, not an ``nn.Module``'s, and its AdamW is no
    ``torch.optim`` optimizer): ``track(tree, kind)``, and a param's
    ``.grad`` counted as a gradient once it is accumulated.

    It also keeps what autograd does in place. While a dispatch mode is
    active (the tracker is one) PyTorch treats every tensor as a subclass,
    and its backward formulas and engine then take their out-of-place
    variants, which allocate a buffer the card's run never does. On the card
    that was a logits-sized 2.4-3.4 GB in the training cells, from the cross
    entropy's gather backward (``new_zeros`` then ``scatter_add`` where the
    plain run takes ``scatter_add_``; PERF.md §6). So, in the
    backward, an op of :data:`IN_PLACE` on a tensor the running node has
    just made runs as its in-place variant; and an ``add`` of a gradient an
    earlier node made to one the running node made, of one shape (the
    engine's accumulation into the buffer it holds, in place in a plain
    run), takes no peak (its result replaces the older buffer, which the
    engine drops at once).

    It reads private parts of PyTorch (``torch._C._current_autograd_node``,
    ``MemTracker``'s ``_update_peak_stats``, ``_update_and_maybe_create_winfos``
    and ``_mod_tracker``). Checked on torch 2.13.0 (CPU): a train step's peak
    within 1% of the same step run with no dispatch mode
    (``tests/test_torch_dryrun.py::test_tracker_peak_matches_a_run_without_a_dispatch_mode``);
    and on torch 2.11.0+cu128 on an H100: the five single-device training
    cells' peaks within 3% of ``max_memory_allocated`` (``chip_smoke.py``
    phase 21)."""
    from torch.distributed._tools.mem_tracker import MemTracker, _MemRefType  # noqa: PLC0415
    from torch.utils.weak import WeakIdKeyDictionary  # noqa: PLC0415
    add = torch.ops.aten.add.Tensor

    class Tracker(MemTracker):
        KINDS = {v: getattr(_MemRefType, k) for k, v in
                 (("PARAM", "params"), ("GRAD", "grads"), ("OPT", "optimizer"),
                  ("BUFFER", "cache"), ("OTH", "inputs"))}
        _made_by = None
        _accumulating = False

        def _node(self):
            """The running backward node, as its sequence number and name (it
            takes no weak reference, a strong one would keep its saved
            tensors, and its Python wrapper, so its ``id``, may be made anew
            at each call), or None."""
            node = torch._C._current_autograd_node()
            return None if node is None else (node._sequence_nr(), node.name())

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            node = self._node() if self._mod_tracker.is_bw else None
            if (node is not None and func in IN_PLACE and isinstance(args[0], torch.Tensor)
                    and self._made_by.get(args[0].untyped_storage()) == node):
                func = IN_PLACE[func]
            self._accumulating = (
                func is add and node is not None and len(args) == 2
                and all(isinstance(a, torch.Tensor) for a in args)
                and args[0].shape == args[1].shape
                and sorted(self._made_by.get(a.untyped_storage()) == node for a in args)
                == [False, True])
            try:
                res = super().__torch_dispatch__(func, types, args, kwargs)
            finally:
                self._accumulating = False
            if node is not None:
                for t in leaves(res if isinstance(res, (tuple, list)) else [res]):
                    if isinstance(t, torch.Tensor):
                        self._made_by[t.untyped_storage()] = node
            return res

        def _update_peak_stats(self, peak_state):
            if not self._accumulating:
                super()._update_peak_stats(peak_state)

        def _grad(self, p):
            self._update_and_maybe_create_winfos(p.grad, self.KINDS["grads"])

        def track(self, tree, kind: str):
            for t in leaves(tree):
                if isinstance(t, torch.Tensor):
                    self._update_and_maybe_create_winfos(t, self.KINDS[kind])
                    if t.grad is not None:
                        self._grad(t)
                    if kind == "params" and t.requires_grad:
                        self._hooks.append(t.register_post_accumulate_grad_hook(self._grad))

        def __enter__(self):
            self._hooks, self._made_by = [], WeakIdKeyDictionary()
            return super().__enter__()

        def __exit__(self, *exc):
            for h in self._hooks:
                h.remove()
            return super().__exit__(*exc)

        def by_category(self, which: str) -> Dict[str, int]:
            snap = self.get_tracker_snapshot(which)
            dev = next(iter(snap.values()), {})
            out = {name: int(dev.get(getattr(_MemRefType, k), 0))
                   for k, name in (("PARAM", "params"), ("GRAD", "grads"), ("OPT", "optimizer"),
                                   ("ACT", "activations"), ("TEMP", "temporaries"),
                                   ("BUFFER", "cache"), ("OTH", "inputs"))}
            out["total"] = int(dev.get("Total", 0))
            return out
    return Tracker()


def _rings(mesh) -> Dict[str, Any]:
    """The grid's meshes and rings by name, each once."""
    if mesh is None:
        return {}
    out, seen = {}, set()
    for name in ("data", "flat", "model", "cp", "ep", "pod"):
        ring = getattr(mesh, name, None)
        if ring is not None and getattr(ring, "group", None) is not None and id(ring) not in seen:
            seen.add(id(ring))
            out[name] = ring
    return out


def _stats(before: Dict[str, CollectiveStats], rings) -> Dict[str, Any]:
    """The collectives the rings counted since ``before``, by ring and kind
    (kinds with none left out), and their link bytes in all."""
    out, total = {}, 0.0
    for name, ring in rings.items():
        d = ring.collective_stats() - before[name]
        kinds = {k: {"count": d.counts[k], "result_bytes": d.result_bytes[k],
                     "link_bytes": d.link_bytes[k]} for k in d.counts if d.counts[k]}
        if kinds:
            out[name] = kinds
        total += d.total_link_bytes
    return {"by_ring": out, "link_bytes": total}


def _rows(model, rows: int):
    lo, hi = model.place.rows(rows)
    return hi - lo


def _inputs(shape: InputShape, model, args, plan, mesh, device):
    """The rank's inputs of the step on ``device``, by category:
    ``(call args, {category: tree})``. A decode step runs at the cache's last
    position."""
    from repro_torch.train import init_train_state  # noqa: PLC0415
    gen = _Generator(device)

    def like(t, rows=None):
        shape = tuple(t.shape) if rows is None else (rows,) + tuple(t.shape[1:])
        return torch.zeros(shape, dtype=t.dtype, device=device)
    if shape.kind == "train":
        state = init_train_state(model, gen, mesh, plan)
        batch = {k: like(v) for k, v in args[1].items()}    # every rank holds the global batch
        return (state, batch), {"params": state.params, "optimizer": [state.opt.mu, state.opt.nu],
                                "inputs": batch}
    params = model.init(gen)
    if shape.kind == "prefill":
        rows = _rows(model, next(iter(args[1].values())).shape[0])
        batch = {k: like(v, rows) for k, v in args[1].items()}
        return (params, batch), {"params": params, "inputs": batch}
    cache = model.init_cache(shape.global_batch, shape.seq_len)
    tokens = like(args[2])
    return ((params, cache, tokens, shape.seq_len - 1),
            {"params": params, "cache": cache, "inputs": tokens})


def trace_step(cfg: ModelConfig, shape: InputShape, plan: ParallelPlan,
               mesh_shape: Optional[Dict[str, int]] = None, *, rank: int = 0,
               meta: bool = True, kernels: bool = True,
               init_method: Optional[str] = None) -> Dict[str, Any]:
    """Rank ``rank``'s step (``build_step``'s fn) run whole under
    ``MemTracker``: on meta tensors over a fake group of the grid's world
    size (``meta``; the kernels' route under ``kernels.build.fake_card`` when
    ``kernels``, else the plain route), or on real CPU tensors over a gloo
    grid joined at ``init_method`` (the plain route: the tests' check of the
    trace). A train step runs once untracked first (the steady state of a
    training loop: what the step before leaves, such as the grads one device
    keeps). Returns the peak by category, what the rank held at
    the step's start, the collectives, the roofline's inputs and the step's
    host seconds."""
    from contextlib import ExitStack  # noqa: PLC0415
    from repro_torch.kernels.build import fake_card  # noqa: PLC0415
    from .mesh import init_grid_mesh  # noqa: PLC0415
    grid = None
    device = "meta" if meta else "cpu"
    with ExitStack() as stack:
        if meta and kernels:
            stack.enter_context(fake_card())
        if mesh_shape:
            grid = init_grid_mesh(data=mesh_shape.get("data", 1), model=mesh_shape.get("model", 1),
                                  cp=mesh_shape.get("cp", 1), pod=mesh_shape.get("pod", 1),
                                  device=device, backend="fake" if meta else "gloo",
                                  init_method=init_method or "env://", rank=rank,
                                  dp_over_model=plan.dp_over_model)
        try:
            fn, args, _, meta_ = build_step(cfg, shape, grid, plan, device=device)
            model = meta_["model"]
            call, cats = _inputs(shape, model, args, plan, grid, device)
            if shape.kind == "train":
                call = (fn(*call)[0], call[1])
                cats["params"], cats["optimizer"] = call[0].params, [call[0].opt.mu,
                                                                     call[0].opt.nu]
            rings = _rings(grid)
            before = {name: ring.collective_stats() for name, ring in rings.items()}
            mt = _tracker()
            with mt:
                for kind, tree in cats.items():
                    mt.track(tree, kind)
                start = mt.by_category("current")
                t0 = time.perf_counter()
                out = fn(*call)
                seconds = time.perf_counter() - t0
            collectives = _stats(before, rings)
            whole = args[0].params if shape.kind == "train" else args[0]
            extra = {}
            if shape.kind == "decode":
                ring = model.place.ring
                extra["t"] = (shape.seq_len // ring.size if getattr(call[1], "seq_sharded", False)
                              else shape.seq_len)
                extra["rows"] = _rows(model, shape.global_batch)
            elif shape.kind == "prefill":
                extra["rows"] = int(next(iter(call[1].values())).shape[0])
            floor = (train_bytes(call[0].params, [call[0].opt.mu, call[0].opt.nu])
                     if shape.kind == "train"
                     else decode_bytes(call[0], call[1] if shape.kind == "decode" else {}))
            del out
            return {"peak": mt.by_category("peak"), "start": start, "collectives": collectives,
                    "trace_s": seconds, "whole": whole, "floor": floor, **extra}
        finally:
            if grid is not None:
                grid.close()


def _flops(cfg, shape: InputShape, chips: int, whole, trace) -> float:
    """The reckoned FLOPs of the traced rank's step (module docstring)."""
    if shape.kind == "train":
        return train_flops(cfg, shape.seq_len, shape.global_batch * shape.seq_len,
                           params=whole) / chips
    if shape.kind == "prefill":
        return train_flops(cfg, shape.seq_len, trace["rows"] * shape.seq_len, params=whole,
                           backward=False)
    return decode_flops(cfg, trace["rows"], trace["t"], params=whole)


def notes_for(cfg: ModelConfig, shape: InputShape, plan: ParallelPlan, mesh_shape) -> list:
    """How a record differs from the reference's dry run of the same case."""
    n = 1
    for v in (mesh_shape or {}).values():
        n *= v
    out = [f"rank 0's step traced on fake tensors over a fake process group of {n} ranks "
           "(the ranks are symmetric on every even split), not a compiled program: memory "
           "from MemTracker in place of memory_analysis, trace_s in place of lower_s and "
           "compile_s",
           "collectives counted by the port's meshes where they run (collective_stats, the "
           "reference's ring model of link bytes) in place of an HLO walk",
           "roofline flops from the port's reckoning (train_flops, decode_flops: no "
           "recompute, no dispatch einsums) and bytes from a floor (params, grads and "
           "moments, or params and cache, read and written once), not from cost_analysis"]
    if shape.kind == "train":
        out.append("every rank holds the global batch's tensors and runs its rows of them; "
                   "placement_bytes counts the rows only")
        if plan.tp > 1 and plan.zero_stage >= 1:
            out.append("ZeRO-1 under tp splits each moment on the largest dim of the rank's "
                       "TP shard, which may be the dim the model axis splits; the reference "
                       "judges the whole leaf (ROADMAP queue C): the bytes a rank holds are "
                       "the same")
        if cfg.family == Family.MOE:
            out.append("each expert-ring rank routes its own tokens (shard-local capacity); "
                       "the reference routes the global batch")
    else:
        out.append("serving on the grid holds the whole params on every model rank (ROADMAP "
                   "A13.6 leftover): traced params are whole, placement_bytes cut")
    if shape.kind == "prefill":
        out.append("build_step's prefill fn is the model's forward, as the reference's: the "
                   "port runs the rank's rows whole on every model rank, without the "
                   "sequence sharding of the prefill entry point")
    if shape.kind == "decode" and cfg.family in (Family.SSM, Family.HYBRID):
        out.append("the SSM state and conv tails are whole on every model rank (ROADMAP "
                   "queue C)")
    return out


def record(arch, shape: InputShape, mesh_shape: Optional[Dict[str, int]] = None,
           plan: Optional[ParallelPlan] = None, *, name: str = "") -> Dict[str, Any]:
    """A record (module docstring) for ``arch`` (an arch id or a
    ``ModelConfig``) at ``shape`` on a grid of ``mesh_shape`` (None: one
    device) under ``plan``, without the fake trace: its status, plan,
    ``placement_bytes`` and notes."""
    cfg = arch if isinstance(arch, ModelConfig) else resolve_config(arch, shape.name)
    plan = plan or ParallelPlan()
    rec: Dict[str, Any] = {"arch": cfg.arch_id, "shape": shape.name,
                           "mesh": name or ("1" if not mesh_shape else "x".join(
                               str(v) for v in mesh_shape.values())),
                           "plan": dataclasses.asdict(plan)}
    reason = skip_reason(cfg, shape)
    if reason:
        return {**rec, "status": "skipped", "reason": reason}
    refused = refusal(cfg, shape, plan, mesh_shape)
    if refused:
        return {**rec, "status": "unsupported", "reason": refused[0], "lifted_by": refused[1]}
    rec["placement_bytes"] = placement_bytes(cfg, shape, mesh_shape, plan)
    rec["notes"] = notes_for(cfg, shape, plan, mesh_shape)
    rec["status"] = "ok"
    return rec


def estimate(arch, shape: InputShape, mesh_shape: Optional[Dict[str, int]] = None,
             plan: Optional[ParallelPlan] = None, *, name: str = "") -> Dict[str, Any]:
    """:func:`record` with, on an ``ok`` record, the fake trace's
    ``traced``, ``collectives``, ``roofline`` and ``trace_s``."""
    cfg = arch if isinstance(arch, ModelConfig) else resolve_config(arch, shape.name)
    plan = plan or ParallelPlan()
    rec = record(cfg, shape, mesh_shape, plan, name=name)
    if rec["status"] != "ok":
        return rec
    t0 = time.perf_counter()
    tr = trace_step(cfg, shape, plan, mesh_shape)
    chips = 1
    for v in (mesh_shape or {}).values():
        chips *= v
    roof = Roofline(cfg.arch_id, shape.name, rec["mesh"], chips,
                    flops=_flops(cfg, shape, chips, tr["whole"], tr), bytes=tr["floor"],
                    collective_bytes=tr["collectives"]["link_bytes"],
                    model_flops=model_flops_for(cfg, shape),
                    collectives=tr["collectives"]["by_ring"])
    rec.update({"traced": {"rank": 0, "peak": tr["peak"],
                           "at_start": tr["start"]},
                "collectives": tr["collectives"], "roofline": roof.row(),
                "trace_s": tr["trace_s"], "estimate_s": time.perf_counter() - t0})
    return rec


def run_one(arch: str, shape_name: str, multi_pod: bool, plan: ParallelPlan,
            tag: str = "baseline") -> dict:
    """One record of the CLI (the reference's ``run_one``), printed."""
    mesh_name, mesh_shape = MESHES[multi_pod]
    rec = estimate(arch, SHAPES_BY_NAME[shape_name], mesh_shape, plan, name=mesh_name)
    rec["tag"] = tag
    head = f"[dryrun] {arch} × {shape_name} × {mesh_name}"
    if rec["status"] != "ok":
        print(f"{head}: {rec['status'].upper()} ({rec['reason']})", flush=True)
        return rec
    r, peak = rec["roofline"], rec["traced"]["peak"]
    print(f"{head} [{tag}]: OK (trace {rec['trace_s']:.1f}s) t_comp={r['t_compute_s']:.3e}s "
          f"t_mem={r['t_memory_s']:.3e}s t_coll={r['t_collective_s']:.3e}s -> "
          f"{r['bottleneck']}-bound; rank 0 peak {peak['total'] / 1e9:.2f} GB", flush=True)
    return rec


def parser() -> argparse.ArgumentParser:
    """The reference's flags (``repro/launch/dryrun.py:146-168``)."""
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None, choices=ARCH_IDS + [None])
    ap.add_argument("--shape", default=None, choices=[s.name for s in INPUT_SHAPES] + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--dp-shard", type=int, default=None)
    ap.add_argument("--remat", default=None, choices=["none", "selective", "full", None])
    ap.add_argument("--zero", type=int, default=None)
    ap.add_argument("--no-ep", action="store_true")
    ap.add_argument("--no-seq-shard", action="store_true")
    ap.add_argument("--pad-vocab", type=int, default=0)
    ap.add_argument("--microbatches", type=int, default=0)
    ap.add_argument("--dp-over-model", action="store_true")
    ap.add_argument("--moe-dispatch", default=None, choices=["einsum", "scatter", None])
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    archs = [args.arch] if args.arch else ARCH_IDS
    shapes = [args.shape] if args.shape else [s.name for s in INPUT_SHAPES]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    n_ok = n_skip = n_unsup = n_fail = 0
    for arch in archs:
        plan = plan_from_args(arch, args)
        for shape in shapes:
            for mp in meshes:
                mesh_name = MESHES[mp][0]
                path = out_dir / f"{args.tag}__{arch}__{shape}__{mesh_name}.json"
                if args.skip_existing and path.exists():
                    print(f"[dryrun] exists: {path.name}")
                    n_ok += 1
                    continue
                try:
                    rec = run_one(arch, shape, mp, plan, args.tag)
                    n_ok += rec["status"] == "ok"
                    n_skip += rec["status"] == "skipped"
                    n_unsup += rec["status"] == "unsupported"
                except Exception as e:       # a failed record, as the reference's
                    n_fail += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "tag": args.tag,
                           "plan": dataclasses.asdict(plan), "status": "failed",
                           "error": repr(e), "traceback": traceback.format_exc()[-4000:]}
                    print(f"[dryrun] {arch} × {shape} × {mesh_name}: FAILED {e!r}", flush=True)
                path.write_text(json.dumps(rec, indent=2, default=str))
    print(f"[dryrun] done: {n_ok} ok, {n_skip} skipped, {n_unsup} unsupported, "
          f"{n_fail} failed")
    if n_fail:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
