"""Pipeline parallelism over the grid's ``pod`` axis (port of
``repro/train/pipeline.py``, survey §4.1.3).

Stage p lives on the ranks of pod index p (``launch.mesh.GridMesh.pod``) and
holds layers ``[offset_p, offset_p + l_p)`` of ``plan.pp_layout`` (or the even
split; ``core.sharding.pp_offsets``): its params are those layers' list, plus
the embedding, final norm and head that every stage holds whole
(``core.sharding.shard_layout``). Activations move one stage a tick through
the pod ring (``ModelRing.shift(wrap=False)``). The embedding runs on stage 0
only and the head with the loss on the last stage only. The MoE aux loss
counts every stage's own layers for each microbatch it runs.

Each rank runs its own (data, cp, model) sub-grid's placement inside a tick,
as the executor places one device's layers (``train.executor
.resolve_context``): the TP rings with ``tp_embed`` and ``tp_head_nll``, the
cp rings on zigzag inputs, the expert ring folded onto cp × model. A tick of
stage p runs microbatch ``t - p`` when that is one of the M microbatches, and
is dead otherwise: a dead tick launches nothing (every rank of the stage's
rings decides alike, so their collectives stay matched) and passes its input
on. The pod shift runs on every rank at every tick, so the stage ring's sends
and receives always pair up.

Two schedules (``plan.pp_schedule``):

- ``"gpipe"``: autograd through the fill-drain of M + P - 1 ticks; the pod
  shift is an autograd Function whose backward is the reverse shift. Every
  rank's backward must run those reverse shifts in the same order, so each
  tick's output depends on its input on every rank (stage 0's embedding is
  tied to the buffer it ignores, ``_Tie``; a dead tick passes its input on),
  the last tick's output is tied to the loss, and each shift carries a param
  as an anchor: the shifts form one chain, reached from the loss and leading
  to the params, run last tick first. Autograd keeps every tick's
  activations: O(M) microbatches in flight.
- ``"1f1b"`` (the default): a ``torch.autograd.Function`` whose forward runs
  the fill-drain under ``no_grad`` and saves only the params (and the batch,
  in its closure). Its backward runs M + 2(P - 1) ticks; tick t (a) advances
  the forward recompute one stage, stashing the stage input in a ring of
  2P - 1 slots, (b) rebuilds the tick that stage p owes microbatch
  m = t - 2(P - 1) + p on the input stashed at tick m + p and takes its
  ``torch.autograd.grad`` against the seeds, and (c) shifts the input
  cotangent back one stage. O(P) stage inputs in flight. The last stage's
  step (a) computes nothing: its output goes nowhere.

**Seeds.** Each rank back-propagates its own copy of the loss with seed 1,
as the executor's loss does (``train/tensor_parallel.py``). A rank's
cross-entropy is the sum of its tokens' nll over M · mb · S (its rows and
cp chunk, over the whole sequence's S); the sums over cp and pod pass the
cotangent through (every rank consumes the sum alike), and the mean over the
data group is the value's only, its backward the identity. The aux loss is
its stage's over M, its statistics already summed over the data, cp and
expert ranks by the MoE block (``ParallelContext.aux_sum``).

**Grads.** After the backward each rank completes its grads as the
reference's ``finish`` does: summed over the cp ring and the model ring for
the leaves each does not split (the train step's ``sum_grid_grads`` rule: the
routed experts, split over the expert fold, are complete on their owner),
averaged over the data group, and summed over pod for the leaves every stage
holds. ``.grad`` on each rank then holds its part of the grads of the global
loss. In GPipe ``_Finish`` (the identity on the params, applied first) runs
this in its backward, after every tick's.

Supported: the decoder-only dense, VLM-backbone and MoE families
(``executor.check_pp_support``). The expert ring folds onto cp × model
inside the tick; ep-only × pp is refused, as the reference refuses it (no
spare axis to fold onto).

A pipelined train step is composed around :func:`pipelined_loss_fn` (the
single-device ``make_train_step`` refuses ``plan.pp`` > 1): backward, then
the clip with ``clip_by_global_norm(splits=pipeline_splits(...))`` and the
AdamW update on the rank's params (``chip_smoke.py``'s ``pp_train_step``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.config import ModelConfig, ParallelPlan
from repro_torch.core.device import resolve_dtype
from repro_torch.core.sharding import param_spec, pp_offsets, spec_axes
from repro_torch.core.tree import leaves, map_tree, named_leaves, stacked_shape
from repro_torch.ft.straggler import effective_layout
from repro_torch.launch.mesh import data_mesh, pod_size
from repro_torch.models.families import _embed, _layer_windows, _logits
from repro_torch.models.layers import rms_norm
from .executor import (check_pp_support, cp_local_positions, decoder_layer, resolve_context,
                       zigzag_permutation)
from .loss import cross_entropy
from .step import sum_tensors
from .tensor_parallel import all_reduce_replicated, tp_embed, tp_head_nll


# ---------------------------------------------------------------------------
# the schedule's bookkeeping


@dataclasses.dataclass(frozen=True)
class PipeSchedule:
    """The ticks of P stages over M microbatches (the reference's
    bookkeeping): the forward of microbatch m reaches stage p at tick m + p;
    its backward runs there at tick m + 2(P - 1) - p; the stage input of the
    forward at tick t waits in slot t mod (2P - 1) of the 1F1B ring."""
    pp: int
    microbatches: int

    @property
    def fill_ticks(self) -> int:
        return self.microbatches + self.pp - 1

    @property
    def ticks(self) -> int:
        """The 1F1B backward's ticks."""
        return self.microbatches + 2 * (self.pp - 1)

    @property
    def ring(self) -> int:
        return 2 * self.pp - 1

    def forward_mb(self, t: int, stage: int) -> Optional[int]:
        """The microbatch stage ``stage`` forwards at tick ``t`` (None: dead)."""
        m = t - stage
        return m if 0 <= m < self.microbatches else None

    def backward_mb(self, t: int, stage: int) -> Optional[int]:
        """The microbatch stage ``stage`` back-propagates at 1F1B tick ``t``."""
        m = t - 2 * (self.pp - 1) + stage
        return m if 0 <= m < self.microbatches else None

    def slot(self, t: int) -> int:
        return t % self.ring


# ---------------------------------------------------------------------------
# autograd pieces


class _PodShift(torch.autograd.Function):
    """One tick of the stage chain: ``x`` to the next stage, the previous
    stage's tensor back (zeros on stage 0). ``anchor`` (a param) keeps the
    node in the graph where ``x`` needs no grad (a dead tick's zeros), so
    every rank runs every reverse shift."""

    @staticmethod
    def forward(ctx, ring, x, anchor):
        ctx.ring = ring
        return ring.shift(x, 1, wrap=False)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ring.shift(g.contiguous(), -1, wrap=False), None


class _Tie(torch.autograd.Function):
    """``x`` unchanged, made to depend on ``dep`` (whose cotangent is zero),
    so the backward reaches ``dep`` only after ``x``."""

    @staticmethod
    def forward(ctx, x, dep):
        ctx.dep_meta = (dep.shape, dep.dtype, dep.device)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        shape, dtype, device = ctx.dep_meta
        return g, torch.zeros(shape, dtype=dtype, device=device)


class _Finish(torch.autograd.Function):
    """The identity on the params; its backward completes their grads
    (module docstring) once every tick's backward has run."""

    @staticmethod
    def forward(ctx, finish, *params):
        ctx.finish = finish
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *ctx.finish(list(grads)))


class _OneFOneB(torch.autograd.Function):
    """The 1F1B schedule (module docstring): ``run`` holds the batch and the
    schedule; the forward saves only the params."""

    @staticmethod
    def forward(ctx, run, *params):
        ctx.run = run
        ctx.save_for_backward(*params)
        with torch.no_grad():
            return run.fill_drain(list(params), grad=False)

    @staticmethod
    def backward(ctx, g):
        return (None, *ctx.run.backward_1f1b(list(ctx.saved_tensors), g))


def _leaf_axes(tree, plan, prefix: str = "", stacked: bool = False) -> List[Tuple[str, ...]]:
    """The grid axes that split each tensor of ``tree`` (``leaves`` order)."""
    if isinstance(tree, dict):
        return [a for k in tree for a in _leaf_axes(tree[k], plan, f"{prefix}{k}/", stacked)]
    if isinstance(tree, list):
        return [a for lp in tree for a in _leaf_axes(lp, plan, prefix, True)]
    shape = ((1,) if stacked else ()) + tuple(tree.shape)
    return [spec_axes(param_spec(prefix[:-1], shape, plan))]


def pipeline_splits(params, plan: ParallelPlan, mesh):
    """``clip_by_global_norm``'s ``splits`` for a rank's pipelined params:
    (rings, names) per group of leaves split over the same rings, the pod
    ring for each stage's layers, the model, cp or expert ring for the TP
    shards and expert blocks. A leaf held whole on every rank (the
    embedding, final norm and head, without tp) is counted once."""
    rings = {("model",): mesh.model, ("cp",): mesh.cp, ("cp", "model"): mesh.ep}
    out: Dict[tuple, set] = {}
    for name, leaf in named_leaves(params):
        axes = spec_axes(param_spec(name, stacked_shape(leaf), plan))
        if axes:
            out.setdefault(axes, set()).add(name)
    groups = []
    for axes, names in out.items():
        rest = tuple(a for a in axes if a != "pod")
        group = ((mesh.pod,) if "pod" in axes else ()) + ((rings[rest],) if rest else ())
        groups.append((group, names))
    return groups


# ---------------------------------------------------------------------------
# the loss


class _Run:
    """One call's pipeline on this rank: the rank's microbatches, its stage
    and the placement; ``fill_drain`` and ``backward_1f1b`` run the
    schedules over the flat list of its param tensors."""

    def __init__(self, pipe, params_like, tokens, labels, mb: int, s: int):
        self.p = pipe
        self.like = params_like
        self.axes = _leaf_axes(params_like, pipe.plan)
        self.tokens, self.labels = tokens, labels           # (M, mb, S_loc)
        self.mb, self.s = mb, s
        self.positions = cp_local_positions(pipe.ctx, tokens.shape[-1], pipe.zigzag,
                                            device=tokens.device)

    def tree(self, flat):
        it = iter(flat)
        return map_tree(lambda _: next(it), self.like)

    def buffer(self, flat):
        """The zero stage buffer: (mb, S_loc / tp, d) in the compute dtype."""
        p = self.p
        return torch.zeros((self.mb, self.tokens.shape[-1] // p.ctx.n_tp, p.cfg.d_model),
                           dtype=p.dtype, device=flat[0].device)

    def stage(self, params, x, m: int, tie: bool = False):
        """Stage forward of microbatch ``m`` on input ``x`` (the embedding on
        stage 0, tied to ``x`` when ``tie``): (output, the nll sum on the
        last stage else None, the aux loss of the stage's layers)."""
        p, ctx, cfg = self.p, self.p.ctx, self.p.cfg
        if p.first:
            toks = self.tokens[m]
            e = (tp_embed(params, toks, cfg, p.dtype, ctx.tp) if ctx.tp is not None
                 else _embed(params, toks, cfg, p.dtype))
            x = _Tie.apply(e, x) if tie else e
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, w in zip(params["layers"], p.windows):
            x, a = p.layer(x, lp, w, self.positions)
            aux = aux + a
        nll = None
        if p.last:
            h = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
            labs = self.labels[m]
            if ctx.tp is not None:
                nll = tp_head_nll(params, h, labs, cfg, ctx.tp, p.dtype, p.z_loss).sum()
            else:
                nll = cross_entropy(_logits(params, h, cfg, p.dtype), labs, z_loss=p.z_loss,
                                    reduction="none").sum()
        return x, nll, aux

    def fill_drain(self, flat, grad: bool):
        """The fill-drain forward of M + P - 1 ticks: the [xent, aux] vector
        of the global loss, the same on every rank (differentiable with
        ``grad``: GPipe)."""
        p = self.p
        sched = p.sched
        params = self.tree(flat)
        buf = self.buffer(flat)
        nll = torch.zeros((), dtype=torch.float32, device=buf.device)
        aux = torch.zeros((), dtype=torch.float32, device=buf.device)
        x = buf
        for t in range(sched.fill_ticks):
            m = sched.forward_mb(t, p.stage)
            if m is None:
                x = buf                                      # dead: pass the input on
            else:
                x, n, a = self.stage(params, buf, m, tie=grad)
                if n is not None:
                    nll = nll + n
                aux = aux + a
            if t < sched.fill_ticks - 1:
                buf = (_PodShift.apply(p.pod, x, flat[0]) if grad
                       else p.pod.shift(x, 1, wrap=False))
        xent = nll / (p.n_micro * self.mb * self.s)
        aux = aux / p.n_micro
        if grad:
            xent = _Tie.apply(xent, x)                       # the shift chain's tail
        return p.reduce(xent, aux, grad)

    def backward_1f1b(self, flat, g):
        """The 1F1B backward (module docstring): the completed grads of the
        flat params."""
        p = self.p
        sched = p.sched
        params = self.tree(flat)
        w_loss = g[0] / (p.n_micro * self.mb * self.s)
        w_aux = g[1] / p.n_micro
        zero = self.buffer(flat)
        fbuf, dbuf = zero, zero
        stash: List[Optional[torch.Tensor]] = [None] * sched.ring
        acc: List[Optional[torch.Tensor]] = [None] * len(flat)
        for t in range(sched.ticks):
            # (a) the forward recompute advances one stage; its input waits
            stash[sched.slot(t)] = fbuf
            m_f = sched.forward_mb(t, p.stage) if t < sched.fill_ticks else None
            x_out = fbuf
            if m_f is not None and not p.last:
                with torch.no_grad():
                    x_out = self.stage(params, fbuf, m_f)[0]
            fbuf_next = p.pod.shift(x_out, 1, wrap=False)
            # (b) the backward this stage owes at t
            m = sched.backward_mb(t, p.stage)
            dx = zero
            if m is not None:
                x_in = None if p.first else \
                    stash[sched.slot(m + p.stage)].detach().requires_grad_(True)
                with torch.enable_grad():
                    x, nll, aux = self.stage(params, x_in, m)
                outs, seeds = ([nll], [w_loss]) if p.last else ([x], [dbuf])
                if aux.requires_grad:
                    outs.append(aux)
                    seeds.append(w_aux)
                ins = flat + ([x_in] if x_in is not None else [])
                got = torch.autograd.grad(outs, ins, seeds, allow_unused=True)
                for i, gi in enumerate(got[:len(flat)]):
                    if gi is not None:
                        acc[i] = gi if acc[i] is None else acc[i].add_(gi)
                if x_in is not None and got[-1] is not None:
                    dx = got[-1]
            # (c) the input cotangent back one stage
            dbuf = p.pod.shift(dx, -1, wrap=False)
            fbuf = fbuf_next
        return p.finish(acc, flat, self.axes)


class _Pipeline:
    """What :func:`pipelined_loss_fn` fixes once: the stage, its layers and
    windows, the placement and the rings."""

    def __init__(self, cfg, plan, mesh, batch_axes, z_loss):
        self.cfg, self.plan, self.mesh, self.z_loss = cfg, plan, mesh, z_loss
        self.pod = mesh.pod
        self.pp = self.pod.size
        self.stage = self.pod.rank
        self.first, self.last = self.stage == 0, self.stage == self.pp - 1
        self.n_micro = plan.microbatches
        self.sched = PipeSchedule(self.pp, self.n_micro)
        ctx = resolve_context(cfg, plan, mesh)
        self.dmesh = data_mesh(mesh) if batch_axes and mesh.shape.get("data", 1) > 1 else None
        if not batch_axes and ctx.data is not None:
            # a replicated batch: every data rank routes the same rows
            ctx = dataclasses.replace(ctx, data=None)
        self.ctx = ctx
        self.zigzag = ctx.cp is not None and ctx.cp_impl == "ring"
        self.dtype = resolve_dtype(plan.compute_dtype)
        layout = effective_layout(plan, cfg)
        off = pp_offsets(layout)[self.stage]
        self.n_layers = layout[self.stage]
        self.windows = _layer_windows(cfg)[off:off + self.n_layers]
        self.layer = decoder_layer(ctx, cfg, plan, self.dtype)

    def rank_batch(self, batch):
        """This rank's (M, mb, S_loc) tokens and labels: its data group's
        contiguous rows when the batch shards, split into M contiguous
        microbatches, then its cp chunk (after the zigzag permutation in the
        ring mode), as the reference's ``shard_map`` in_specs lay it out."""
        tokens, labels = batch["tokens"], batch["labels"]
        rows, s = tokens.shape
        if self.dmesh is not None:
            n = self.dmesh.size
            if rows % n:
                raise ValueError(f"batch {rows} does not shard over data={n}")
            k = rows // n
            lo = self.dmesh.rank * k
            tokens, labels = tokens[lo:lo + k], labels[lo:lo + k]
        b = tokens.shape[0]
        if b % self.n_micro:
            raise ValueError(f"a rank's {b} rows do not split into {self.n_micro} microbatches")
        mb = b // self.n_micro
        ctx = self.ctx
        split = 2 * ctx.n_cp if self.zigzag else ctx.n_cp
        if s % split or (s // ctx.n_cp) % ctx.n_tp:
            raise ValueError(f"sequence {s} does not split over cp={ctx.n_cp} "
                             f"({'zigzag, ' if self.zigzag else ''}tp={ctx.n_tp})")
        if ctx.cp is not None:
            if self.zigzag:
                perm = torch.from_numpy(zigzag_permutation(s, ctx.n_cp)).to(tokens.device)
                tokens, labels = tokens[:, perm], labels[:, perm]
            s_loc = s // ctx.n_cp
            lo = ctx.cp.rank * s_loc
            tokens, labels = tokens[:, lo:lo + s_loc], labels[:, lo:lo + s_loc]
        shape = (self.n_micro, mb, tokens.shape[1])
        return tokens.reshape(shape), labels.reshape(shape), mb, s

    def reduce(self, xent, aux, grad: bool):
        """[xent, aux] of the global loss from this rank's terms: xent summed
        over cp and pod, both over pod, then the mean over the data group
        (the value only: its backward is the identity, module docstring)."""
        ctx = self.ctx
        if grad:
            if ctx.cp is not None:
                xent = all_reduce_replicated(ctx.cp, xent)
            v = all_reduce_replicated(self.pod, torch.stack([xent, aux]))
        else:
            if ctx.cp is not None:
                xent = ctx.cp.all_reduce_sum(xent)
            v = self.pod.all_reduce_sum(torch.stack([xent, aux]))
        if self.dmesh is not None:
            mean = self.dmesh.all_reduce_mean(v.detach().contiguous().clone())
            v = v + (mean - v.detach())
        return v

    def finish(self, grads, flat, axes):
        """The grads of the global loss, completed (module docstring): cp,
        then model, data and pod, each ring skipping the leaves it splits
        (``axes``, per param); a param without a grad counts zeros."""
        grads = [torch.zeros_like(p) if g is None else g.contiguous()
                 for g, p in zip(grads, flat)]
        ctx = self.ctx
        with torch.no_grad():
            if ctx.cp is not None:
                sum_tensors([g for g, a in zip(grads, axes) if ctx.cp.axis not in a], ctx.cp)
            if ctx.tp is not None:
                sum_tensors([g for g, a in zip(grads, axes) if "model" not in a], ctx.tp)
            if self.dmesh is not None:
                sum_tensors(grads, self.dmesh)
                for g in grads:
                    g.div_(self.dmesh.size)
            sum_tensors([g for g, a in zip(grads, axes) if "pod" not in a], self.pod)
        return grads

    def __call__(self, params, batch):
        tokens, labels, mb, s = self.rank_batch(batch)
        flat = leaves(params)
        run = _Run(self, params, tokens, labels, mb, s)
        if self.plan.pp_schedule == "1f1b":
            v = _OneFOneB.apply(run, *flat)
        else:
            v = run.fill_drain(
                list(_Finish.apply(lambda g: self.finish(g, flat, run.axes), *flat)), grad=True)
        xent, aux = v[0], v[1]
        return xent + aux, {"xent": xent, "moe_aux": aux}


def pipelined_loss_fn(cfg: ModelConfig, plan: ParallelPlan, mesh,
                      batch_axes: Tuple[str, ...] = ("data",), z_loss: float = 0.0):
    """``loss_fn(params, batch) -> (loss + aux, {"xent", "moe_aux"})`` with
    the layers pipelined over ``mesh``'s pod axis (the reference's
    ``pipelined_loss_fn``), differentiable, on every rank of the grid.

    ``mesh`` is a ``GridMesh`` with a pod axis of ``plan.pp`` stages;
    ``params`` this rank's part (``core.sharding.shard_layout``: its stage's
    layers, its TP shards and expert blocks); ``batch`` the global batch, the
    same on every rank, sharded over the data group when ``batch_axes`` holds
    "data" (else every data rank runs all of it). ``plan.microbatches`` >=
    ``pp``; the rank's rows split into that many microbatches. The loss and
    ``.grad`` after its backward are the global loss's (module docstring);
    ``z_loss`` is threaded into each microbatch's cross-entropy."""
    plan.validate(cfg)
    pp = pod_size(mesh)
    if pp < 2 or plan.pp != pp:
        raise ValueError(f"pipelined_loss_fn needs plan.pp={plan.pp} >= 2 stages on a 'pod' "
                         f"mesh axis of that size, the mesh has {dict(mesh.shape)}")
    check_pp_support(cfg, pp)
    if plan.ep > 1 and plan.tp == 1 and plan.cp == 1:
        raise ValueError(f"plan.ep={plan.ep} under pipeline parallelism needs cp > 1 and/or "
                         "the tp rings to fold the expert axis onto; ep-only x pp is not "
                         "supported")
    return _Pipeline(cfg, plan, mesh, tuple(batch_axes or ()), z_loss)
