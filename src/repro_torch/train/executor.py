"""The family blocks and layer bodies under a placement, and the
tensor- and context-parallel loss (port of ``repro/train/executor.py`` and of
the layer bodies of ``repro/models/families.build_enc_dec``).

The reference's executor defines each family's math once and lets a
:class:`ParallelContext` place it. The port has these placements:

- local (``ctx.tp`` and ``ctx.cp`` both None, :func:`local_context`): the
  single-device bodies every model runs, unchanged by the context;
- ``ctx.tp``, the model ring of a grid (``launch.mesh``,
  ``train/tensor_parallel.py``): column GEMMs take the sequence all-gather in
  their ring ticks (:func:`_proj_cols`), row GEMMs reduce-scatter
  (:func:`_proj_rows`), and the residual stream stays (B, S/tp, d) between
  blocks. Attention runs on the rank's heads (q/k/v biases sliced, rope on the
  whole sequence's positions); the SwiGLU MLP on its FFN columns
  (:func:`mlp_block_ex`); MoE gathers the tokens, routes them on every rank,
  runs the experts on the rank's d_expert columns and sums the partials
  (:func:`moe_block_ex`); Mamba2 fuses the in-projection into the ring,
  computes B/C on the gathered copy and runs the SSD scan on the rank's heads,
  its gated RMSNorm summing the squares over the ring (:func:`ssm_block_ex`);
- ``ctx.cp``, the cp ring of a (data, cp, model) grid (survey §4.1.4): the
  sequence itself is sharded end to end, so no rank holds the whole context.
  Attention runs as ``cp_impl`` says: ``"ring"`` (:func:`ring_attention`),
  where each rank owns a zigzag pair of sub-chunks (rank i holds sub-chunks i
  and 2 cp - 1 - i of 2 cp, so the causal triangle spreads evenly), the K/V
  chunks travel around the ring while B1 runs each (q, k) tile whose mask is
  fixed by the pair's place (masked: no launch; diagonal: causal; below:
  full), and the tiles' (o, lse) merge exactly (:func:`_merge_lse`); its
  backward is the reversed ring, B2/B3 on each tile against the merged (lse,
  Δ), the dk/dv accumulators riding with their chunk and coming home on a last
  hop. ``"gather"`` (:func:`gather_attention`) all-gathers K/V over contiguous
  chunks and runs B1 with the rank's causal ``q_offset``. Mamba2 takes a
  (d_conv - 1)-token halo from the left rank for its convs
  (:func:`cp_halo_left`), scans the rank's chunk from a zero state through the
  dispatcher, and adds the entering state's share of y in closed form around
  the state chain (:func:`cp_chain_state`). MoE routes the rank's own tokens,
  its aux statistics summed over the ranks that hold the rest of the batch.
  cp composes with tp: a block's tp rings run inside the cp chunk;
- ``ctx.ep``, the expert ring (survey §4.1.5, MoE parallel folding): the MoE
  sublayer re-reads the cp × model ranks as one flat ring (the grid's
  ``GridMesh.ep``). Each rank routes its own tokens, holds E / ep whole
  experts (``core.sharding.ep_spec_for_param``) and exchanges the dispatch
  buffers with its peers around them (``kernels.dispatch.dispatch_ep_a2a``,
  ``ctx.ep_impl``); the aux statistics are summed over the fold and the data
  group. In the ep-only placement (tp == cp == 1 in the plan) the experts
  ride the model axis and attention runs as a cp ring over that same ring;
- ``ctx.data`` alone, MoE under data parallelism: each data rank routes its
  own rows, the aux statistics summed over the data group (the reference
  executor's ``batch_axes``).

Every ring collective runs on every rank in the same order, in the forward,
in a recompute and in the backward: a rank that needs no value from one (the
first rank's halo, a chain message not yet final) masks what it receives with
``torch.where``, so the collective's backward still runs.

:func:`make_executor_loss_fn` assembles the parallel loss: the embedding, the layers (``plan.remat`` per layer),
the final norm and the head, with the nll summed over the cp ring.

A layer is written as pieces around the attention call (``decoder_layer``) or
the SSD scan (``ssm_layer``), so that ``remat="selective"`` can recompute the
glue on either side and keep what the kernels saved; the reference's
``attn_block`` is therefore the decoder layer's ``pre`` and ``post`` pieces
around the call. :func:`encoder_layer` and :func:`cross_decoder_layer` are
whisper's encoder layer and its decoder layer with cross-attention, local
only; the reference writes them inside ``build_enc_dec`` and wraps each in
``_remat(body, plan.remat)``, as here.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.config import (Family, ModelConfig, ParallelPlan,
                                     warn_shard_local_routing)
from repro_torch.core.device import resolve_dtype
from repro_torch.ft.inject import remat_context, taint
from repro_torch.kernels.dispatch import (dispatch_attention, dispatch_attention_chunk_bwd,
                                          dispatch_attention_lse, dispatch_ep_a2a,
                                          dispatch_ssd_scan, select_cp_impl, select_ep_impl)
from repro_torch.launch.mesh import (DataMesh, ModelRing, cp_size, data_mesh, model_size,
                                     pod_size)
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import NEG_INF, mlp_block, qkv_proj, rms_norm, rope
from .fsdp import gatherer
from .loss import cross_entropy
from .tensor_parallel import (all_gather_matmul, all_reduce_replicated, all_reduce_sum,
                              check_overlap_support, decoder_only_support_errors,
                              matmul_reduce_scatter, ring_all_gather, ring_reduce_scatter,
                              ring_shift, scale_grad, tp_embed, tp_head_nll)


def checkpoint(fn, *args):
    """``fn(*args)`` under torch's non-reentrant checkpoint, its recompute
    replaying the forward's fault-seam decisions (module docstring)."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                             context_fn=remat_context)


def _apply(remat: str, body, selective, *args):
    """``plan.remat`` on one layer (only while autograd records): ``"none"``
    runs ``body``, ``"full"`` checkpoints it whole, ``"selective"`` runs
    ``selective`` (the glue checkpointed piece by piece around the attention
    calls)."""
    if not torch.is_grad_enabled() or remat == "none":
        return body(*args)
    if remat == "full":
        return checkpoint(body, *args)
    if remat == "selective":
        return selective(*args)
    raise ValueError(f"unknown remat mode {remat!r}")


# ---------------------------------------------------------------------------
# placement


@dataclasses.dataclass(frozen=True)
class ParallelContext:
    """How a family block runs: ``tp`` is the model ring, ``cp`` the cp ring
    (``None``: that axis is off), ``cp_impl`` the resolved attention mode
    ("ring" | "gather"), ``ep`` the expert ring and ``ep_impl`` its resolved
    exchange ("blocking" | "overlap"), and ``data`` the data group over which
    the batch's rows are split (``None``: one data rank), which with ``cp``
    or ``ep`` completes the MoE aux statistics. ``gather`` is ZeRO-3's
    per-layer gather (``train/fsdp.py`` ``gatherer``; None: the params are
    whole), which the layer bodies run on their params inside their remat
    boundary; it changes no placement of the math."""
    tp: Optional[ModelRing] = None
    cp: Optional[ModelRing] = None
    cp_impl: str = "ring"
    ep: Optional[ModelRing] = None
    ep_impl: str = "overlap"
    data: Optional[DataMesh] = None
    gather: Optional[Callable] = None

    def full(self, tree, select=None):
        """``tree`` with its ZeRO-3 parts gathered (those ``select`` takes)."""
        return tree if self.gather is None else self.gather(tree, select)

    @property
    def is_local(self) -> bool:
        return self.tp is None and self.cp is None and self.ep is None and self.data is None

    @property
    def n_tp(self) -> int:
        return self.tp.size if self.tp is not None else 1

    @property
    def n_cp(self) -> int:
        return self.cp.size if self.cp is not None else 1

    @property
    def n_dp(self) -> int:
        return self.data.size if self.data is not None else 1

    @property
    def n_rep(self) -> int:
        """The ranks holding distinct tokens of the batch: local token counts
        times this are the batch's (under ep every fold rank routes its own
        tokens, the fold subsuming the cp ring)."""
        if self.ep is not None:
            return self.n_dp * self.ep.size
        return self.n_dp * self.n_cp

    def aux_sum(self, t):
        """A MoE aux statistic summed over the expert ring (or, without one,
        the cp ring) and the data group (itself without any).
        Over the expert or cp ring every rank consumes the sum alike, so its
        backward passes the cotangent through; over the data group the step
        averages the grads, so there the backward sums the cotangents
        (``train/tensor_parallel.py``)."""
        ring = self.ep if self.ep is not None else self.cp
        if ring is not None:
            t = all_reduce_replicated(ring, t)
        if self.data is not None:
            t = all_reduce_sum(self.data, t)
        return t


def local_context(gather: Optional[Callable] = None) -> ParallelContext:
    """The single-device placement: every block its local body (its params
    gathered by ``gather`` under ZeRO-3)."""
    return ParallelContext(gather=gather)


def _slice_tp(ctx: ParallelContext, p, n_loc: int, axis: int = 0):
    """This rank's chunk of a model-replicated leaf (itself without tp)."""
    if ctx.tp is None:
        return p
    return p.narrow(axis, ctx.tp.rank * n_loc, n_loc)


def _proj_cols(ctx: ParallelContext, x, ws):
    """Column GEMMs: under tp the ring all-gather fused into the GEMM ticks,
    ``x`` (B, S/tp, d) in, ``outs[i]`` (B, S, f_loc) and the gathered ``x``
    out; locally plain matmuls on the whole ``x``."""
    if ctx.tp is not None:
        return all_gather_matmul(ctx.tp, x, ws)
    return tuple(x @ w for w in ws), x


def _proj_rows(ctx: ParallelContext, h, w):
    """Row GEMM: the ring reduce-scatter under tp, a plain matmul locally."""
    if ctx.tp is not None:
        return matmul_reduce_scatter(ctx.tp, h, w)
    return h @ w


def check_cp_support(cfg: ModelConfig, cp: int):
    """Static preconditions of the cp axis (the families and positions the
    tp rings also take); raises ValueError naming each that fails."""
    bad = decoder_only_support_errors(cfg)
    if bad:
        raise ValueError(f"cp={cp} unsupported here: " + "; ".join(bad))


def check_pp_support(cfg: ModelConfig, pp: int):
    """Static preconditions of pipeline parallelism: the decoder-only
    families the reference's ``pipelined_loss_fn`` supports (dense and VLM
    backbones, and MoE); raises ValueError for the SSM, hybrid and
    encoder-decoder families."""
    if cfg.is_enc_dec or cfg.family not in (Family.DENSE, Family.VLM, Family.MOE):
        raise ValueError(f"pp={pp} supports the decoder-only dense, VLM and MoE families "
                         f"(the reference's pipeline), got {cfg.family!r}"
                         f"{' (encoder-decoder)' if cfg.is_enc_dec else ''}")


def resolve_context(cfg: ModelConfig, plan: ParallelPlan, mesh) -> ParallelContext:
    """The placement of ``plan`` on ``mesh`` (the reference's
    ``resolve_context``): ``plan.tp`` must be the size of the mesh's model
    axis (1 without one), and the tp rings run when it is 2 or more, on a
    config that passes ``check_overlap_support``; ``plan.cp`` > 1 needs a cp
    axis of that size, and resolves ``plan.cp_impl`` (``select_cp_impl``).
    ``plan.ep`` > 1 takes the expert ring: in the ep-only placement (``tp``
    and ``cp`` 1 in the plan) it rides a model axis of exactly ``ep`` ranks,
    which attention then runs as a cp ring over (the zigzag layout); folded,
    ``ep`` must equal the resolved cp × tp and the ring is the grid's
    ``ep``. A plan with ``tp`` 1 on a model axis is refused unless it asks
    for that ep ring, rather than run the whole model on every model rank.
    The MoE family under a data axis alone routes each rank's rows, its aux
    summed over the data group. Under ``plan.dp_shard`` > 1 (data
    parallelism alone, ``ParallelPlan.validate``) the context carries
    ZeRO-3's gather over the data group. ``plan.tp_impl`` "gspmd" is refused by
    ``plan.validate``. On a grid with a pod axis, ``plan.pp`` must be its
    size; the stage's (data, cp, model) sub-grid then gives the placement
    above unchanged (``train/pipeline.py`` runs it). Under
    ``plan.dp_over_model`` the model axis is more data parallelism: the data
    group is the grid's flat one (``launch.mesh.data_mesh``) and no ring
    runs."""
    shape = dict(mesh.shape) if mesh is not None else None
    if pod_size(mesh) != plan.pp:
        raise ValueError(f"plan.pp={plan.pp} needs a 'pod' mesh axis of that size (the port "
                         f"runs no pods as data replicas), the mesh has {shape}")
    tp = 1 if plan.dp_over_model else model_size(mesh)
    domain = (shape.get("data", 1) * (shape.get("model", 1) if plan.dp_over_model else 1)
              if mesh is not None else 1)
    data = data_mesh(mesh) if domain > 1 else None
    if plan.ep > 1 and plan.tp == 1 and plan.cp == 1:
        if tp != plan.ep:
            raise ValueError(f"plan.ep={plan.ep} needs a 'model' mesh axis of exactly that "
                             f"size to ride (the mesh has {shape})")
        if cp_size(mesh) > 1:
            raise ValueError(f"the mesh has a 'cp' axis ({shape}) but plan.cp is 1")
        check_cp_support(cfg, plan.ep)
        warn_shard_local_routing(cfg)
        return ParallelContext(cp=mesh.model, cp_impl=_cp_impl(cfg, plan), ep=mesh.model,
                               ep_impl=select_ep_impl(plan.ep_impl), data=data)
    if plan.tp != tp:
        raise ValueError(f"plan.tp={plan.tp} needs a 'model' mesh axis of that size, "
                         f"the mesh has {shape}")
    cp = cp_size(mesh) if plan.cp > 1 else 1
    if cp != plan.cp:
        raise ValueError(f"plan.cp={plan.cp} needs a 'cp' mesh axis of that size, "
                         f"the mesh has {shape}")
    if cp_size(mesh) > 1 and plan.cp == 1:
        raise ValueError(f"the mesh has a 'cp' axis ({shape}) but plan.cp is 1")
    if plan.ep > 1 and plan.ep != tp * cp:
        raise ValueError(f"plan.ep={plan.ep} must equal the folded cp×model ring size "
                         f"{tp * cp} (mesh {shape}): the expert axis re-maps those ranks, "
                         "it does not add any")
    if tp == 1 and cp == 1:
        gather = gatherer(data_mesh(mesh)) if plan.dp_shard > 1 and mesh is not None else None
        if cfg.family == Family.MOE and data is not None:
            return ParallelContext(data=data, gather=gather)
        return local_context(gather)
    if tp > 1:
        check_overlap_support(cfg, plan, tp)
    if cp > 1:
        check_cp_support(cfg, cp)
    warn_shard_local_routing(cfg)
    return ParallelContext(tp=mesh.model if tp > 1 else None,
                           cp=mesh.cp if cp > 1 else None,
                           cp_impl=_cp_impl(cfg, plan) if cp > 1 else "ring",
                           ep=mesh.ep if plan.ep > 1 else None,
                           ep_impl=select_ep_impl(plan.ep_impl), data=data)


def _cp_impl(cfg: ModelConfig, plan: ParallelPlan) -> str:
    return select_cp_impl(plan.cp_impl, family=cfg.family, window=cfg.sliding_window,
                          local_global_alternating=bool(cfg.local_global_alternating
                                                        and cfg.sliding_window))


# ---------------------------------------------------------------------------
# the context-parallel sequence layout (zigzag)


def zigzag_permutation(seq: int, cp: int) -> np.ndarray:
    """The global positions in the zigzag ring layout: the sequence splits
    into 2 cp contiguous sub-chunks and rank r owns sub-chunks r and
    2 cp - 1 - r, so every rank attends the same number of causal (q, k)
    pairs. ``tokens[:, perm]`` hands each rank its pair as a contiguous
    chunk; everything position-wise (embedding, rope at explicit positions,
    the per-token loss) is unchanged by the permutation."""
    if seq % (2 * cp):
        raise ValueError(f"the zigzag layout needs a sequence divisible by 2 cp = {2 * cp}, "
                         f"got {seq}")
    lc = seq // (2 * cp)
    parts = []
    for r in range(cp):
        parts.append(np.arange(r * lc, (r + 1) * lc))
        parts.append(np.arange((2 * cp - 1 - r) * lc, (2 * cp - r) * lc))
    return np.concatenate(parts)


def zigzag_pair_counts(seq: int, cp: int) -> np.ndarray:
    """The causal (q, k) pairs each rank attends under the zigzag layout."""
    perm = zigzag_permutation(seq, cp)
    s_loc = seq // cp
    return np.array([int(np.sum(perm[r * s_loc:(r + 1) * s_loc] + 1)) for r in range(cp)],
                    dtype=np.int64)


def cp_local_positions(ctx: ParallelContext, s_loc: int, zigzag: bool, device=None):
    """The global positions of this rank's chunk of ``s_loc`` tokens in the
    layout the caller sliced: ``zigzag`` (the ring mode outside SSM) its two
    sub-chunks' ranges, else contiguous ``[i s_loc, (i + 1) s_loc)``; without
    cp ``arange(s_loc)``."""
    if ctx.cp is None:
        return torch.arange(s_loc, device=device)
    idx, cp = ctx.cp.rank, ctx.cp.size
    if not zigzag:
        return idx * s_loc + torch.arange(s_loc, device=device)
    lc = s_loc // 2
    return torch.cat([idx * lc + torch.arange(lc, device=device),
                      (2 * cp - 1 - idx) * lc + torch.arange(lc, device=device)])


# ---------------------------------------------------------------------------
# ring attention (zigzag, lse merging, the reversed ring in the backward)


def _merge_lse(o, lse, o_c, lse_c):
    """The exact chunked-softmax merge of two normalised partials (fp32): the
    running (o, lse) and a tile's (o_c, lse_c). A fully masked partial
    carries o = 0 and lse ~ ``NEG_INF`` (finite), so it drops out, and two
    such partials merge to a finite one."""
    m = torch.maximum(lse, lse_c)
    w1 = torch.exp(lse - m)
    w2 = torch.exp(lse_c - m)
    tot = w1 + w2
    o_new = (o * w1[..., None] + o_c.float() * w2[..., None]) / tot[..., None]
    return o_new, m + torch.log(tot)


def _sub_ids(cp: int, owner: int) -> Tuple[int, int]:
    """The zigzag sub-chunks rank ``owner`` holds."""
    return owner, 2 * cp - 1 - owner


def _tiles(cp: int, idx: int, src: int, lc: int):
    """The (q slice, k slice, causal) tiles of rank ``idx``'s q sub-chunks
    against rank ``src``'s KV sub-chunks that attend anything: a q sub-chunk
    after the k sub-chunk attends all of it, the same sub-chunk its causal
    diagonal, an earlier one nothing (no tile)."""
    out = []
    for qi, q_id in enumerate(_sub_ids(cp, idx)):
        for ki, k_id in enumerate(_sub_ids(cp, src)):
            if q_id >= k_id:
                out.append((slice(qi * lc, (qi + 1) * lc), slice(ki * lc, (ki + 1) * lc),
                            q_id == k_id))
    return out


def _ring_attn_fwd(ring: ModelRing, q, k, v, kw):
    """The forward ring: cp steps; at each the rank attends its two q
    sub-chunks against the visiting KV chunk's two sub-chunks (the tiles of
    :func:`_tiles`), merging each tile's (o, lse) into the row's; the KV
    chunk then moves one rank on (the ``cp.ring.kv`` seam on K as it lands).
    Returns (o in q's dtype, lse fp32), (B, S/cp, ...)."""
    cp, idx = ring.size, ring.rank
    b, s_loc, hq, hd = q.shape
    if s_loc % 2:
        raise ValueError(f"ring cp needs an even chunk (two zigzag sub-chunks), got {s_loc}")
    lc = s_loc // 2
    o = q.new_zeros((b, s_loc, hq, hd), dtype=torch.float32)
    lse = q.new_full((b, s_loc, hq), NEG_INF, dtype=torch.float32)
    k_cur, v_cur = k, v
    for step in range(cp):
        for qs, ks, causal in _tiles(cp, idx, (idx - step) % cp, lc):
            o_c, lse_c = dispatch_attention_lse(q[:, qs], k_cur[:, ks], v_cur[:, ks],
                                                causal=causal, **kw)
            o[:, qs], lse[:, qs] = _merge_lse(o[:, qs], lse[:, qs], o_c, lse_c)
        if step < cp - 1:
            # fault seam: the visiting K chunk as it lands from the hop
            k_cur = taint("cp.ring.kv", ring.shift(k_cur, 1))
            v_cur = ring.shift(v_cur, 1)
    return o.to(q.dtype), lse


def _accumulators_hop(ring: ModelRing, dk, dv):
    """One hop of the dk/dv accumulators around the reversed ring; the hop
    after the last step brings each chunk's sums home to its owner."""
    return ring.shift(dk, -1), ring.shift(dv, -1)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(fctx, ring, q, k, v, kw):
        o, lse = _ring_attn_fwd(ring, q, k, v, kw)
        fctx.ring, fctx.kw = ring, kw
        fctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(fctx, g):
        """The reversed ring: at each step B2/B3 on every tile of the rank's
        q sub-chunks against the KV chunk it holds, against the merged
        (lse, Δ); dq sums on the rank, dk/dv in fp32 accumulators that ride
        the reversed ring with their KV chunk and come home on a last hop."""
        ring, kw = fctx.ring, fctx.kw
        q, k, v, o, lse = fctx.saved_tensors
        cp, idx = ring.size, ring.rank
        lc = q.shape[1] // 2
        do = g.to(q.dtype)
        delta = (g.float() * o.float()).sum(dim=-1)                   # (B, S/cp, Hq)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        k_cur, v_cur = k, v
        for step in range(cp):
            for qs, ks, causal in _tiles(cp, idx, (idx + step) % cp, lc):
                dq_c, dk_c, dv_c = dispatch_attention_chunk_bwd(
                    q[:, qs], k_cur[:, ks], v_cur[:, ks], do[:, qs], lse[:, qs],
                    delta[:, qs], causal=causal, **kw)
                dq[:, qs] += dq_c.float()
                dk[:, ks] += dk_c.float()
                dv[:, ks] += dv_c.float()
            if step < cp - 1:
                k_cur, v_cur = ring.shift(k_cur, -1), ring.shift(v_cur, -1)
            dk, dv = _accumulators_hop(ring, dk, dv)
        return None, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None


def ring_attention(ring: ModelRing, q, k, v, *, impl: str = "auto", softcap: float = 0.0,
                   scale: Optional[float] = None):
    """Zigzag ring attention over the cp ring, differentiable. ``q``/``k``/
    ``v``: (B, S/cp, H, hd), this rank's zigzag pair of sub-chunks, rope
    applied at their global positions. Exact causal attention over the whole
    sequence; no rank holds more than its chunk and one visiting chunk of
    K/V. B1 (with lse) runs every tile, B2/B3 every tile of the backward."""
    kw = dict(impl=impl, softcap=float(softcap), scale=scale)
    return _RingAttention.apply(ring, q, k, v, kw)


def gather_attention(ctx: ParallelContext, q, k, v, *, window: int, softcap: float,
                     impl: str, return_kv: bool = False):
    """``cp_impl="gather"``: K/V all-gathered over the cp ring (contiguous
    chunks; the backward reduce-scatters their cotangents) and the local
    queries attending the whole context through ``dispatch_attention`` at
    the rank's causal ``q_offset``: O(S) K/V on every rank where the ring
    holds O(S/cp). With ``return_kv`` also the gathered (k, v): the grid
    prefill writes the positions its rank owns into its cache slice."""
    s_loc = q.shape[1]
    kf = ring_all_gather(ctx.cp, k, seam=None)
    vf = ring_all_gather(ctx.cp, v, seam=None)
    o = dispatch_attention(q, kf, vf, impl=impl, causal=True, window=window,
                           softcap=softcap, q_offset=ctx.cp.rank * s_loc)
    return (o, (kf, vf)) if return_kv else o


# ---------------------------------------------------------------------------
# the context-parallel SSD pieces: the conv halo and the entering-state chain


def _rank_is(ring: ModelRing, k: int, device):
    return torch.tensor(ring.rank == k, device=device)


def cp_halo_left(ctx: ParallelContext, x, width: int):
    """The left neighbour's last ``width`` positions of ``x`` (B, L, C), zeros
    on rank 0: one forward hop, on every rank."""
    recv = ring_shift(ctx.cp, x[:, -width:].contiguous(), 1)
    return torch.where(_rank_is(ctx.cp, 0, x.device), torch.zeros((), dtype=recv.dtype,
                                                                  device=x.device), recv)


def cp_chain_state(ctx: ParallelContext, state, decay):
    """The state entering each rank's chunk of a linear recurrence: ``state``
    (B, H, P, N) is the rank's final state from a zero start, ``decay`` (B, H)
    the total decay over its chunk. Returns E_r = sum_{j<r} (prod_{j<k<r}
    A_k) S_j after cp - 1 forward hops: at hop k every rank sends
    ``state + decay * E`` and rank k keeps what it receives, which its left
    neighbour finalised at the hop before (the ``cp.ring.state`` seam on the
    message as it lands). The chain is linear, so autograd runs it backward
    hop by hop."""
    e = torch.zeros_like(state)
    for k in range(1, ctx.cp.size):
        msg = state + decay[..., None, None] * e
        # fault seam: the chain message as it lands on the next rank
        recv = taint("cp.ring.state", ring_shift(ctx.cp, msg, 1))
        e = torch.where(_rank_is(ctx.cp, k, state.device), recv, e)
    return e


# ---------------------------------------------------------------------------
# family blocks


def attn_qkv(ctx: ParallelContext, p, x, cfg: ModelConfig, dtype):
    """The attention projections for any placement: (B, S, H, hd) q/k/v.
    Under tp the sequence all-gather rides the QKV GEMM's ring ticks, the
    heads are the rank's (H/tp), and ``bq/bk/bv`` are sliced to them."""
    if ctx.tp is None:
        return qkv_proj(p, x, cfg, dtype)
    (q, k, v), _ = all_gather_matmul(ctx.tp, x, (p["wq"].to(dtype), p["wk"].to(dtype),
                                                 p["wv"].to(dtype)))
    if cfg.qkv_bias:
        q = q + _slice_tp(ctx, p["bq"].to(dtype), q.shape[-1])
        k = k + _slice_tp(ctx, p["bk"].to(dtype), k.shape[-1])
        v = v + _slice_tp(ctx, p["bv"].to(dtype), v.shape[-1])
    b, s, hd = q.shape[0], q.shape[1], cfg.head_dim
    return (q.reshape(b, s, -1, hd), k.reshape(b, s, -1, hd), v.reshape(b, s, -1, hd))


def mlp_block_ex(ctx: ParallelContext, p, x, dtype):
    """SwiGLU for any placement: under tp one gather fused into both the gate
    and up GEMMs, one reduce-scatter after down."""
    if ctx.tp is None:
        return mlp_block(p, x, dtype)
    (g, u), _ = _proj_cols(ctx, x, (p["gate"].to(dtype), p["up"].to(dtype)))
    return _proj_rows(ctx, F.silu(g) * u, p["down"].to(dtype))


def moe_block_ex(ctx: ParallelContext, p, x, cfg: ModelConfig, dtype,
                 plan: Optional[ParallelPlan] = None):
    """The MoE sublayer for any placement. x: (B, S_loc, d) -> (out, aux).

    Locally ``models.moe.moe_block``. Under tp the ring all-gather gives every
    rank the same token set, so the routing (the GShard queues are
    order-sensitive) agrees across ranks; the experts run on the rank's
    d_expert columns through ``dispatch_expert_gemm`` with the group sizes,
    their partials are summed over the ring (each rank then combines only its
    own sequence chunk, so the sum's backward sums the cotangents), and the
    shared experts' partials reduce-scatter into the chunks. The aux loss is
    computed whole on every rank, so its cotangent is scaled by 1/tp
    (``scale_grad``) and its share of the summed router grads counts once.
    Under cp (with or without tp) the rank routes its own chunk's tokens (the
    reference's shard-local routing: the same as one device's when the
    capacity drops nothing), and the aux statistics are summed over the ranks
    holding the rest of the batch (``ParallelContext.aux_sum``); so under a
    data group alone.

    Under ep (``ctx.ep``) the rank routes its own tokens with no tp
    re-gather, its aux statistics summed over the fold and the data group;
    the dispatch buffers of all E experts go through ``dispatch_ep_a2a`` to
    the ranks that own them (this rank's E / ep whole experts, at full
    d_expert width, run every peer's rows, ``models.moe.ep_chunk_ffn``) and
    back, and the combine and the shared experts run at full width on the
    rank's tokens."""
    e = cfg.moe
    mode = plan.moe_dispatch if plan is not None else "einsum"
    gemm_impl = plan.moe_gemm_impl if plan is not None else "auto"
    if ctx.ep is not None:
        return _moe_ep(ctx, p, x, cfg, dtype, mode, gemm_impl)
    if ctx.tp is None:
        return moe_lib.moe_block(p, x, cfg, dtype, plan, ctx.aux_sum, ctx.n_rep)
    ring = ctx.tp
    b, s_in, d = x.shape
    xg = ring_all_gather(ring, x)                      # (B, S_loc * tp, d)
    s_full = xg.shape[1]
    n = b * s_full
    xf = xg.reshape(n, d)
    capacity = max(int(n * e.top_k / e.num_experts * e.capacity_factor), 1)
    probs, aux = moe_lib.router_probs(p, xf, cfg, dtype, ctx.aux_sum, ctx.n_rep)
    aux = scale_grad(aux, 1.0 / ring.size)
    if mode == "scatter":
        slot, wts = moe_lib.topk_scatter_dispatch(probs, cfg, capacity)
        gs = moe_lib._group_sizes_from_slots(slot, e.num_experts, capacity)
        h = moe_lib._scatter_to_buffers(xf, slot, cfg, capacity)
    else:
        dispatch, combine = moe_lib.topk_dispatch(probs, cfg, capacity)
        gs = moe_lib._group_sizes_from_dispatch(dispatch)
        h = torch.einsum("nec,nd->ecd", dispatch.to(dtype), xf)
    part = all_reduce_sum(ring, moe_lib._expert_ffn(p["experts"], h, dtype, gemm_impl, gs))
    lo = ring.rank * s_in

    def chunk_rows(a):
        """This rank's sequence chunk of a per-token tensor (token rows are
        independent)."""
        a = a.reshape((b, s_full) + a.shape[1:])[:, lo:lo + s_in]
        return a.reshape((b * s_in,) + a.shape[2:])

    if mode == "scatter":
        out = moe_lib._gather_from_buffers(part, chunk_rows(slot), chunk_rows(wts), dtype)
    else:
        out = torch.einsum("nec,ecd->nd", chunk_rows(combine).to(dtype), part)
    if e.num_shared_experts:
        sh = F.silu(xf @ p["shared"]["gate"].to(dtype)) * (xf @ p["shared"]["up"].to(dtype))
        sh_part = sh @ p["shared"]["down"].to(dtype)
        # the shared experts' width is the rank's: each rank's partial for
        # every token, summed into the chunks by the ring
        out = out + ring_reduce_scatter(ring, sh_part.reshape(b, s_full, d)).reshape(b * s_in, d)
    return out.reshape(b, s_in, d), aux


def _moe_ep(ctx: ParallelContext, p, x, cfg: ModelConfig, dtype, mode: str, gemm_impl: str):
    """:func:`moe_block_ex`'s ep branch (the reference's)."""
    e = cfg.moe
    b, s_in, d = x.shape
    n = b * s_in
    xf = x.reshape(n, d)
    capacity = max(int(n * e.top_k / e.num_experts * e.capacity_factor), 1)
    probs, aux = moe_lib.router_probs(p, xf, cfg, dtype, ctx.aux_sum, ctx.n_rep)
    if mode == "scatter":
        slot, wts = moe_lib.topk_scatter_dispatch(probs, cfg, capacity)
        h = moe_lib._scatter_to_buffers(xf, slot, cfg, capacity)
    else:
        dispatch, combine = moe_lib.topk_dispatch(probs, cfg, capacity)
        h = torch.einsum("nec,nd->ecd", dispatch.to(dtype), xf)
    fn = functools.partial(moe_lib.ep_chunk_ffn, dtype=dtype, impl=gemm_impl)
    y = dispatch_ep_a2a(fn, p["experts"], h, ring=ctx.ep, impl=ctx.ep_impl)
    if mode == "scatter":
        out = moe_lib._gather_from_buffers(y, slot, wts, dtype)
    else:
        out = torch.einsum("nec,ecd->nd", combine.to(dtype), y)
    if e.num_shared_experts:
        sh = F.silu(xf @ p["shared"]["gate"].to(dtype)) * (xf @ p["shared"]["up"].to(dtype))
        out = out + sh @ p["shared"]["down"].to(dtype)
    return out.reshape(b, s_in, d), aux


def ssm_in_ex(ctx: ParallelContext, p, x, cfg: ModelConfig, dtype):
    """The Mamba2 block before the scan for any placement: (xh, dt, A, B, C,
    z) as ``models.ssm.ssm_in_part``. Under tp ``wz/wx/wdt`` ride the ring,
    B/C come from the gathered copy (``wB/wC`` whole), and ``dt_bias``,
    ``conv_x`` and ``A_log`` are sliced to the rank's heads and channels.
    Under cp the three causal convs take the left rank's last d_conv - 1
    positions of their inputs (one halo hop for the three, concatenated)."""
    if ctx.tp is None and ctx.cp is None:
        return ssm_lib.ssm_in_part(p, x, cfg, dtype)
    s = cfg.ssm
    di, nh, g, n = ssm_lib.ssm_dims(cfg)
    nh_l, di_l = nh // ctx.n_tp, di // ctx.n_tp
    if ctx.tp is not None:
        (z, xin, dtp), xg = all_gather_matmul(
            ctx.tp, x, (p["wz"].to(dtype), p["wx"].to(dtype), p["wdt"].to(dtype)))
    else:
        z, xin, dtp, xg = x @ p["wz"].to(dtype), x @ p["wx"].to(dtype), x @ p["wdt"].to(dtype), x
    Bv = xg @ p["wB"].to(dtype)
    Cv = xg @ p["wC"].to(dtype)
    b, l = xin.shape[:2]
    dt = F.softplus(dtp.float() + _slice_tp(ctx, p["dt_bias"], nh_l))
    lx = lB = lC = None
    if ctx.cp is not None and s.d_conv > 1:
        halo = cp_halo_left(ctx, torch.cat([xin, Bv, Cv], dim=-1), s.d_conv - 1)
        lx, lB, lC = halo.split([xin.shape[-1], Bv.shape[-1], Cv.shape[-1]], dim=-1)
    xin = F.silu(ssm_lib._causal_conv(xin, _slice_tp(ctx, p["conv_x"], di_l), dtype, left=lx))
    Bv = F.silu(ssm_lib._causal_conv(Bv, p["conv_B"], dtype, left=lB))
    Cv = F.silu(ssm_lib._causal_conv(Cv, p["conv_C"], dtype, left=lC))
    A = -torch.exp(_slice_tp(ctx, p["A_log"], nh_l).float())
    return (xin.reshape(b, l, nh_l, s.head_dim), dt, A, Bv.reshape(b, l, g, n),
            Cv.reshape(b, l, g, n), z)


def ssm_out_ex(ctx: ParallelContext, p, y, xh, z, cfg: ModelConfig, dtype):
    """The Mamba2 block after the scan for any placement: the skip term, the
    gated RMSNorm and the out-projection (``models.ssm.ssm_out_part``). Under
    tp ``D`` and ``scale`` are sliced, the norm's sum of squares is summed
    over the ring (each rank normalises only its channels, so the sum's
    backward sums the cotangents), and the out-projection reduce-scatters."""
    if ctx.tp is None:
        return ssm_lib.ssm_out_part(p, y, xh, z, cfg, dtype)
    di = ssm_lib.ssm_dims(cfg)[0]
    b, l, nh_l = y.shape[:3]
    di_l = di // ctx.n_tp
    y = y + xh.float() * _slice_tp(ctx, p["D"], nh_l)[None, None, :, None]
    y = y.reshape(b, l, di_l).to(dtype)
    yz = (y * F.silu(z)).float()
    ssq = all_reduce_sum(ctx.tp, yz.square().sum(dim=-1, keepdim=True))
    yn = ((yz * torch.rsqrt(ssq / di + cfg.rms_eps))
          * (1.0 + _slice_tp(ctx, p["scale"], di_l).float())).to(dtype)
    return _proj_rows(ctx, yn, p["out_proj"].to(dtype))


def ssm_scan_ex(ctx: ParallelContext, xh, dt, A, Bm, Cm, cfg: ModelConfig,
                plan: Optional[ParallelPlan] = None):
    """The SSD scan for any placement: the dispatcher's scan of the rank's
    chunk from a zero state (y fp32). Under cp the state entering the chunk
    adds its share of y in closed form, ``C_t exp(cum dA_t) E`` (the
    recurrence is linear in its initial state, so the scan is not rerun): the
    chunk's own final state and total decay go around :func:`cp_chain_state`
    for E."""
    y, _ = dispatch_ssd_scan(xh, dt, A, Bm, Cm, chunk=cfg.ssm.chunk,
                             impl=plan.ssm_impl if plan is not None else "auto")
    if ctx.cp is None:
        return y
    b, l, h, hd = xh.shape
    g, n = Bm.shape[2], Bm.shape[3]
    hpg = h // g
    cum = torch.cumsum((dt * A).float(), dim=1)                      # (B, L, H)
    xd = (xh * dt[..., None]).float() * torch.exp(cum[:, -1:] - cum)[..., None]
    state = torch.einsum("btgn,btghp->bghpn", Bm.float(),
                         xd.reshape(b, l, g, hpg, hd)).reshape(b, h, hd, n)
    e_in = cp_chain_state(ctx, state, torch.exp(cum[:, -1]))
    y_in = torch.einsum("btgn,bghpn->btghp", Cm.float(), e_in.reshape(b, g, hpg, hd, n))
    return y + (y_in * torch.exp(cum).reshape(b, l, g, hpg, 1)).reshape(b, l, h, hd)


def ssm_block_ex(ctx: ParallelContext, p, x, cfg: ModelConfig, dtype,
                 plan: Optional[ParallelPlan] = None):
    """The Mamba2 block for any placement. x: (B, L_loc, d) -> same shape:
    :func:`ssm_in_ex`, the SSD scan on the rank's heads (:func:`ssm_scan_ex`),
    :func:`ssm_out_ex`. Locally ``models.ssm.ssm_block``."""
    if ctx.tp is None and ctx.cp is None:
        return ssm_lib.ssm_block(p, x, cfg, dtype, plan=plan)
    xh, dt, A, Bv, Cv, z = ssm_in_ex(ctx, p, x, cfg, dtype)
    return ssm_out_ex(ctx, p, ssm_scan_ex(ctx, xh, dt, A, Bv, Cv, cfg, plan), xh, z, cfg, dtype)


# ---------------------------------------------------------------------------
# layer builders

# ZeRO-3 under remat "selective": the leaves each checkpointed piece gathers
_SSM_OUT = ("D", "scale", "out_proj")


def _pre_attn(path):
    return path[0] == "norm1" or (path[0] == "attn" and path[-1] != "wo")


def _post_attn(path):
    return not _pre_attn(path)


def _pre_ssm(path):
    return path[0] == "norm1" or (path[0] == "ssm" and path[-1] not in _SSM_OUT)


def _post_ssm(path):
    return not _pre_ssm(path)


def _mid_cross(path):
    return (path == ("attn", "wo") or path[0] == "norm2"
            or (path[0] == "xattn" and path[-1] != "wo"))


def _post_cross(path):
    return path == ("xattn", "wo") or path[0] in ("norm3", "mlp")


def decoder_layer(ctx: ParallelContext, cfg: ModelConfig, plan: ParallelPlan, dtype,
                  collect_kv: bool = False):
    """The decoder-layer body (dense or MoE) under ``ctx``. ``window`` is the
    layer's int window. The layer returns ``(x, aux)``: the MoE sublayer's
    load-balancing loss, or a zero for dense layers (and the layer's (k, v)
    with ``collect_kv``: under the cp gather mode the K/V gathered over the
    ring, the whole sequence's).

    Under ZeRO-3 (``ctx.gather``) the body gathers the layer's params first,
    inside the remat boundary; ``"selective"`` gathers each piece's own.

    ``plan.remat`` (applied only while autograd records):
    ``"none"`` saves every intermediate; ``"full"`` checkpoints the whole layer,
    so the backward reruns it, the flash forward, the expert GEMMs and the
    rings included; ``"selective"`` checkpoints the glue before the attention
    call (norm, projections, rotary) and after it (output projection, MLP or
    MoE) separately, so the attention's own saved tensors (q, k, v, o, lse)
    stay and the backward does not rerun the flash forward. The reference saves
    only (o, lse) and the expert GEMMs' outputs there and recomputes the rest
    with the glue; the numbers are the same either way.
    """
    moe = cfg.family == Family.MOE
    alternating = bool(cfg.local_global_alternating and cfg.sliding_window)
    impl, remat = plan.attn_impl, plan.remat
    gather_kv = collect_kv and ctx.cp is not None and ctx.cp_impl == "gather"

    def pre(x, lp, positions):
        lp = ctx.full(lp, _pre_attn)
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        q, k, v = attn_qkv(ctx, lp["attn"], h, cfg, dtype)
        if cfg.pos_emb == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def post(x, a, lp):
        lp = ctx.full(lp, _post_attn)
        a = _proj_rows(ctx, a.reshape(a.shape[0], a.shape[1], -1), lp["attn"]["wo"].to(dtype))
        if cfg.post_norm:
            a = rms_norm(a, lp["norm1_post"]["scale"], cfg.rms_eps)
        x = x + a
        h = rms_norm(x, lp["norm2"]["scale"], cfg.rms_eps)
        if moe:
            m, aux = moe_block_ex(ctx, lp["moe"], h, cfg, dtype, plan)
        else:
            m = mlp_block_ex(ctx, lp["mlp"], h, dtype)
            aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.post_norm:
            m = rms_norm(m, lp["norm2_post"]["scale"], cfg.rms_eps)
        return x + m, aux

    def attend(q, k, v, window):
        window = window if alternating else cfg.sliding_window
        if ctx.cp is None:
            return dispatch_attention(q, k, v, impl=impl, causal=True, window=window,
                                      softcap=cfg.attn_logit_softcap)
        if ctx.cp_impl == "ring":
            return ring_attention(ctx.cp, q, k, v, impl=impl, softcap=cfg.attn_logit_softcap)
        return gather_attention(ctx, q, k, v, window=window, softcap=cfg.attn_logit_softcap,
                                impl=impl, return_kv=gather_kv)

    def body(x, lp, window, positions):
        lp = ctx.full(lp)
        q, k, v = pre(x, lp, positions)
        a = attend(q, k, v, window)
        if gather_kv:
            a, (k, v) = a
        out, aux = post(x, a, lp)
        return out, aux, (k, v)

    def selective(x, lp, window, positions):
        q, k, v = checkpoint(pre, x, lp, positions)
        a = attend(q, k, v, window)
        if gather_kv:
            a, (k, v) = a
        out, aux = checkpoint(post, x, a, lp)
        return out, aux, (k, v)

    def layer(x, lp, window, positions):
        out, aux, kv = _apply(remat, body, selective, x, lp, window, positions)
        if collect_kv:
            return out, aux, kv
        return out, aux
    return layer


def ssm_layer(ctx: ParallelContext, cfg: ModelConfig, plan: ParallelPlan, dtype):
    """The Mamba2 layer body under ``ctx``: ``(x + ssm_block_ex(norm1(x)), 0)``.
    ``window`` and ``positions`` are taken for the decoder layer's signature
    and not read.

    ``plan.remat`` (applied only while autograd records): ``"none"`` saves
    every intermediate; ``"full"`` checkpoints the whole layer, so the backward
    reruns it, the SSD forward kernel and the rings included; ``"selective"``
    checkpoints the norm, projections and convs before the scan and the skip
    term, gated norm and out-projection after it separately, so what the scan
    saved for its backward (the reference's ``ssd_out`` and ``ssd_state``: y
    and the entering states) stays and the backward does not rerun the SSD
    forward.
    """
    remat = plan.remat

    def pre(x, lp):
        lp = ctx.full(lp, _pre_ssm)
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        return ssm_in_ex(ctx, lp["ssm"], h, cfg, dtype)

    def post(x, y, xh, z, lp):
        lp = ctx.full(lp, _post_ssm)
        return x + ssm_out_ex(ctx, lp["ssm"], y, xh, z, cfg, dtype)

    def body(x, lp):
        lp = ctx.full(lp)
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        return x + ssm_block_ex(ctx, lp["ssm"], h, cfg, dtype, plan=plan)

    def selective(x, lp):
        xh, dt, A, Bv, Cv, z = checkpoint(pre, x, lp)
        y = ssm_scan_ex(ctx, xh, dt, A, Bv, Cv, cfg, plan)
        return checkpoint(post, x, y, xh, z, lp)

    def layer(x, lp, window=0, positions=None):
        del window, positions
        out = _apply(remat, body, selective, x, lp)
        return out, torch.zeros((), dtype=torch.float32, device=x.device)
    return layer


def layer_fn_for(ctx: ParallelContext, cfg: ModelConfig, plan: ParallelPlan, dtype):
    if cfg.family == Family.SSM:
        return ssm_layer(ctx, cfg, plan, dtype)
    return decoder_layer(ctx, cfg, plan, dtype)


# ---------------------------------------------------------------------------
# the tensor- and context-parallel loss


def make_executor_loss_fn(cfg: ModelConfig, plan: ParallelPlan, mesh, z_loss: float = 0.0):
    """``loss_fn(params, batch)`` through the executor on ``mesh``'s tp, cp
    and ep rings or, for the MoE family, its data group alone (the
    reference's ``make_executor_loss_fn``): the embedding (vocab-parallel
    under tp), the layers under ``plan.remat``, the final norm on the rank's
    chunk, and the head (vocab-parallel under tp).

    ``params`` are this rank's parts (``core.sharding.shard_layout``: its TP
    shards, its expert blocks under ep; whole without either, and the same on
    every cp rank bar the expert blocks); ``batch`` holds this
    rank's rows (its data group's, ``rank_microbatches``) with the whole
    sequence, the same on every rank of the tp and cp rings. Under cp the
    rank takes its chunk of the sequence: in the ring mode (outside the SSM
    family) after the zigzag permutation of tokens and labels, contiguous
    otherwise; rope runs at the true global positions. The loss is the mean
    over those rows and the whole sequence: under cp the nll is summed over
    the cp ring (every rank consumes the sum alike, so its backward passes the
    cotangent through) and divided by the rows' token count, so the cp ranks'
    grads sum to the grads of that loss (the train step sums them); the mean
    over the data ranks is the train step's, as under data parallelism alone.
    Returns ``(loss + aux, {"xent", "moe_aux"})``, the same on every rank of
    the tp and cp rings."""
    from repro_torch.models.families import (_embed, _layer_windows, _logits,  # noqa: PLC0415
                                             head_params)
    ctx = resolve_context(cfg, plan, mesh)
    if ctx.is_local:
        raise ValueError("the executor loss needs tensor, context or expert parallelism (a "
                         "'model' mesh axis >= 2 with plan.tp or plan.ep its size, or "
                         "plan.cp > 1 with a 'cp' axis of that size), or the MoE family "
                         "under a data axis")
    dtype = resolve_dtype(plan.compute_dtype)
    windows = _layer_windows(cfg)
    layer = layer_fn_for(ctx, cfg, plan, dtype)
    n_cp, n_tp = ctx.n_cp, ctx.n_tp
    zigzag = ctx.cp is not None and ctx.cp_impl == "ring" and cfg.family != Family.SSM

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        b, s = tokens.shape
        split = 2 * n_cp if zigzag else n_cp
        if s % split or (s // n_cp) % n_tp:
            raise ValueError(f"sequence {s} does not split over cp={n_cp} "
                             f"({'zigzag, ' if zigzag else ''}tp={n_tp})")
        s_loc = s // n_cp
        if ctx.cp is not None:
            if zigzag:
                perm = torch.from_numpy(zigzag_permutation(s, n_cp)).to(tokens.device)
                tokens, labels = tokens[:, perm], labels[:, perm]
            lo = ctx.cp.rank * s_loc
            tokens, labels = tokens[:, lo:lo + s_loc], labels[:, lo:lo + s_loc]
        if ctx.tp is not None:
            x = tp_embed(params, tokens, cfg, dtype, ctx.tp)
        else:
            x = _embed({"embed": ctx.full(params["embed"])}, tokens, cfg, dtype)
        positions = cp_local_positions(ctx, s_loc, zigzag, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, w in zip(params["layers"], windows):
            x, a = layer(x, lp, w, positions)
            aux = aux + a
        x = rms_norm(x, ctx.full(params["final_norm"])["scale"], cfg.rms_eps)
        if ctx.tp is not None:
            nll = tp_head_nll(params, x, labels, cfg, ctx.tp, dtype, z_loss)
        else:
            nll = cross_entropy(_logits(ctx.full(head_params(params, cfg)), x, cfg, dtype),
                                labels, z_loss=z_loss, reduction="none")
        tot = nll.sum()
        if ctx.cp is not None:
            tot = all_reduce_replicated(ctx.cp, tot)
        loss = tot / (b * s)
        return loss + aux, {"xent": loss, "moe_aux": aux}

    return loss_fn


def encoder_layer(cfg: ModelConfig, plan: ParallelPlan, dtype,
                  gather: Optional[Callable] = None):
    """whisper's encoder layer: ``x + attn(norm1(x))`` with non-causal
    self-attention through ``dispatch_attention``, then ``x + mlp(norm2(x))``.
    ``plan.remat`` as in :func:`decoder_layer`: ``"selective"`` checkpoints
    the norm and projections before the attention call and the output
    projection and MLP after it, keeping what the kernels saved. ``gather``:
    ZeRO-3's, as in :func:`decoder_layer`."""
    impl = plan.attn_impl
    ctx = local_context(gather)

    def pre(x, lp):
        lp = ctx.full(lp, _pre_attn)
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        return qkv_proj(lp["attn"], h, cfg, dtype)

    def post(x, lp, a):
        lp = ctx.full(lp, _post_attn)
        x = x + a.reshape(x.shape[0], x.shape[1], -1) @ lp["attn"]["wo"].to(dtype)
        h = rms_norm(x, lp["norm2"]["scale"], cfg.rms_eps)
        return x + mlp_block(lp["mlp"], h, dtype)

    def attend(q, k, v):
        return dispatch_attention(q, k, v, impl=impl, causal=False)

    def body(x, lp):
        lp = ctx.full(lp)
        return post(x, lp, attend(*pre(x, lp)))

    def selective(x, lp):
        q, k, v = checkpoint(pre, x, lp)
        return checkpoint(post, x, lp, attend(q, k, v))

    def layer(x, lp):
        return _apply(plan.remat, body, selective, x, lp)
    return layer


def cross_decoder_layer(cfg: ModelConfig, plan: ParallelPlan, dtype,
                        gather: Optional[Callable] = None):
    """whisper's decoder layer: causal self-attention (norm1), cross-attention
    of the queries to the encoder output's keys and values (norm2; k and v
    from ``enc_out @ xattn.wk/wv``, non-causal), then the MLP (norm3). Both
    attention calls go through ``dispatch_attention``. ``plan.remat`` as in
    :func:`decoder_layer`; ``"selective"`` checkpoints the three pieces of glue
    around the two attention calls. ``enc_out`` is an input of the whole layer
    under ``"full"`` and of the middle piece under ``"selective"``, so its
    gradient flows back through every layer's ``xattn.wk/wv``. ``gather``:
    ZeRO-3's, as in :func:`decoder_layer`."""
    impl = plan.attn_impl
    hq, hd = cfg.n_heads, cfg.head_dim
    ctx = local_context(gather)

    def pre(x, lp):
        lp = ctx.full(lp, _pre_attn)
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        return qkv_proj(lp["attn"], h, cfg, dtype)

    def mid(x, lp, enc_out, a):
        lp = ctx.full(lp, _mid_cross)
        b, s = x.shape[:2]
        x = x + a.reshape(b, s, -1) @ lp["attn"]["wo"].to(dtype)
        h = rms_norm(x, lp["norm2"]["scale"], cfg.rms_eps)
        q = (h @ lp["xattn"]["wq"].to(dtype)).reshape(b, s, hq, hd)
        return (x, q, *cross_kv(cfg, lp, enc_out, dtype))

    def post(x, lp, a):
        lp = ctx.full(lp, _post_cross)
        x = x + a.reshape(x.shape[0], x.shape[1], -1) @ lp["xattn"]["wo"].to(dtype)
        h = rms_norm(x, lp["norm3"]["scale"], cfg.rms_eps)
        return x + mlp_block(lp["mlp"], h, dtype)

    def self_attend(q, k, v):
        return dispatch_attention(q, k, v, impl=impl, causal=True)

    def cross_attend(q, k, v):
        return dispatch_attention(q, k, v, impl=impl, causal=False)

    def body(x, lp, enc_out):
        lp = ctx.full(lp)
        x, q, k, v = mid(x, lp, enc_out, self_attend(*pre(x, lp)))
        return post(x, lp, cross_attend(q, k, v))

    def selective(x, lp, enc_out):
        q, k, v = checkpoint(pre, x, lp)
        x, q, k, v = checkpoint(mid, x, lp, enc_out, self_attend(q, k, v))
        return checkpoint(post, x, lp, cross_attend(q, k, v))

    def layer(x, lp, enc_out):
        return _apply(plan.remat, body, selective, x, lp, enc_out)
    return layer


def cross_kv(cfg: ModelConfig, lp, enc_out, dtype):
    """One decoder layer's cross-attention keys and values from the encoder
    output (the reference's ``_enc_kv``): (B, F, Hkv, hd) each."""
    b, f = enc_out.shape[:2]
    k = (enc_out @ lp["xattn"]["wk"].to(dtype)).reshape(b, f, cfg.n_kv_heads, cfg.head_dim)
    v = (enc_out @ lp["xattn"]["wv"].to(dtype)).reshape(b, f, cfg.n_kv_heads, cfg.head_dim)
    return k, v
