"""Overlap tensor parallelism: collective matmuls and sequence sharding (port
of ``repro/train/tensor_parallel.py``, survey §4.1.2, §4.1.4, §5.2).

The ring primitives, each a ``torch.autograd.Function`` whose backward is the
reference's mirrored ring:

- :func:`all_gather_matmul` — the column GEMM with the sequence all-gather
  split into ring ticks: ``x`` is this rank's (B, S/tp, d) chunk; each tick
  multiplies the chunk the rank holds by its column shard(s) of the weight
  while the chunk moves one rank on. Its backward reduce-scatters dx and
  contracts the re-gathered x for each dw in one fp32 GEMM.
- :func:`matmul_reduce_scatter` — the row GEMM with the reduce-scatter split
  into ticks: the partial-sum accumulator rides the ring. Its backward
  re-gathers the output cotangent.
- :func:`ring_all_gather` / :func:`ring_reduce_scatter` — the same two rings
  without the GEMM, each the other's backward.

Between blocks the residual stream stays sequence-sharded, (B, S/tp, d)
(Megatron-SP); only a block's interior (attention heads, expert FFN columns,
SSD heads, all model-sharded) sees the whole sequence. :func:`tp_embed` is the
vocab-parallel embedding (masked lookups reduce-scattered into sequence
chunks) and :func:`tp_head_nll` the head GEMM fused with the all-gather and
the vocab-parallel loss (``train.loss.cross_entropy_vp``): the (B, S, V)
logits are never materialised. The family blocks that use these live in
``train/executor.py``.

Each tick is one ``ModelRing.shift`` (``launch/mesh.py``): a
``batch_isend_irecv`` pair to the next and previous ranks, through host
copies when the ranks share a card over gloo. The payloads stay in the compute
dtype. The reference's ``RingCtx`` (axis name, size) is the port's
``launch.mesh.ModelRing``, which also carries the transport. Every partial GEMM goes
through ``kernels.dispatch.dispatch_tp_matmul``. The payload landing on each
forward all-gather tick passes the ``tp.ring.tick`` fault seam, as in the
reference (``ft/inject.py``).

The backward of an all-reduce depends on who consumes its output. Each rank
back-propagates its own copy of the loss, seeded with 1, where the reference
seeds 1/n and transposes every ``psum`` to a ``psum``; the two agree when an
all-reduce whose output every rank consumes the same way (the vocab-parallel
loss's sums) passes its cotangent through (:func:`all_reduce_replicated`)
and one whose output each rank consumes for its own share of the work (the
MoE partials after ``chunk_rows``, the gated norm's sum of squares) sums the
cotangents (:func:`all_reduce_sum`). The grads of model-replicated leaves
(norm scales, ``bq/bk/bv``, the router, ``wB/wC``, the SSM per-head leaves)
are each rank's share and are summed over the ring by the train step.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.core.config import Family, ModelConfig, ParallelPlan
from repro_torch.ft.inject import taint
from repro_torch.kernels.dispatch import dispatch_tp_matmul
from repro_torch.launch.mesh import ModelRing
from .loss import cross_entropy_vp

def _seq_slice(x, start: int, n: int):
    return x[:, start:start + n]


def _ag_matmul_impl(ring: ModelRing, x, ws: Sequence[torch.Tensor],
                    seam: Optional[str] = "tp.ring.tick"):
    """The all-gather ring: (outs, x_full), tick k multiplying the chunk of
    rank ``idx - k`` that this rank holds; each landing payload passes the
    fault seam ``seam`` (none when None)."""
    t, s_loc, idx = ring.size, x.shape[1], ring.rank
    outs = [x.new_empty(x.shape[:1] + (t * s_loc, w.shape[-1]),
                        dtype=torch.result_type(x, w)) for w in ws]
    xg = x.new_empty(x.shape[:1] + (t * s_loc,) + x.shape[2:])
    cur = x
    for k in range(t):
        start = ((idx - k) % t) * s_loc
        for out, w in zip(outs, ws):
            _seq_slice(out, start, s_loc).copy_(dispatch_tp_matmul(cur, w))
        _seq_slice(xg, start, s_loc).copy_(cur)
        if k < t - 1:
            # fault seam: the ring payload as it lands from the hop
            cur = ring.shift(cur, 1)
            if seam is not None:
                cur = taint(seam, cur)
    return outs, xg


def _ring_rs_impl(ring: ModelRing, x):
    """The reduce-scatter ring: the accumulator of chunk ``idx - k - 1``
    rides one rank on per tick; the last tick adds the rank's own chunk."""
    t, idx = ring.size, ring.rank
    s_loc = x.shape[1] // t
    acc = None
    for k in range(t):
        tile = _seq_slice(x, ((idx - k - 1) % t) * s_loc, s_loc)
        acc = tile.clone() if k == 0 else acc + tile
        if k < t - 1:
            acc = ring.shift(acc, 1)
    return acc


def _dw(xt, dout, w):
    """A weight grad in one fp32 GEMM over every (batch, position) row:
    ``xt`` (k, B*S) fp32 against ``dout`` (B, S, f), as the reference's fp32
    einsum, folded as autograd folds the same matmul on one device."""
    return (xt @ dout.float().reshape(-1, dout.shape[-1])).to(w.dtype)


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, x, *ws):
        ctx.ring = ring
        ctx.save_for_backward(x, *ws)
        ctx.set_materialize_grads(False)
        outs, xg = _ag_matmul_impl(ring, x, ws)
        return (*outs, xg)

    @staticmethod
    def backward(ctx, *cts):
        """Mirrored reversed ring: dx is a reduce-scatter of
        sum_w dout_w w^T (plus the gathered copy's cotangent); dw_w contracts
        the re-gathered x against dout_w in one fp32 GEMM."""
        ring = ctx.ring
        x, *ws = ctx.saved_tensors
        douts, dxg = cts[:-1], cts[-1]
        t, s_loc, idx = ring.size, x.shape[1], ring.rank
        dtype = torch.result_type(x, ws[0]) if ws else x.dtype
        cur, acc = x, None
        xg = x.new_empty(x.shape[:1] + (t * s_loc,) + x.shape[2:])
        for k in range(t):
            _seq_slice(xg, ((idx + k) % t) * s_loc, s_loc).copy_(cur)
            # this tick's tile is for the chunk whose accumulator sits here
            start = ((idx + k + 1) % t) * s_loc
            tile = (x.new_zeros(x.shape, dtype=dtype) if dxg is None
                    else _seq_slice(dxg, start, s_loc).to(dtype))
            for w, dout in zip(ws, douts):
                if dout is not None:
                    tile = tile + dispatch_tp_matmul(_seq_slice(dout, start, s_loc),
                                                     w.T).to(dtype)
            acc = tile if k == 0 else acc + tile
            if k < t - 1:
                cur = ring.shift(cur, -1)
                acc = ring.shift(acc, -1)
        xf = xg.float().reshape(-1, xg.shape[-1]).T
        dws = [None if dout is None else _dw(xf, dout, w) for w, dout in zip(ws, douts)]
        return (None, acc.to(x.dtype), *dws)


def all_gather_matmul(ring: ModelRing, x, ws: Sequence[torch.Tensor]):
    """Column GEMMs with the sequence all-gather fused into the ring ticks.

    ``x``: (B, S/tp, d) sequence chunk; ``ws``: (d, f_loc) column shards.
    Returns ``(outs, x_full)``: ``outs[i]`` (B, S, f_loc), the whole
    sequence's product with this rank's shard, and ``x_full`` (B, S, d), the
    gathered input (a by-product of the ring that callers projecting against
    replicated weights reuse, e.g. Mamba2's B/C)."""
    *outs, xg = _AllGatherMatmul.apply(ring, x, *ws)
    return tuple(outs), xg


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, h, w):
        ctx.ring = ring
        ctx.save_for_backward(h, w)
        t, idx = ring.size, ring.rank
        s_loc = h.shape[1] // t
        acc = None
        for k in range(t):
            tile = dispatch_tp_matmul(_seq_slice(h, ((idx - k - 1) % t) * s_loc, s_loc), w)
            acc = tile if k == 0 else acc + tile
            if k < t - 1:
                acc = ring.shift(acc, 1)
        return acc

    @staticmethod
    def backward(ctx, dout):
        """Mirrored reversed ring: dh re-gathers the output cotangent and
        multiplies each landing chunk by w^T; dw contracts h against the
        gathered cotangent in one fp32 GEMM."""
        ring = ctx.ring
        h, w = ctx.saved_tensors
        t, s_loc, idx = ring.size, dout.shape[1], ring.rank
        cur = dout
        dg = dout.new_empty(dout.shape[:1] + (t * s_loc,) + dout.shape[2:])
        dh = torch.empty_like(h)
        for k in range(t):
            start = ((idx + k) % t) * s_loc
            _seq_slice(dg, start, s_loc).copy_(cur)
            _seq_slice(dh, start, s_loc).copy_(dispatch_tp_matmul(cur, w.T))
            if k < t - 1:
                cur = ring.shift(cur, -1)
        return None, dh, _dw(h.float().reshape(-1, h.shape[-1]).T, dg, w)


def matmul_reduce_scatter(ring: ModelRing, h, w):
    """Row GEMM with the reduce-scatter fused into the ring ticks. ``h``:
    (B, S, f_loc), the whole sequence on this rank's feature shard; ``w``:
    (f_loc, d) row shard. Returns (B, S/tp, d): this rank's chunk of the
    summed product."""
    return _MatmulReduceScatter.apply(ring, h, w)


class _RingAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, x, seam):
        ctx.ring = ring
        return _ag_matmul_impl(ring, x, (), seam)[1]

    @staticmethod
    def backward(ctx, dxg):
        return None, _ring_rs_impl(ctx.ring, dxg), None


def ring_all_gather(ring: ModelRing, x, seam: Optional[str] = "tp.ring.tick"):
    """(B, S/tp, ...) chunk -> (B, S, ...) through the ring; its backward is
    the mirrored reduce-scatter (no dead re-gather ring). The landing payloads
    pass the fault seam ``seam`` (the cp gather's pass none, as the
    reference's all-gather has none)."""
    return _RingAllGather.apply(ring, x, seam)


class _RingReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, x):
        ctx.ring = ring
        return _ring_rs_impl(ring, x)

    @staticmethod
    def backward(ctx, dout):
        return None, _ag_matmul_impl(ctx.ring, dout, ())[1]


def ring_reduce_scatter(ring: ModelRing, x):
    """(B, S, ...) per-rank partial -> (B, S/tp, ...) summed chunk, the
    accumulator riding the ring; its backward is the all-gather (the sum's
    transpose replicates the chunk cotangents)."""
    return _RingReduceScatter.apply(ring, x)


def _sum_over(ring, x):
    """The sum of ``x`` over ``ring`` (a ``ModelRing``, or a ``DataMesh``,
    whose sum is in place) as a new tensor."""
    if isinstance(ring, ModelRing):
        return ring.all_reduce_sum(x)
    return ring.all_reduce_sum(x.detach().contiguous().clone())


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, x):
        ctx.ring = ring
        return _sum_over(ring, x)

    @staticmethod
    def backward(ctx, g):
        return None, _sum_over(ctx.ring, g)


def all_reduce_sum(ring, x):
    """The sum of ``x`` over the ring (a ``ModelRing``, or a ``DataMesh``),
    for an output each rank consumes for its own share of the work: the
    backward sums the cotangents (module docstring)."""
    return _AllReduceSum.apply(ring, x)


class _AllReduceReplicated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, x):
        return _sum_over(ring, x)

    @staticmethod
    def backward(ctx, g):
        return None, g


def all_reduce_replicated(ring, x):
    """The sum of ``x`` over the ring (a ``ModelRing``, or a ``DataMesh``),
    for an output every rank consumes the same way (the replicated loss): the
    backward passes the cotangent through (module docstring)."""
    return _AllReduceReplicated.apply(ring, x)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, x, step):
        ctx.ring, ctx.step = ring, step
        return ring.shift(x, step)

    @staticmethod
    def backward(ctx, g):
        return None, ctx.ring.shift(g.contiguous(), -ctx.step), None


def ring_shift(ring: ModelRing, x, step: int = 1):
    """``x`` sent ``step`` (+1 or -1) hops along the ring, differentiable: the
    backward sends the cotangent back the other way. Every rank must run it
    (and so its backward), as every ring collective."""
    return _Shift.apply(ring, x, step)


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def scale_grad(x, scale: float):
    """``x`` with its cotangent multiplied by ``scale``: a term every rank of
    the ring computes whole (the MoE aux loss from the gathered tokens) is
    back-propagated ``1 / tp`` a rank, so that its share of the summed grads
    counts once."""
    return _ScaleGrad.apply(x, scale)


# ---------------------------------------------------------------------------
# sequence-sharded embedding / head


def tp_embed(params, tokens, cfg: ModelConfig, dtype, ring: ModelRing):
    """Vocab-parallel embedding producing the sequence-sharded residual
    stream. ``tokens``: (B, S), the whole sequence on every rank; the table
    is this rank's vocab shard (V/tp, d). Each rank looks every position up in
    its shard (zeros where the id lives elsewhere), cast to the compute dtype
    before the ring (each row has one non-zero contributor, so nothing is
    summed across ranks and the ticks move half the bytes under bf16), and
    the ring reduce-scatter sums the partials into (B, S/tp, d) chunks."""
    tab = params["embed"]["tok"]
    v_loc = tab.shape[0]
    local = tokens.long() - ring.rank * v_loc
    ok = (local >= 0) & (local < v_loc)
    rows = tab[local.clamp(0, v_loc - 1)].to(dtype)
    rows = torch.where(ok[..., None], rows, torch.zeros((), dtype=dtype, device=rows.device))
    x = ring_reduce_scatter(ring, rows)
    if cfg.scale_embed:
        x = x * torch.full((), math.sqrt(cfg.d_model), dtype=dtype, device=x.device)
    return x


def tp_head_nll(params, x, labels, cfg: ModelConfig, ring: ModelRing, dtype,
                z_loss: float = 0.0):
    """LM head and vocab-parallel cross-entropy on a (B, S/tp, d) chunk: the
    sequence all-gather fused into the head GEMM's ticks, logits kept
    vocab-sharded (B, S, V/tp), the final softcap applied, a padded vocab
    tail masked to -1e9. Returns the per-position nll (B, S), the same on
    every rank of the ring."""
    if cfg.tie_embeddings:
        w = params["embed"]["tok"].to(dtype).T
    else:
        w = params["lm_head"]["w"].to(dtype)
    (logits,), _ = all_gather_matmul(ring, x, (w,))
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    logits = logits.float()
    v_loc = logits.shape[-1]
    idx = ring.rank
    if v_loc * ring.size != cfg.vocab:
        # Megatron-style padded vocab: mask this shard's padded tail
        gid = idx * v_loc + torch.arange(v_loc, device=logits.device)
        logits = torch.where(gid >= cfg.vocab, -1e9, logits)
    return cross_entropy_vp(logits, labels, ring, shard_index=idx, z_loss=z_loss)


# ---------------------------------------------------------------------------
# preconditions


def decoder_only_support_errors(cfg: ModelConfig):
    """The static preconditions the explicit ring paths share: decoder-only
    dense / MoE / SSM families, rope positions. A list of problems (empty:
    supported)."""
    bad = []
    if cfg.family not in (Family.DENSE, Family.MOE, Family.SSM) \
            or cfg.is_enc_dec or cfg.vision_tokens:
        bad.append(f"family {cfg.family!r} (dense/moe/ssm decoder-only)")
    elif cfg.family in (Family.DENSE, Family.MOE) and cfg.pos_emb != "rope":
        bad.append(f"pos_emb {cfg.pos_emb!r}")
    return bad


def check_overlap_support(cfg: ModelConfig, plan: ParallelPlan, tp: int):
    """Static preconditions of the rings at degree ``tp``; raises ValueError
    naming every one that fails."""
    bad = decoder_only_support_errors(cfg)
    vocab = cfg.vocab
    if plan.pad_vocab_to_multiple:
        vocab = -(-vocab // plan.pad_vocab_to_multiple) * plan.pad_vocab_to_multiple
    if vocab % tp:
        bad.append(f"vocab {vocab} % tp {tp} != 0 (set pad_vocab_to_multiple)")
    if cfg.family in (Family.DENSE, Family.MOE):
        if cfg.n_heads % tp or cfg.n_kv_heads % tp:
            bad.append(f"heads ({cfg.n_heads}, {cfg.n_kv_heads}) % tp != 0")
    if cfg.family == Family.DENSE and cfg.d_ff % tp:
        bad.append(f"d_ff {cfg.d_ff} % tp != 0")
    if cfg.family == Family.MOE:
        if cfg.moe.d_expert % tp:
            bad.append(f"d_expert {cfg.moe.d_expert} % tp != 0")
        if cfg.moe.num_shared_experts and \
                (cfg.moe.d_expert * cfg.moe.num_shared_experts) % tp:
            bad.append("shared-expert width % tp != 0")
    if cfg.family == Family.SSM:
        di = cfg.ssm.expand * cfg.d_model
        if di % tp or (di // cfg.ssm.head_dim) % tp:
            bad.append(f"d_inner {di} or heads % tp != 0")
        if cfg.ssm.n_groups != 1:
            bad.append(f"n_groups {cfg.ssm.n_groups} != 1")
    if bad:
        raise ValueError("tp_impl='overlap' unsupported here: " + "; ".join(bad))
