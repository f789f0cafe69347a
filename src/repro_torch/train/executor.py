"""The family blocks and layer bodies under a placement, and the
tensor-parallel loss (port of ``repro/train/executor.py`` and of the layer
bodies of ``repro/models/families.build_enc_dec``).

The reference's executor defines each family's math once and lets a
:class:`ParallelContext` place it. The port has two placements:

- local (``ctx.tp is None``, :func:`local_context`): the single-device bodies
  every model runs, unchanged by the context;
- ``ctx.tp``, the model ring of a (data, model) grid (``launch.mesh``,
  ``train/tensor_parallel.py``): column GEMMs take the sequence all-gather in
  their ring ticks (:func:`_proj_cols`), row GEMMs reduce-scatter
  (:func:`_proj_rows`), and the residual stream stays (B, S/tp, d) between
  blocks. Attention runs on the rank's heads (q/k/v biases sliced, rope on the
  whole sequence's positions); the SwiGLU MLP on its FFN columns
  (:func:`mlp_block_ex`); MoE gathers the tokens, routes them on every rank,
  runs the experts on the rank's d_expert columns and sums the partials
  (:func:`moe_block_ex`); Mamba2 fuses the in-projection into the ring,
  computes B/C on the gathered copy and runs the SSD scan on the rank's heads,
  its gated RMSNorm summing the squares over the ring (:func:`ssm_block_ex`).

The reference's cp and ep fields come with the context- and expert-parallel
slices (ROADMAP A13.3, A13.4). :func:`make_executor_loss_fn` assembles the
tensor-parallel loss: the vocab-parallel embedding, the layers (``plan.remat``
per layer), the final norm and the vocab-parallel head.

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
from typing import Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.core.config import Family, ModelConfig, ParallelPlan
from repro_torch.core.device import resolve_dtype
from repro_torch.ft.inject import remat_context
from repro_torch.kernels.dispatch import (dispatch_attention, dispatch_ssd_scan,
                                          select_tp_impl)
from repro_torch.launch.mesh import model_size
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.layers import mlp_block, qkv_proj, rms_norm, rope
from repro_torch.launch.mesh import ModelRing
from .tensor_parallel import (all_gather_matmul, all_reduce_sum,
                              check_overlap_support, matmul_reduce_scatter,
                              ring_all_gather, ring_reduce_scatter, scale_grad, tp_embed,
                              tp_head_nll)


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
    """How a family block runs: ``tp`` is the model ring (``None``: local).
    The reference's cp and ep rings come with their slices."""
    tp: Optional[ModelRing] = None

    @property
    def n_tp(self) -> int:
        return self.tp.size if self.tp is not None else 1


def local_context() -> ParallelContext:
    """The single-device placement: every block its local body."""
    return ParallelContext()


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


def resolve_context(cfg: ModelConfig, plan: ParallelPlan, mesh) -> ParallelContext:
    """The placement of ``plan`` on ``mesh`` (the TP half of the reference's
    ``resolve_context``): ``plan.tp`` must be the size of the mesh's model
    axis (1 without one), and the rings run when it is 2 or more, on a config
    that passes ``check_overlap_support``. The reference also lets a plan
    with ``tp`` 1 run on a model axis, for its cp and ep rings; the port has
    neither yet (ROADMAP A13.3, A13.4), so it refuses such a plan rather than
    run the whole model on every model rank."""
    select_tp_impl(plan.tp_impl)
    tp = model_size(mesh)
    if plan.tp != tp:
        raise ValueError(f"plan.tp={plan.tp} needs a 'model' mesh axis of that size, "
                         f"the mesh has {dict(mesh.shape) if mesh is not None else None}")
    if tp == 1:
        return local_context()
    check_overlap_support(cfg, plan, tp)
    return ParallelContext(tp=mesh.model)


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
    (``scale_grad``) and its share of the summed router grads counts once."""
    if ctx.tp is None:
        return moe_lib.moe_block(p, x, cfg, dtype, plan)
    e = cfg.moe
    mode = plan.moe_dispatch if plan is not None else "einsum"
    gemm_impl = plan.moe_gemm_impl if plan is not None else "auto"
    ring = ctx.tp
    b, s_in, d = x.shape
    xg = ring_all_gather(ring, x)                      # (B, S_loc * tp, d)
    s_full = xg.shape[1]
    n = b * s_full
    xf = xg.reshape(n, d)
    capacity = max(int(n * e.top_k / e.num_experts * e.capacity_factor), 1)
    probs, aux = moe_lib.router_probs(p, xf, cfg, dtype)
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


def ssm_in_ex(ctx: ParallelContext, p, x, cfg: ModelConfig, dtype):
    """The Mamba2 block before the scan for any placement: (xh, dt, A, B, C,
    z) as ``models.ssm.ssm_in_part``. Under tp ``wz/wx/wdt`` ride the ring,
    B/C come from the gathered copy (``wB/wC`` whole), and ``dt_bias``,
    ``conv_x`` and ``A_log`` are sliced to the rank's heads and channels."""
    if ctx.tp is None:
        return ssm_lib.ssm_in_part(p, x, cfg, dtype)
    s = cfg.ssm
    di, nh, g, n = ssm_lib.ssm_dims(cfg)
    nh_l, di_l = nh // ctx.n_tp, di // ctx.n_tp
    (z, xin, dtp), xg = all_gather_matmul(
        ctx.tp, x, (p["wz"].to(dtype), p["wx"].to(dtype), p["wdt"].to(dtype)))
    Bv = xg @ p["wB"].to(dtype)
    Cv = xg @ p["wC"].to(dtype)
    b, l = xin.shape[:2]
    dt = F.softplus(dtp.float() + _slice_tp(ctx, p["dt_bias"], nh_l))
    xin = F.silu(ssm_lib._causal_conv(xin, _slice_tp(ctx, p["conv_x"], di_l), dtype))
    Bv = F.silu(ssm_lib._causal_conv(Bv, p["conv_B"], dtype))
    Cv = F.silu(ssm_lib._causal_conv(Cv, p["conv_C"], dtype))
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


def ssm_block_ex(ctx: ParallelContext, p, x, cfg: ModelConfig, dtype,
                 plan: Optional[ParallelPlan] = None):
    """The Mamba2 block for any placement. x: (B, L_loc, d) -> same shape:
    :func:`ssm_in_ex`, the SSD scan on the rank's heads through the
    dispatcher, :func:`ssm_out_ex`. Locally ``models.ssm.ssm_block``."""
    if ctx.tp is None:
        return ssm_lib.ssm_block(p, x, cfg, dtype, plan=plan)
    xh, dt, A, Bv, Cv, z = ssm_in_ex(ctx, p, x, cfg, dtype)
    y, _ = dispatch_ssd_scan(xh, dt, A, Bv, Cv, chunk=cfg.ssm.chunk,
                             impl=plan.ssm_impl if plan is not None else "auto")
    return ssm_out_ex(ctx, p, y, xh, z, cfg, dtype)


# ---------------------------------------------------------------------------
# layer builders


def decoder_layer(ctx: ParallelContext, cfg: ModelConfig, plan: ParallelPlan, dtype,
                  collect_kv: bool = False):
    """The decoder-layer body (dense or MoE) under ``ctx``. ``window`` is the
    layer's int window. The layer returns ``(x, aux)``: the MoE sublayer's
    load-balancing loss, or a zero for dense layers (and the layer's (k, v)
    with ``collect_kv``).

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

    def pre(x, lp, positions):
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        q, k, v = attn_qkv(ctx, lp["attn"], h, cfg, dtype)
        if cfg.pos_emb == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def post(x, a, lp):
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
        return dispatch_attention(q, k, v, impl=impl, causal=True,
                                  window=window if alternating else cfg.sliding_window,
                                  softcap=cfg.attn_logit_softcap)

    def body(x, lp, window, positions):
        q, k, v = pre(x, lp, positions)
        out, aux = post(x, attend(q, k, v, window), lp)
        return out, aux, (k, v)

    def selective(x, lp, window, positions):
        q, k, v = checkpoint(pre, x, lp, positions)
        out, aux = checkpoint(post, x, attend(q, k, v, window), lp)
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
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        return ssm_in_ex(ctx, lp["ssm"], h, cfg, dtype)

    def post(x, y, xh, z, lp):
        return x + ssm_out_ex(ctx, lp["ssm"], y, xh, z, cfg, dtype)

    def body(x, lp):
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        return x + ssm_block_ex(ctx, lp["ssm"], h, cfg, dtype, plan=plan)

    def selective(x, lp):
        xh, dt, A, Bv, Cv, z = checkpoint(pre, x, lp)
        y, _ = dispatch_ssd_scan(xh, dt, A, Bv, Cv, chunk=cfg.ssm.chunk, impl=plan.ssm_impl)
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
# the tensor-parallel loss


def make_executor_loss_fn(cfg: ModelConfig, plan: ParallelPlan, mesh, z_loss: float = 0.0):
    """``loss_fn(params, batch)`` through the executor on ``mesh``'s model
    ring (the reference's ``make_executor_loss_fn`` on tp alone): the
    vocab-parallel embedding, the layers under ``plan.remat``, the final norm
    on the sequence chunk, and the vocab-parallel head and loss.

    ``params`` are this rank's TP shards (``core.sharding.shard_params``);
    ``batch`` holds this rank's rows (its data group's, ``rank_microbatches``)
    with the whole sequence, the same on every rank of the ring. The loss is
    the mean over those rows: the mean over the data ranks is the train
    step's, as under data parallelism alone (its grads reduce-scatter as a
    mean over the data group). Returns ``(loss + aux, {"xent", "moe_aux"})``,
    the same on every rank of the ring."""
    from repro_torch.models.families import _layer_windows  # noqa: PLC0415 (import cycle)
    ctx = resolve_context(cfg, plan, mesh)
    if ctx.tp is None:
        raise ValueError("the executor loss needs tensor parallelism: a 'model' mesh axis "
                         ">= 2 and plan.tp its size")
    dtype = resolve_dtype(plan.compute_dtype)
    windows = _layer_windows(cfg)
    layer = layer_fn_for(ctx, cfg, plan, dtype)
    ring = ctx.tp

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        s = tokens.shape[1]
        if s % ring.size:
            raise ValueError(f"sequence {s} does not split over tp={ring.size}")
        x = tp_embed(params, tokens, cfg, dtype, ring)
        positions = torch.arange(s, device=x.device)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp, w in zip(params["layers"], windows):
            x, a = layer(x, lp, w, positions)
            aux = aux + a
        x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_eps)
        loss = tp_head_nll(params, x, labels, cfg, ring, dtype, z_loss).mean()
        return loss + aux, {"xent": loss, "moe_aux": aux}

    return loss_fn


def encoder_layer(cfg: ModelConfig, plan: ParallelPlan, dtype):
    """whisper's encoder layer: ``x + attn(norm1(x))`` with non-causal
    self-attention through ``dispatch_attention``, then ``x + mlp(norm2(x))``.
    ``plan.remat`` as in :func:`decoder_layer`: ``"selective"`` checkpoints
    the norm and projections before the attention call and the output
    projection and MLP after it, keeping what the kernels saved."""
    impl = plan.attn_impl

    def pre(x, lp):
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        return qkv_proj(lp["attn"], h, cfg, dtype)

    def post(x, lp, a):
        x = x + a.reshape(x.shape[0], x.shape[1], -1) @ lp["attn"]["wo"].to(dtype)
        h = rms_norm(x, lp["norm2"]["scale"], cfg.rms_eps)
        return x + mlp_block(lp["mlp"], h, dtype)

    def attend(q, k, v):
        return dispatch_attention(q, k, v, impl=impl, causal=False)

    def body(x, lp):
        return post(x, lp, attend(*pre(x, lp)))

    def selective(x, lp):
        q, k, v = checkpoint(pre, x, lp)
        return checkpoint(post, x, lp, attend(q, k, v))

    def layer(x, lp):
        return _apply(plan.remat, body, selective, x, lp)
    return layer


def cross_decoder_layer(cfg: ModelConfig, plan: ParallelPlan, dtype):
    """whisper's decoder layer: causal self-attention (norm1), cross-attention
    of the queries to the encoder output's keys and values (norm2; k and v
    from ``enc_out @ xattn.wk/wv``, non-causal), then the MLP (norm3). Both
    attention calls go through ``dispatch_attention``. ``plan.remat`` as in
    :func:`decoder_layer`; ``"selective"`` checkpoints the three pieces of glue
    around the two attention calls. ``enc_out`` is an input of the whole layer
    under ``"full"`` and of the middle piece under ``"selective"``, so its
    gradient flows back through every layer's ``xattn.wk/wv``."""
    impl = plan.attn_impl
    hq, hd = cfg.n_heads, cfg.head_dim

    def pre(x, lp):
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        return qkv_proj(lp["attn"], h, cfg, dtype)

    def mid(x, lp, enc_out, a):
        b, s = x.shape[:2]
        x = x + a.reshape(b, s, -1) @ lp["attn"]["wo"].to(dtype)
        h = rms_norm(x, lp["norm2"]["scale"], cfg.rms_eps)
        q = (h @ lp["xattn"]["wq"].to(dtype)).reshape(b, s, hq, hd)
        return (x, q, *cross_kv(cfg, lp, enc_out, dtype))

    def post(x, lp, a):
        x = x + a.reshape(x.shape[0], x.shape[1], -1) @ lp["xattn"]["wo"].to(dtype)
        h = rms_norm(x, lp["norm3"]["scale"], cfg.rms_eps)
        return x + mlp_block(lp["mlp"], h, dtype)

    def self_attend(q, k, v):
        return dispatch_attention(q, k, v, impl=impl, causal=True)

    def cross_attend(q, k, v):
        return dispatch_attention(q, k, v, impl=impl, causal=False)

    def body(x, lp, enc_out):
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
