"""The decoder-layer body, local placement (port of ``repro/train/executor.py``).

The reference's executor defines each family's math once and lets a
``ParallelContext`` place it (tp / cp rings, or local with identity
collectives). The port has the local placement only — the
``ctx.tp is None and ctx.cp is None`` branches of ``attn_block`` (with
``collect_kv``), and ``decoder_layer`` for the dense and MoE families — so the
context argument has no counterpart yet. The MLP is the plain ``mlp_block``
(the reference's ``mlp_block_ex`` adds only tp placement), and the MoE sublayer
is ``models.moe.moe_block`` (the local branch of the reference's
``moe_block_ex``). The tp / cp / ep placements come with the distributed slices.

The layer is written as three pieces around the attention call, so that
``remat="selective"`` can recompute the glue on either side and keep what the
attention kernels saved (``decoder_layer``).
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.config import Family, ModelConfig, ParallelPlan
from repro_torch.kernels.dispatch import dispatch_attention
from repro_torch.models.layers import mlp_block, qkv_proj, rms_norm, rope
from repro_torch.models.moe import moe_block


def decoder_layer(cfg: ModelConfig, plan: ParallelPlan, dtype,
                  collect_kv: bool = False):
    """The decoder-layer body (dense or MoE). ``window`` is the layer's int
    window. The layer returns ``(x, aux)``: the MoE sublayer's load-balancing
    loss, or a zero for dense layers (and the layer's (k, v) with
    ``collect_kv``).

    ``plan.remat`` (applied only while autograd records):
    ``"none"`` saves every intermediate; ``"full"`` checkpoints the whole layer,
    so the backward reruns it, the flash forward and the expert GEMMs included;
    ``"selective"`` checkpoints the glue before the attention call (norm,
    projections, rotary) and after it (output projection, MLP or MoE)
    separately, so the attention's own saved tensors (q, k, v, o, lse) stay and
    the backward does not rerun the flash forward. The reference saves only
    (o, lse) and the expert GEMMs' outputs there and recomputes the rest with
    the glue; the numbers are the same either way.
    """
    moe = cfg.family == Family.MOE
    alternating = bool(cfg.local_global_alternating and cfg.sliding_window)
    impl, remat = plan.attn_impl, plan.remat

    def pre(x, lp, positions):
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        q, k, v = qkv_proj(lp["attn"], h, cfg, dtype)
        if cfg.pos_emb == "rope":
            q = rope(q, positions, cfg.rope_theta)
            k = rope(k, positions, cfg.rope_theta)
        return q, k, v

    def post(x, a, lp):
        a = a.reshape(a.shape[0], a.shape[1], -1) @ lp["attn"]["wo"].to(dtype)
        if cfg.post_norm:
            a = rms_norm(a, lp["norm1_post"]["scale"], cfg.rms_eps)
        x = x + a
        h = rms_norm(x, lp["norm2"]["scale"], cfg.rms_eps)
        if moe:
            m, aux = moe_block(lp["moe"], h, cfg, dtype, plan)
        else:
            m = mlp_block(lp["mlp"], h, dtype)
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

    def layer(x, lp, window, positions):
        if not torch.is_grad_enabled() or remat == "none":
            out, aux, kv = body(x, lp, window, positions)
        elif remat == "full":
            out, aux, kv = checkpoint(body, x, lp, window, positions, use_reentrant=False)
        elif remat == "selective":
            q, k, v = checkpoint(pre, x, lp, positions, use_reentrant=False)
            out, aux = checkpoint(post, x, attend(q, k, v, window), lp, use_reentrant=False)
            kv = (k, v)
        else:
            raise ValueError(f"unknown remat mode {remat!r}")
        if collect_kv:
            return out, aux, kv
        return out, aux
    return layer
