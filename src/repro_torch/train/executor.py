"""The decoder-layer body, local placement (port of ``repro/train/executor.py``).

The reference's executor defines each family's math once and lets a
``ParallelContext`` place it (tp / cp rings, or local with identity
collectives). This slice ports the local placement only — the
``ctx.tp is None and ctx.cp is None`` branches of ``attn_block`` (with
``collect_kv``) and the dense branch of ``decoder_layer`` — so the context
argument has no counterpart yet, and the MLP is the plain ``mlp_block`` (the
reference's ``mlp_block_ex`` adds only tp placement). The tp / cp / ep placements
come with the distributed slices.
"""

from __future__ import annotations

import torch

from repro_torch.core.config import Family, ModelConfig, ParallelPlan
from repro_torch.kernels.dispatch import dispatch_attention
from repro_torch.models.layers import mlp_block, qkv_proj, rms_norm, rope


def attn_block(lp, x, cfg: ModelConfig, *, positions, window=0,
               dtype=torch.bfloat16, impl="auto", collect_kv=False):
    """Attention sub-block: qkv projection, rope, dispatcher attention, output
    GEMM. With ``collect_kv`` also returns the post-rope (k, v) for the cache."""
    q, k, v = qkv_proj(lp, x, cfg, dtype)
    if cfg.pos_emb == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    a = dispatch_attention(q, k, v, impl=impl, causal=True, window=window,
                           softcap=cfg.attn_logit_softcap)
    out = a.reshape(a.shape[0], a.shape[1], -1) @ lp["wo"].to(dtype)
    if collect_kv:
        return out, (k, v)
    return out


def decoder_layer(cfg: ModelConfig, plan: ParallelPlan, dtype,
                  collect_kv: bool = False):
    """The decoder-layer body (dense). ``window`` is the layer's int window."""
    if cfg.family == Family.MOE:
        raise NotImplementedError(
            "MoE decoder layers come with the port's MoE slice "
            "(models/moe.py and the grouped-GEMM kernel)")
    alternating = bool(cfg.local_global_alternating and cfg.sliding_window)
    impl = plan.attn_impl if plan is not None else "auto"

    def layer(x, lp, window, positions):
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        a = attn_block(lp["attn"], h, cfg, positions=positions,
                       window=window if alternating else cfg.sliding_window,
                       dtype=dtype, impl=impl, collect_kv=collect_kv)
        if collect_kv:
            a, kv = a
        if cfg.post_norm:
            a = rms_norm(a, lp["norm1_post"]["scale"], cfg.rms_eps)
        x = x + a
        h = rms_norm(x, lp["norm2"]["scale"], cfg.rms_eps)
        m = mlp_block(lp["mlp"], h, dtype)
        if cfg.post_norm:
            m = rms_norm(m, lp["norm2_post"]["scale"], cfg.rms_eps)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if collect_kv:
            return x + m, aux, kv
        return x + m, aux
    return layer
