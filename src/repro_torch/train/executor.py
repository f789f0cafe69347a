"""The decoder-layer, Mamba2-layer and encoder-decoder layer bodies, local
placement (port of ``repro/train/executor.py`` and of the layer bodies of
``repro/models/families.build_enc_dec``).

The reference's executor defines each family's math once and lets a
``ParallelContext`` place it (tp / cp rings, or local with identity
collectives). The port has the local placement only — the
``ctx.tp is None and ctx.cp is None`` branches of ``attn_block`` (with
``collect_kv``), and ``decoder_layer`` for the dense and MoE families — so the
context argument has no counterpart yet. The MLP is the plain ``mlp_block``
(the reference's ``mlp_block_ex`` adds only tp placement), and the MoE sublayer
is ``models.moe.moe_block`` (the local branch of the reference's
``moe_block_ex``). :func:`ssm_layer` is the reference's ``ssm_layer`` over the
local branch of ``ssm_block_ex`` (``models.ssm.ssm_block``). The tp / cp / ep
placements come with the distributed slices. :func:`encoder_layer` and
:func:`cross_decoder_layer` are whisper's encoder layer and its decoder layer
with cross-attention; the reference writes them inside ``build_enc_dec`` and
wraps each in ``_remat(body, plan.remat)``, as here.

The layer is written as three pieces around the attention call, so that
``remat="selective"`` can recompute the glue on either side and keep what the
attention kernels saved (``decoder_layer``, ``encoder_layer``); the Mamba2 layer
likewise around the SSD scan (``ssm_layer``), and the cross-attending decoder
layer as three pieces around its two attention calls.
"""

from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core.config import Family, ModelConfig, ParallelPlan
from repro_torch.ft.inject import remat_context
from repro_torch.kernels.dispatch import dispatch_attention, dispatch_ssd_scan
from repro_torch.models.layers import mlp_block, qkv_proj, rms_norm, rope
from repro_torch.models.moe import moe_block
from repro_torch.models.ssm import ssm_block, ssm_in_part, ssm_out_part


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


def ssm_layer(cfg: ModelConfig, plan: ParallelPlan, dtype):
    """The Mamba2 layer body: ``(x + ssm_block(norm1(x)), 0)``. ``window`` and
    ``positions`` are taken for the decoder layer's signature and not read.

    ``plan.remat`` (applied only while autograd records): ``"none"`` saves
    every intermediate; ``"full"`` checkpoints the whole layer, so the backward
    reruns it, the SSD forward kernel included; ``"selective"`` checkpoints the
    norm, projections and convs before the scan and the skip term, gated norm and
    out-projection after it separately, so what the scan saved for its backward
    (the reference's ``ssd_out`` and ``ssd_state``: y and the entering states)
    stays and the backward does not rerun the SSD forward.
    """
    remat = plan.remat

    def pre(x, lp):
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        return ssm_in_part(lp["ssm"], h, cfg, dtype)

    def post(x, y, xh, z, lp):
        return x + ssm_out_part(lp["ssm"], y, xh, z, cfg, dtype)

    def body(x, lp):
        h = rms_norm(x, lp["norm1"]["scale"], cfg.rms_eps)
        return x + ssm_block(lp["ssm"], h, cfg, dtype, plan=plan)

    def selective(x, lp):
        xh, dt, A, Bv, Cv, z = checkpoint(pre, x, lp)
        y, _ = dispatch_ssd_scan(xh, dt, A, Bv, Cv, chunk=cfg.ssm.chunk, impl=plan.ssm_impl)
        return checkpoint(post, x, y, xh, z, lp)

    def layer(x, lp, window=0, positions=None):
        del window, positions
        out = _apply(remat, body, selective, x, lp)
        return out, torch.zeros((), dtype=torch.float32, device=x.device)
    return layer


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
