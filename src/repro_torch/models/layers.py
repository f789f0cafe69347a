"""Shared transformer building blocks, in PyTorch (port of ``repro/models/layers.py``).

Parameters are nested dicts of tensors with the reference's leaf names (``wq``,
``wo``, ``gate``, ``down``, ...) and its ``x @ w`` (in, out) orientation.

Attention comes in the reference's exact implementations:

- :func:`attention_direct` / :func:`attention_direct_lse` — materialise the
  score matrix; fine for short sequences.
- :func:`attention_blockwise` — online-softmax loop over KV blocks; O(S·block)
  live memory.
- ``repro_torch.kernels.flash_attention`` — the hand-written CUDA kernels.

:func:`attention_chunk_grads` is the plain twin of the backward kernels: one KV
chunk's (dq, dk, dv) against given softmax statistics.

:func:`attention` routes between them via ``repro_torch.kernels.dispatch``
(``ParallelPlan.attn_impl``). All support GQA (grouped queries, never
materialising repeated KV), causal and sliding-window masks, attention-logit
softcap, and a query position offset. Windows are Python ints here: the port
runs layers as a Python loop, so gemma2's per-layer window is never traced.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# init helpers

def dense_init(gen: torch.Generator, shape, in_axis=-2):
    """Truncated normal on [-2, 2] over sqrt(fan_in), fp32, drawn from ``gen``
    on its device (inverse-CDF sampling, so the draw depends only on the
    generator)."""
    fan_in = shape[in_axis]
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    u = torch.rand(shape, generator=gen, dtype=torch.float32, device=gen.device)
    x = math.sqrt(2.0) * torch.erfinv(2.0 * (lo + u * (1.0 - 2.0 * lo)) - 1.0)
    return x.clamp_(-2.0, 2.0) / math.sqrt(fan_in)


# ---------------------------------------------------------------------------
# norms / embeddings

def rms_norm(x, scale, eps=1e-5):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


def sinusoidal_pos_emb(positions, dim, max_timescale=10_000.0):
    """(..., ) int positions -> (..., dim) sinusoidal embeddings (whisper-style)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_timescale)
                      * torch.arange(half, dtype=torch.float32, device=positions.device)
                      / (half - 1))
    args = positions[..., None].float() * freqs
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def rope(x, positions, theta=10_000.0):
    """Rotary embedding, half-split. x: (..., S, H, hd); positions: (..., S)."""
    hd = x.shape[-1]
    half = hd // 2
    # a Python-float base: no host-to-device copy (which would sync the stream)
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions[..., None].float() * freqs          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                   # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def pad_seq(x, axis: int, target: int):
    """Zero-pad ``x`` along ``axis`` up to length ``target``."""
    if x.shape[axis] == target:
        return x
    pads = [0, 0] * (x.dim() - 1 - axis) + [0, target - x.shape[axis]]
    return F.pad(x, pads)


# ---------------------------------------------------------------------------
# masking

def attn_mask(q_pos, k_pos, *, causal: bool, window: int):
    """Boolean mask (True = attend). q_pos: (S,), k_pos: (T,)."""
    i = q_pos[:, None]
    j = k_pos[None, :]
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= j <= i
    if window > 0:
        m &= (i - j) < window
    return m


def _softcap(s, cap):
    if cap == 0.0:
        return s
    return cap * torch.tanh(s / cap)


# ---------------------------------------------------------------------------
# attention

def _group_q(q, n_kv):
    """(B, S, Hq, hd) -> (B, S, Hkv, G, hd)."""
    b, s, hq, hd = q.shape
    return q.reshape(b, s, n_kv, hq // n_kv, hd)


def _scores(q, k, scale, softcap):
    """fp32 (B, Hkv, G, S, T) scores of batch-major q/k, scaled and capped."""
    qg = _group_q(q, k.shape[2])
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float()) * scale
    return _softcap(s, softcap)


def attention_direct(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0,
                     scale: Optional[float] = None):
    """q: (B,S,Hq,hd), k/v: (B,T,Hkv,hd) -> (B,S,Hq,hd). Materialises scores."""
    b, s, hq, hd = q.shape
    t = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    scores = _scores(q, k, scale, softcap)
    q_pos = q_offset + torch.arange(s, device=q.device)
    mask = attn_mask(q_pos, torch.arange(t, device=q.device), causal=causal,
                     window=window)
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)
    return out.reshape(b, s, hq, hd)


def attention_direct_lse(q, k, v, *, causal=True, window=0, softcap=0.0,
                         q_offset=0, scale: Optional[float] = None):
    """:func:`attention_direct` twin that also returns the per-row logsumexp.

    Returns (out (B,S,Hq,hd), lse (B,S,Hq) fp32). Fully-masked rows report a
    finite ``lse ≈ NEG_INF`` so they drop out of a cross-chunk merge.
    """
    b, s, hq, hd = q.shape
    t = k.shape[1]
    scale = scale if scale is not None else hd ** -0.5
    scores = _scores(q, k, scale, softcap)
    q_pos = q_offset + torch.arange(s, device=q.device)
    mask = attn_mask(q_pos, torch.arange(t, device=q.device), causal=causal,
                     window=window)
    scores = torch.where(mask, scores, NEG_INF)
    m = scores.amax(dim=-1)                                  # (b, kv, g, s)
    p = torch.exp(scores - m[..., None]) * mask
    l = torch.clamp(p.sum(dim=-1), min=1e-30)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(v.dtype).float(), v.float())
    out = out / l.permute(0, 3, 1, 2)[..., None]
    lse = m + torch.log(l)
    return (out.reshape(b, s, hq, hd).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(b, s, hq))


def attention_chunk_grads(q, k, v, do, lse, delta, *, causal=True, window=0,
                          softcap=0.0, q_offset=0,
                          scale: Optional[float] = None):
    """One KV chunk's (dq, dk, dv) against externally merged softmax stats.

    Plain twin of the backward kernels (``flash_attention_bwd``): ``lse`` and
    ``delta`` (B, S, Hq) may come from a softmax over more keys than (k, v),
    so ``p = exp(s - lse)`` is each pair's share of the whole attention and the
    gradients are this chunk's contribution. q/do (B, S, Hq, hd), k/v
    (B, T, Hkv, hd). All math fp32; outputs in the inputs' dtypes.
    """
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else hd ** -0.5
    g = hq // hkv
    qg = _group_q(q, hkv).float()
    kf, vf = k.float(), v.float()
    dog = _group_q(do, hkv).float()
    s_raw = torch.einsum("bskgd,btkd->bkgst", qg, kf) * scale
    th = torch.tanh(s_raw / softcap) if softcap else None
    s_c = softcap * th if softcap else s_raw
    mask = attn_mask(q_offset + torch.arange(s, device=q.device),
                     torch.arange(t, device=q.device), causal=causal, window=window)
    lse_g = lse.float().reshape(b, s, hkv, g).permute(0, 2, 3, 1)   # (b, kv, g, s)
    delta_g = delta.float().reshape(b, s, hkv, g).permute(0, 2, 3, 1)
    # where() before exp: fully masked rows carry lse ~ NEG_INF, and
    # exp(s - lse) would overflow before the mask could zero it
    p = torch.exp(torch.where(mask, s_c - lse_g[..., None], NEG_INF))
    dp = torch.einsum("bskgd,btkd->bkgst", dog, vf)
    ds = p * (dp - delta_g[..., None])
    if th is not None:
        ds = ds * (1.0 - th * th)
    dq = (torch.einsum("bkgst,btkd->bskgd", ds, kf) * scale).reshape(b, s, hq, hd)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_blockwise(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0,
                        block_size=1024, scale: Optional[float] = None,
                        kv_len: Optional[int] = None, return_lse: bool = False):
    """Online-softmax loop over KV blocks; exact, O(S·block) live memory.

    ``kv_len`` masks keys at positions >= kv_len — callers pad unaligned KV to
    the block boundary (see repro_torch.kernels.dispatch) and pass the true
    length. ``return_lse`` additionally returns the per-row logsumexp (B, S, Hq).
    """
    b, s, hq, hd = q.shape
    t, hkv = k.shape[1], k.shape[2]
    if t % block_size:
        raise ValueError(f"kv length {t} is not a multiple of block {block_size}")
    scale = scale if scale is not None else hd ** -0.5
    g = hq // hkv
    q_pos = q_offset + torch.arange(s, device=q.device)

    m = torch.full((b, hkv, g, s), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, g, s), dtype=torch.float32, device=q.device)
    o = torch.zeros((b, hkv, g, s, hd), dtype=torch.float32, device=q.device)
    for start in range(0, t, block_size):
        k_blk = k[:, start:start + block_size]
        v_blk = v[:, start:start + block_size]
        scores = _scores(q, k_blk, scale, softcap)
        k_pos = start + torch.arange(block_size, device=q.device)
        mask = attn_mask(q_pos, k_pos, causal=causal, window=window)
        if kv_len is not None and kv_len < t:
            mask &= (k_pos < kv_len)[None, :]
        scores = torch.where(mask, scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None]) * mask
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgst,btkd->bkgsd", p.to(v_blk.dtype).float(),
                          v_blk.float())
        o = o * corr[..., None] + pv
        m = m_new
    out = o / torch.clamp(l[..., None], min=1e-30)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd).to(q.dtype)
    if return_lse:
        lse = m + torch.log(torch.clamp(l, min=1e-30))
        return out, lse.permute(0, 3, 1, 2).reshape(b, s, hq)
    return out


def attention(q, k, v, *, causal=True, window=0, softcap=0.0, q_offset=0,
              block_size=1024, scale: Optional[float] = None,
              impl: str = "auto"):
    """Dispatch to the implementation for this call site.

    ``impl`` follows ``ParallelPlan.attn_impl`` ("auto" | "plain" | "cuda");
    the rules live in :mod:`repro_torch.kernels.dispatch`.
    """
    # lazy import: kernels.ref imports this module at load time
    from repro_torch.kernels.dispatch import dispatch_attention  # noqa: PLC0415
    return dispatch_attention(q, k, v, impl=impl, causal=causal, window=window,
                              softcap=softcap, q_offset=q_offset,
                              block_size=block_size, scale=scale)


# ---------------------------------------------------------------------------
# attention block (projections + rope + attention)

def init_attn(gen, cfg, d_model=None):
    d = d_model or cfg.d_model
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    p = {
        "wq": dense_init(gen, (d, hq * hd)),
        "wk": dense_init(gen, (d, hkv * hd)),
        "wv": dense_init(gen, (d, hkv * hd)),
        "wo": dense_init(gen, (hq * hd, d)),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((width,), dtype=torch.float32, device=gen.device)
    return p


# The reference keeps fp32 masters and casts them at every use; the port may
# hold the matrices once in the compute dtype (casting then multiplying gives the
# same bits), so each ``.to(dtype)`` below is a no-op on such parameters.

def qkv_proj(p, x, cfg, dtype):
    b, s, _ = x.shape
    hd, hq, hkv = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q = x @ p["wq"].to(dtype)
    k = x @ p["wk"].to(dtype)
    v = x @ p["wv"].to(dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return (q.reshape(b, s, hq, hd), k.reshape(b, s, hkv, hd),
            v.reshape(b, s, hkv, hd))


def attn_block(p, x, cfg, *, positions, window=0, causal=True, dtype=torch.bfloat16,
               use_rope=True, impl="auto"):
    """Full attention sub-block: qkv proj + rope + attention + output proj."""
    q, k, v = qkv_proj(p, x, cfg, dtype)
    if use_rope:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, causal=causal, window=window,
                    softcap=cfg.attn_logit_softcap, impl=impl)
    b, s = x.shape[:2]
    return out.reshape(b, s, -1) @ p["wo"].to(dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU)

def init_mlp(gen, d_model, d_ff):
    return {
        "gate": dense_init(gen, (d_model, d_ff)),
        "up": dense_init(gen, (d_model, d_ff)),
        "down": dense_init(gen, (d_ff, d_model)),
    }


def mlp_block(p, x, dtype=torch.bfloat16):
    h = F.silu(x @ p["gate"].to(dtype)) * (x @ p["up"].to(dtype))
    return h @ p["down"].to(dtype)
